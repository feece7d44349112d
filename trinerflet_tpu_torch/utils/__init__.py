"""Utilities of the port (``lpips.py``: the LPIPS perceptual distance)."""
