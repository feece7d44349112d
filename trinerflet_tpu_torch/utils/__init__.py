"""Utilities of the port: ``lpips.py`` (the LPIPS perceptual distance),
``clip_loss.py`` (CLIP guidance), ``gui.py`` (the HTTP viewer),
``viewer.py`` (the orbit turntable) and ``logging.py`` (the experiment
logger)."""
