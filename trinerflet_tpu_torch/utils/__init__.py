"""Utilities of the port: ``lpips.py`` (the LPIPS perceptual distance),
``clip_loss.py`` (CLIP guidance), ``gui.py`` (the HTTP viewer),
``viewer.py`` (the orbit turntable), ``logging.py`` (the experiment
logger) and ``gan.py`` (the taming GAN stack)."""
