"""NeRF super-resolution (port of ``trinerflet_tpu/sr/``).

Fit a wavelet triplane on low-res views, then use the fact that the same
wavelet parameters decode to a higher-resolution triplane ("double
resolution mode") and refine high-res renders with a diffusion x4 upscaler
into cached pseudo-ground-truth images, re-fit with L1 / L2 and LR
consistency losses. ``python -m trinerflet_tpu_torch.sr.launch --config ...``
runs it from a YAML recipe (``configs/triplane-sr*.yaml``).
"""
