"""Quality metrics (port of ``trinerflet_tpu/train/metrics.py``): PSNR and SSIM
and their meters (``update(pred, truth)`` per image, ``measure()`` for the
running mean, ``report2()`` for a dict).

SSIM is the 11 x 11, sigma 1.5 Gaussian-window structural similarity over
the window's "valid" positions, per channel, then averaged -- the JAX
package's scipy path -- computed as a float64 ``conv2d`` on the images'
device (the window is symmetric, so correlation equals convolution). Both
metrics take tensors or numpy arrays (H, W, C) in [0, 1] and return floats.
The LPIPS meter waits for the LPIPS network's port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["PSNRMeter", "SSIMMeter", "LPIPSMeter", "psnr", "ssim"]


def _f64(x, device=None) -> torch.Tensor:
    t = x.detach() if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return t.to(device if device is not None else t.device, torch.float64)


def psnr(pred, truth) -> float:
    x = _f64(pred)
    mse = float(((x - _f64(truth, x.device)) ** 2).mean())
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    r = np.arange(size) - size // 2
    g = np.exp(-(r**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return k / k.sum()


def ssim(pred, truth, data_range: float = 1.0) -> float:
    """Mean SSIM over channels of (H, W, C) images."""
    x = _f64(pred)
    y = _f64(truth, x.device)
    k = torch.from_numpy(_gaussian_kernel()).to(x.device)[None, None]
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    x, y = x.permute(2, 0, 1)[:, None], y.permute(2, 0, 1)[:, None]  # (C, 1, H, W)

    def blur(z):
        return F.conv2d(z, k)  # valid positions only

    mx, my = blur(x), blur(y)
    vx, vy, cov = blur(x * x) - mx * mx, blur(y * y) - my * my, blur(x * y) - mx * my
    s = ((2 * mx * my + c1) * (2 * cov + c2)) / ((mx**2 + my**2 + c1) * (vx + vy + c2))
    return float(s.mean(dim=(1, 2, 3)).mean())


class _MeanMeter:
    name = "metric"

    def __init__(self):
        self.V = 0.0
        self.N = 0

    def clear(self):
        self.V, self.N = 0.0, 0

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def report(self) -> str:
        return f"{self.name} = {self.measure():.6f}"

    def report2(self):
        return {self.name: self.measure()}


class PSNRMeter(_MeanMeter):
    name = "PSNR"

    def update(self, preds, truths):
        self.V += psnr(preds, truths)
        self.N += 1


class SSIMMeter(_MeanMeter):
    name = "SSIM"

    def update(self, preds, truths):
        """One image (H, W, C) or a batch (B, H, W, C): one entry per image."""
        if len(preds.shape) == 4:
            for p, t in zip(preds, truths):
                self.V += ssim(p, t)
                self.N += 1
        else:
            self.V += ssim(preds, truths)
            self.N += 1


class LPIPSMeter(_MeanMeter):
    """LPIPS meter: ``fn(pred, truth) -> float`` from ``utils.lpips.
    make_lpips_fn``. No weights are in the repository; without ``fn`` the
    meter takes nothing and reports NaN."""

    name = "LPIPS"

    def __init__(self, fn=None):
        super().__init__()
        self.fn = fn

    @classmethod
    def from_weights(cls, backbone_path: str, lin_path: str, net: str = "vgg", device=None):
        from ..utils.lpips import make_lpips_fn

        return cls(fn=make_lpips_fn(backbone_path, lin_path, net=net, device=device))

    @classmethod
    def from_params(cls, params, net: str = "vgg"):
        from ..utils.lpips import make_lpips_fn

        return cls(fn=make_lpips_fn(params=params, net=net))

    @property
    def available(self) -> bool:
        return self.fn is not None

    def update(self, preds, truths):
        if self.fn is None:
            return
        self.V += float(self.fn(preds, truths))
        self.N += 1

    def measure(self) -> float:
        return float("nan") if self.N == 0 else self.V / self.N
