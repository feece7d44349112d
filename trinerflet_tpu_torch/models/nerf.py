"""NeRF field: position encoding + sigma / color MLPs (port of
``trinerflet_tpu/models/nerf.py``).

Parameters are the JAX package's dict: ``encoder`` (the triplane params, the
grid tables ``level_{l}`` of a "hashgrid" / "tiledgrid" field, the k-planes
tables ``scale_{i}``, or nothing for the table-free encodings),
``sigma_net`` / ``color_net`` and, with ``bg_radius > 0``, ``bg_net``, with
bias-free weights ``w{i}`` of shape (fan_in, fan_out). The MLPs are plain
matrix products outside any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..ops.activation import plain_exp, trunc_exp
from ..ops.encoders import sh_dim, sh_encode
from ..ops.raymarch import _inv
from .encodings import encoder_apply, encoder_dim, get_encoder
from .triplane import TriplaneConfig, build_planes, init_triplane_params, sample_triplane

__all__ = ["NeRFConfig", "init_nerf_params", "NeRFField"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    encoding: str = "triplane_wavelet"
    triplane: TriplaneConfig = dataclasses.field(default_factory=TriplaneConfig)
    grid: Optional[object] = None
    kplanes: Optional[object] = None
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    sh_degree: int = 4
    bound: float = 1.0
    density_scale: float = 1.0
    density_blob_scale: float = 0.0
    density_blob_std: float = 0.5
    bg_radius: float = -1.0
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    compute_dtype: str = "float32"
    plane_dtype: str = "float32"

    def validate(self) -> None:
        """Raise for an encoding name the JAX package does not define."""
        if self.encoding != "triplane_wavelet":
            encoder_dim(self.encoding, grid_cfg=self.grid, kplanes_cfg=self.kplanes)

    @property
    def in_dim(self) -> int:
        """The encoding's width, from the configuration (no table is made)."""
        self.validate()
        if self.encoding == "triplane_wavelet":
            return self.triplane.feature_dim
        return encoder_dim(self.encoding, grid_cfg=self.grid, kplanes_cfg=self.kplanes)

    @property
    def in_dim_dir(self) -> int:
        return sh_dim(self.sh_degree)


def _init_mlp(dims, generator) -> Dict[str, torch.Tensor]:
    """torch nn.Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    out = {}
    for i in range(len(dims) - 1):
        b = 1.0 / dims[i] ** 0.5
        u = torch.rand((dims[i], dims[i + 1]), generator=generator, dtype=torch.float32)
        out[f"w{i}"] = (2.0 * u - 1.0) * b
    return out


def init_nerf_params(cfg: NeRFConfig, generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> Dict:
    """Seeded random params on ``device`` (``cuda`` by default)."""
    cfg.validate()
    device = resolve_device(device)
    sigma_dims = [cfg.in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) + [1 + cfg.geo_feat_dim]
    color_dims = ([cfg.in_dim_dir + cfg.geo_feat_dim]
                  + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1) + [3])
    if cfg.encoding == "triplane_wavelet":
        enc = init_triplane_params(cfg.triplane, generator, device)
    else:
        enc = get_encoder(cfg.encoding, generator, device, grid_cfg=cfg.grid,
                          kplanes_cfg=cfg.kplanes, bound=cfg.bound)[0]
    nets = {"sigma_net": _init_mlp(sigma_dims, generator),
            "color_net": _init_mlp(color_dims, generator)}
    if cfg.bg_radius > 0:
        bg_dims = [cfg.in_dim_dir + 2] + [cfg.hidden_dim_bg] * (cfg.num_layers_bg - 1) + [3]
        nets["bg_net"] = _init_mlp(bg_dims, generator)
    return {"encoder": enc,
            **{k: {n: w.to(device) for n, w in v.items()} for k, v in nets.items()}}


class _RoundedWeight(torch.autograd.Function):
    """``w.to(dtype).float()`` whose float32 gradient is ``reduce``d (a
    data rank's mean over its group) before it is rounded to ``dtype``, as
    one process rounds the gradient of the whole batch once."""

    @staticmethod
    def forward(ctx, w, dtype, reduce):
        ctx.dtype, ctx.reduce, ctx.w_dtype = dtype, reduce, w.dtype
        return w.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return ctx.reduce(g).to(ctx.dtype).to(ctx.w_dtype), None, None


def _mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, dtype: torch.dtype,
         rows=None, reduce=None, grad_reduce=None) -> torch.Tensor:
    """Bias-free ReLU MLP with the JAX package's precision: inputs and weights
    rounded to ``dtype``, float32 accumulation, output of every layer rounded
    back to ``dtype``. The product runs in float32 on the rounded values,
    which is exactly a ``dtype`` x ``dtype`` -> f32 product.

    On a model rank ``rows(w0)`` picks the first layer's rows of its
    features and ``reduce`` sums the partial products over the model group,
    in float32, before the ReLU and the rounding (as XLA's psum). On a data
    rank ``grad_reduce`` averages each weight's float32 gradient over the
    data group before it is rounded (``_RoundedWeight``)."""
    n = len(params)
    h = x.to(dtype)
    for i in range(n):
        w = params[f"w{i}"]
        if i == 0 and rows is not None:
            w = rows(w)
        w = w.to(dtype).float() if grad_reduce is None else _RoundedWeight.apply(w, dtype, grad_reduce)
        h = torch.matmul(h.float(), w)
        if i == 0 and reduce is not None:
            h = reduce(h)
        if i != n - 1:
            h = torch.relu(h)
        h = h.to(dtype)
    return h


class NeRFField:
    """Stateless field; planes are built once and passed to every query.

    With a ``mesh`` (``parallel.sharding``) the triplane params and planes
    are this rank's channel shard: the density contracts its 3 C/M
    features with the rows ``p C + c`` of ``sigma_net.w0`` that belong to
    them and sums over the model group (``model_sum``); on a data axis of
    more than one rank the plane gradients and the MLP weights' gradients
    are averaged over the data group in float32 before they are rounded
    (``sample_points_reduced``, ``_RoundedWeight``)."""

    def __init__(self, cfg: NeRFConfig, mesh=None):
        cfg.validate()
        self.cfg = cfg
        self.mesh = mesh
        self._rows = self._reduce = self._grad_reduce = None
        if mesh is not None:
            self._shard(mesh)
        self.dtype = _DTYPES[cfg.compute_dtype]
        self.plane_dtype = _DTYPES[cfg.plane_dtype]
        self._enc_apply = None  # the triplane samples built planes instead
        if cfg.encoding != "triplane_wavelet":
            self._enc_apply = encoder_apply(cfg.encoding, grid_cfg=cfg.grid, kplanes_cfg=cfg.kplanes,
                                            bound=cfg.bound)

    def _shard(self, mesh) -> None:
        from ..parallel.sharding import DATA_AXIS, check_channels, model_sum

        if mesh.model > 1:
            if self.cfg.encoding != "triplane_wavelet":
                raise ValueError(f"the model axis splits the wavelet triplane's channels; the "
                                 f"{self.cfg.encoding!r} field has none (model_parallel=1)")
            C = self.cfg.triplane.channels
            check_channels(C, mesh.model, mesh.device)
            w, m = C // mesh.model, mesh.model_index

            def rows(w0):
                return w0.reshape(3, C, -1)[:, m * w:(m + 1) * w].reshape(3 * w, -1)

            self._rows = rows
            self._reduce = lambda h: model_sum(h, mesh)
        if mesh.data > 1:
            self._grad_reduce = lambda g: mesh.all_reduce(g, DATA_AXIS) / mesh.data

    def build_planes(self, params: Dict, max_resolution: int = -1,
                     modes: Optional[Tuple[str, ...]] = None) -> Dict[str, torch.Tensor]:
        """The triplane's planes (``full``, the SR snapshots and the zoom-in
        planes when configured; only ``modes`` and only as far as they need
        when given, see ``triplane.build_planes``); {} for the other
        encodings."""
        if self._enc_apply is not None:
            return {}
        enc = params["encoder"]
        if self.plane_dtype == torch.bfloat16:
            # the pyramid coefficients go to bf16 BEFORE the ladder, as in
            # the JAX package (the synthesis runs at bf16 with f32 sums); the
            # rotation and the lbound zoom stay f32
            enc = {k: (_cast(v, torch.bfloat16) if k in ("base", "wavelets", "upscale") else v)
                   for k, v in enc.items()}
        planes = build_planes(enc, self.cfg.triplane, max_resolution, modes)
        return {k: v.to(self.plane_dtype) for k, v in planes.items()}

    def _density_blob(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.density_blob_scale > 1e-5:
            h = h * (cfg.density_blob_scale
                     * plain_exp(-0.5 * (x * x).sum(-1) * _inv(cfg.density_blob_std**2)))
        return h

    def density(self, params: Dict, planes: Dict[str, torch.Tensor], x: torch.Tensor,
                resolution_mode: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
        """x (N, 3) in [-bound, bound] -> (sigma (N,) f32, geo_feat (N, G)),
        the triplane sampled on ``planes[resolution_mode]``."""
        if self._enc_apply is not None:
            feats = self._enc_apply(params["encoder"], x)
        else:
            feats = sample_triplane(planes, x, self.cfg.triplane, lbound=self.cfg.bound,
                                    resolution_mode=resolution_mode, enc_params=params["encoder"],
                                    grad_reduce=self._grad_reduce)
        h = _mlp(params["sigma_net"], feats, self.dtype, self._rows, self._reduce, self._grad_reduce)
        sigma = trunc_exp(self._density_blob(x, h[..., 0]))
        return sigma, h[..., 1:]

    def color(self, params: Dict, d: torch.Tensor, geo_feat: torch.Tensor) -> torch.Tensor:
        """d (N, 3) directions -> rgb (N, 3) in [0, 1], f32."""
        sh = sh_encode(d, self.cfg.sh_degree)
        h = torch.cat([sh.to(self.dtype), geo_feat.to(self.dtype)], dim=-1)
        h = _mlp(params["color_net"], h, self.dtype, grad_reduce=self._grad_reduce)
        return torch.sigmoid(h.float())

    def __call__(self, params: Dict, planes: Dict[str, torch.Tensor], x: torch.Tensor,
                 d: torch.Tensor, resolution_mode: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
        sigma, geo = self.density(params, planes, x, resolution_mode)
        return sigma, self.color(params, d, geo)

    def background(self, params: Dict, sph: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """The background network (``bg_radius > 0``): sph (N, 2) sphere
        coordinates in [-1, 1] (``ops.raymarch.sph_from_ray``) and d (N, 3)
        directions -> rgb (N, 3) in [0, 1], f32."""
        h = torch.cat([sh_encode(d, self.cfg.sh_degree), sph], dim=-1)
        return torch.sigmoid(_mlp(params["bg_net"], h, self.dtype, grad_reduce=self._grad_reduce).float())


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)
