"""A (data, model) process grid over ``torch.distributed`` (port of
``trinerflet_tpu/parallel/sharding.py``).

The JAX package lays its devices out as a 2-axis ``jax.sharding.Mesh`` and
lets XLA insert the collectives. Here every process is one grid point and
the collectives are explicit:

* ``data`` axis: each rank renders a contiguous shard of the global ray
  batch. The plane gradient of its K2 backward is averaged over the data
  group in float32 before it is rounded to the plane dtype (the JAX
  package's per-shard scatter and psum, ``ops/scatter.py _sharded_scatter``),
  and so is each MLP weight's gradient; the other gradients are averaged
  after the backward.
* ``model`` axis: the triplane's channels are split. The IDWT ladder (K4)
  is depthwise, so each rank builds and samples (K2) only its channels; the
  first sigma layer contracts them with its rows of ``w0`` and sums the
  partial products over the model group (``model_sum``) before anything is
  rounded. The layers after it are replicated.

Rank r sits at (r // M, r % M), as ``jax.make_mesh`` reshapes its devices.
The caller initialises the default group (``torchrun``'s environment or
``parallel.launch``) with the backend of its choice: ``nccl`` on CUDA,
``gloo`` on the CPU. Nothing swaps one for the other. Where gloo refuses a
collective on CUDA tensors, ``make_mesh`` finds it out once and that
collective stages through host memory (``Mesh.staged``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "param_shardings", "state_shardings", "shard_params",
           "shard_state", "gather_params", "gather_state", "model_sum", "check_channels",
           "DATA_AXIS", "MODEL_AXIS", "active_mesh", "current_data_mesh"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SHARDED = (None, MODEL_AXIS)  # a leaf split on dim 1 over the model group
REPLICATED = ()
# the channel counts K2 has instantiations for (kernels/csrc/grid_sample.cu)
K2_CHANNELS = (4, 8, 16, 32)

_ACTIVE_MESH: Optional["Mesh"] = None


@contextlib.contextmanager
def active_mesh(mesh: Optional["Mesh"]):
    """Scope ``mesh`` as the ambient mesh (the trainer's step runs inside)."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield
    finally:
        _ACTIVE_MESH = prev


def current_data_mesh() -> Optional["Mesh"]:
    """The ambient mesh, if it has a non-trivial data axis."""
    m = _ACTIVE_MESH
    if m is not None and m.shape[DATA_AXIS] > 1:
        return m
    return None


@dataclasses.dataclass
class Mesh:
    """One rank's view of the grid: its coordinates, the data group (the
    ranks of its model index) and the model group (the ranks of its data
    index), the backend, the device its collectives take tensors on, the
    collectives staged through host memory, and how many of each ran."""

    data: int
    model: int
    rank: int
    data_group: object
    model_group: object
    backend: str
    device: torch.device
    staged: Tuple[str, ...] = ()
    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"all_reduce": 0, "all_gather": 0})

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def _group(self, axis: str):
        return self.data_group if axis == DATA_AXIS else self.model_group

    def _comm(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` as the backend takes it: CUDA tensors for nccl; for gloo
        the tensor's own device, or the host where ``op`` is staged."""
        if self.backend == "nccl":
            return t.to(self.device)
        if t.is_cuda and op in self.staged:
            return t.cpu()
        return t

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The float32 sum of ``t`` over the axis' group, as a new tensor on
        ``t``'s device (``t`` is left as it was)."""
        buf = self._comm(t.detach().float(), "all_reduce").clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self._group(axis))
        self.counts["all_reduce"] += 1
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` of the axis' group, concatenated along ``dim``
        in rank order (the data group's order is the global batch's)."""
        n = self.shape[axis]
        src = self._comm(t.detach().contiguous(), "all_gather")
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self._group(axis))
        self.counts["all_gather"] += 1
        return torch.cat(parts, dim=dim).to(t.device)


def _probe_staged(backend: str, device: torch.device) -> Tuple[str, ...]:
    """The collectives gloo refuses on CUDA tensors (found out once, on a
    one-element tensor, the same way on every rank)."""
    if backend != "gloo" or device.type != "cuda":
        return ()
    staged = []
    t = torch.ones((1,), device=device)
    try:
        dist.all_reduce(t.clone())
    except RuntimeError:
        staged.append("all_reduce")
    try:
        dist.all_gather([torch.empty_like(t) for _ in range(dist.get_world_size())], t)
    except RuntimeError:
        staged.append("all_gather")
    return tuple(staged)


def check_channels(channels: int, model_parallel: int, device) -> None:
    """The channel split: C % M == 0, and on CUDA a shard width C / M that
    K2 has an instantiation for."""
    if model_parallel <= 1:
        return
    if channels % model_parallel:
        raise ValueError(f"the model axis splits the triplane's {channels} channels into "
                         f"{model_parallel} shards: C % M must be 0")
    if torch.device(device).type == "cuda" and channels // model_parallel not in K2_CHANNELS:
        raise ValueError(f"a shard of {channels // model_parallel} channels has no K2 "
                         f"instantiation (C / M in {K2_CHANNELS})")


def make_mesh(model_parallel: int = 1, group=None, channels: Optional[int] = None,
              device=None) -> Mesh:
    """Lay the initialised default group (or ``group``) out as (data,
    model) with ``model_parallel`` ranks on the model axis. Every rank
    calls it, in the same order. ``device`` is where this rank's tensors
    live (its CUDA device under nccl; the CPU under gloo unless given).
    ``channels`` checks the triplane's channel split now rather than at the
    first launch."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed group "
                           "(torchrun, or trinerflet_tpu_torch.parallel.launch)")
    ranks = list(range(dist.get_world_size())) if group is None else \
        dist.get_process_group_ranks(group)
    n, M = len(ranks), int(model_parallel)
    if M < 1 or n % M:
        raise ValueError(f"{n} ranks do not split into a model axis of {M}")
    backend = dist.get_backend(group)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    if channels is not None:
        check_channels(channels, M, device)
    me = ranks.index(dist.get_rank())
    D = n // M
    data_group = model_group = None
    # every rank creates every subgroup, in the same order
    for m in range(M):
        g = dist.new_group([ranks[d * M + m] for d in range(D)])
        if me % M == m:
            data_group = g
    for d in range(D):
        g = dist.new_group([ranks[d * M + m] for m in range(M)])
        if me // M == d:
            model_group = g
    return Mesh(data=D, model=M, rank=me, data_group=data_group, model_group=model_group,
                backend=backend, device=device, staged=_probe_staged(backend, device))


class RayGather:
    """A data rank's gather of per-ray rows over its group, in the global
    batch's order (``render_occgrid``'s ``ray_gather``); ``index`` is the
    rank's place in that order."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.index = mesh.data_index

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_gather(t, DATA_AXIS)


class _ModelSum(torch.autograd.Function):
    """All-reduce SUM over the model group forward, identity backward: every
    model rank holds the same cotangent of the sum, which is each partial's
    cotangent (``torch.distributed.nn``'s all_reduce would sum it again)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


def model_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The float32 sum of the model ranks' partial ``x`` (differentiable)."""
    return _ModelSum.apply(x, mesh)


# ----------------------------------------------------------------- layouts


def _spec(key: str, leaf: torch.Tensor, model_size: int):
    if key == "encoder" and model_size > 1 and leaf.dim() >= 2 and leaf.shape[1] % model_size == 0:
        return SHARDED
    return REPLICATED


def _map_specs(tree: Dict, fn, key: Optional[str] = None) -> Dict:
    out = {}
    for k, v in tree.items():
        top = k if key is None else key
        out[k] = _map_specs(v, fn, top) if isinstance(v, dict) else fn(top, v)
    return out


def param_shardings(mesh: Mesh, params: Dict) -> Dict:
    """The layout of each parameter leaf, as the JAX package's: the
    triplane's leaves (``base`` (3, C, h, w), ``wavelets`` and ``upscale``
    levels (3, C, 3, s, s)) split on dim 1 over the model group
    (``(None, "model")``) when C % M == 0; everything else replicated
    (``()``), the MLPs included (the first sigma layer's rows are read per
    channel shard)."""
    M = mesh.shape[MODEL_AXIS]
    return _map_specs(params, lambda key, leaf: _spec(key, leaf, M))


def state_shardings(mesh: Mesh, state):
    """The layout of a ``TrainState``: params, the Adam moments and the EMA
    mirror ``param_shardings``; the counts, the occupancy state, the step,
    the generator and the error map are replicated."""
    ps = param_shardings(mesh, state.params)
    return state._replace(params=ps, opt_state={"count": REPLICATED, "mu": ps, "nu": ps},
                          ema_params=ps, ema_count=REPLICATED, occ=REPLICATED, step=REPLICATED,
                          rng=REPLICATED, error_map=REPLICATED)


def _zip(fn, specs: Dict, tree: Dict) -> Dict:
    return {k: _zip(fn, specs[k], v) if isinstance(v, dict) else fn(specs[k], v)
            for k, v in tree.items()}


def _slice(mesh: Mesh, spec, t: torch.Tensor) -> torch.Tensor:
    if spec != SHARDED:
        return t
    w = t.shape[1] // mesh.model
    return t.detach()[:, mesh.model_index * w:(mesh.model_index + 1) * w].contiguous()


def shard_params(mesh: Mesh, params: Dict) -> Dict:
    """This rank's slice of full-width ``params`` (replicated leaves as
    they are; ``requires_grad`` is the caller's)."""
    return _zip(lambda s, t: _slice(mesh, s, t), param_shardings(mesh, params), params)


def _gather(mesh: Mesh, spec, t: torch.Tensor) -> torch.Tensor:
    if spec != SHARDED:
        return t.detach()
    return mesh.all_gather(t.detach(), MODEL_AXIS, dim=1)


def _shard_specs(mesh: Mesh, params: Dict) -> Dict:
    """The layout a shard tree came from: every triplane leaf of two or
    more dims was split (the trainer splits only when C % M == 0)."""
    M = mesh.shape[MODEL_AXIS]
    return _map_specs(params, lambda key, leaf: SHARDED if key == "encoder" and M > 1
                      and leaf.dim() >= 2 else REPLICATED)


def gather_params(mesh: Mesh, params: Dict) -> Dict:
    """Full-width params from every model rank's shard (every rank of the
    model group calls it)."""
    return _zip(lambda s, t: _gather(mesh, s, t), _shard_specs(mesh, params), params)


def shard_state(mesh: Mesh, state):
    """This rank's slice of a full-width ``TrainState``: params (requiring
    grad), Adam moments and EMA sliced, everything else as it was."""
    specs = param_shardings(mesh, state.params)
    cut = lambda tree: _zip(lambda s, t: _slice(mesh, s, t), specs, tree)  # noqa: E731
    params = _zip(lambda s, t: _slice(mesh, s, t).requires_grad_(True), specs, state.params)
    opt = dict(state.opt_state, mu=cut(state.opt_state["mu"]), nu=cut(state.opt_state["nu"]))
    return state._replace(params=params, opt_state=opt, ema_params=cut(state.ema_params))


def gather_state(mesh: Mesh, state):
    """The full-width ``TrainState`` from every model rank's shard (every
    rank of the model group calls it)."""
    g = lambda tree: gather_params(mesh, tree)  # noqa: E731
    opt = dict(state.opt_state, mu=g(state.opt_state["mu"]), nu=g(state.opt_state["nu"]))
    return state._replace(params=g(state.params), opt_state=opt, ema_params=g(state.ema_params))


def leaf_reductions(mesh: Mesh, names: List[str]) -> List[str]:
    """How each parameter gradient (dotted names, ``trainer._leaves``
    order) is reduced after the backward on a mesh: ``"none"``,
    ``"model"``, ``"data"`` or ``"model+data"``.

    * The triplane's leaves (``base``, ``wavelets``, ``upscale``): none.
      Each model rank owns its channels, and on a data axis of several
      ranks the sampler averaged the plane gradient in the backward.
    * The field's MLPs: on a data axis of several ranks the backward
      averaged each weight's gradient before rounding it; on one data rank
      the data all-reduce runs (on a group of one). ``sigma_net.w0`` on a
      split model axis also sums over the model group: each model rank
      fills the rows of its channels.
    * The learned rotation and lbound zoom: each rank's points carry its
      rays and channels, so model (when split) and data.
    * Everything else: data."""
    split, in_backward = mesh.model > 1, mesh.data > 1
    out = []
    for n in names:
        top, sub = (n.split(".") + [""])[:2]
        model = split and (n == "sigma_net.w0" or n in ("encoder.rotation", "encoder.lbound_scale"))
        if top == "encoder" and sub in ("base", "wavelets", "upscale"):
            data = False
        elif top in ("sigma_net", "color_net", "bg_net"):
            data = not in_backward
        else:
            data = True
        out.append("+".join(k for k, on in (("model", model), ("data", data)) if on) or "none")
    return out


def reduce_gradients(mesh: Mesh, names: List[str], grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients after the mesh's reductions (see ``leaf_reductions``):
    one model-group all-reduce of the leaves that sum over the model group,
    then one data-group all-reduce of those that average over the data
    group, divided by D. The data all-reduce runs even on a group of one,
    so a one-rank grid runs the collective its step needs."""
    kinds = leaf_reductions(mesh, names)
    out = list(grads)
    model_ids = [i for i, k in enumerate(kinds) if "model" in k]
    if model_ids:
        flat = mesh.all_reduce(torch.cat([grads[i].reshape(-1) for i in model_ids]), MODEL_AXIS)
        for i, part in zip(model_ids, _split(flat, [grads[i] for i in model_ids])):
            out[i] = part
    data_ids = [i for i, k in enumerate(kinds) if "data" in k]
    if data_ids:
        flat = mesh.all_reduce(torch.cat([out[i].reshape(-1) for i in data_ids]), DATA_AXIS)
        flat = flat / mesh.data
        for i, part in zip(data_ids, _split(flat, [grads[i] for i in data_ids])):
            out[i] = part.to(grads[i].dtype)
    return out


def _split(flat: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    parts, o = [], 0
    for t in like:
        parts.append(flat[o:o + t.numel()].reshape(t.shape))
        o += t.numel()
    return parts
