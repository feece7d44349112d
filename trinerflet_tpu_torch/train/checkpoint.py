"""The checkpoint file, shared with the JAX package.

A checkpoint is the JAX package's payload (``trinerflet_tpu/train/
trainer.py:853-870``): a pickle of a dict with ``params``, ``ema_params``
(trees of numpy arrays), ``ema_count``, ``step``, ``density_grid``,
``mean_density`` and, when full, ``opt_state``: the optax chain's state, a
tuple of ``ScaleByAdamState(count, mu, nu)``, with weight decay
``MaskedState(inner_state=EmptyState())``, and
``ScaleByScheduleState(count)``. A file written by either package loads in
the other.

This package imports no optax, so the chain's states are stand-ins of the
same fields:

* ``load`` unpickles with a ``find_class`` that maps optax's class names to
  the stand-ins, takes the few numpy globals that rebuild arrays, scalars
  and dtypes, and refuses any other global (a checkpoint holds nothing
  else; unpickling another global, numpy's included, could run code).
* ``save`` writes each stand-in as the optax class it stands for, by module
  and name, so the JAX package's ``pickle.load`` rebuilds real optax
  states. The pure-Python pickler's dispatch table does this without
  importing optax (the C pickler would import the module to check the
  name).
"""

from __future__ import annotations

import collections
import pickle
from typing import Dict, Tuple

import numpy as np

__all__ = ["ScaleByAdamState", "ScaleByScheduleState", "EmptyState", "MaskedState",
           "optax_chain_state", "save", "load"]

ScaleByAdamState = collections.namedtuple("ScaleByAdamState", "count mu nu")
ScaleByScheduleState = collections.namedtuple("ScaleByScheduleState", "count")
EmptyState = collections.namedtuple("EmptyState", "")
MaskedState = collections.namedtuple("MaskedState", "inner_state")

# stand-in -> the (module, name) this package writes (optax 0.2's)
_WRITE = {
    ScaleByAdamState: ("optax._src.transform", "ScaleByAdamState"),
    ScaleByScheduleState: ("optax._src.transform", "ScaleByScheduleState"),
    EmptyState: ("optax._src.base", "EmptyState"),
    MaskedState: ("optax.transforms._masking", "MaskedState"),
}
# (module, name) a checkpoint may name -> stand-in
_READ = {v: k for k, v in _WRITE.items()}
# the numpy globals that an array, a numpy scalar or a dtype pickles as
# (protocols 3-5; numpy 2's ``numpy._core`` and numpy 1's ``numpy.core``)
_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype")} | {
    (f"{core}.{module}", name) for core in ("numpy._core", "numpy.core")
    for module, name in (("multiarray", "_reconstruct"), ("multiarray", "scalar"),
                         ("numeric", "_frombuffer"))}


def optax_chain_state(opt_state: Dict, weight_decay: bool) -> Tuple:
    """The trainer's Adam state ({"count", "mu", "nu"}, numpy trees) as the
    JAX trainer's optax chain state: Adam, the masked weight decay when
    ``weight_decay``, the schedule. Both counts are the update count."""
    count = np.asarray(opt_state["count"], np.int32)
    chain = [ScaleByAdamState(count, opt_state["mu"], opt_state["nu"])]
    if weight_decay:
        chain.append(MaskedState(EmptyState()))
    chain.append(ScaleByScheduleState(count.copy()))
    return tuple(chain)


def _save_stand_in(pickler, obj) -> None:
    """``copyreg.__newobj__``'s opcodes for ``obj`` under optax's name
    (protocol 4 and later)."""
    module, name = _WRITE[type(obj)]
    pickler.save(module)
    pickler.save(name)
    pickler.write(pickle.STACK_GLOBAL)
    pickler.save(tuple(obj))
    pickler.write(pickle.NEWOBJ)
    pickler.memoize(obj)


class _Pickler(pickle._Pickler):
    dispatch = dict(pickle._Pickler.dispatch)
    dispatch.update({cls: _save_stand_in for cls in _WRITE})


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _READ:
            return _READ[(module, name)]
        if (module, name) in _NUMPY:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"a checkpoint holds numpy arrays and optax states; this file names {module}.{name}")


def save(path: str, payload: Dict) -> None:
    with open(path, "wb") as f:
        _Pickler(f, protocol=pickle.DEFAULT_PROTOCOL).dump(payload)


def load(path: str) -> Dict:
    with open(path, "rb") as f:
        return _Unpickler(f).load()
