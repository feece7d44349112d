"""One training step's gradients at SH degree 4 and 8: the JAX package's
loss under ``jax.jit`` and eagerly, each against the PyTorch port's plain
versions (CPU), on ``tests/test_torch_variants_train.py``'s BENCH_SMOKE
setup without the learned variants.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/torch_sh8_jit_gap.py

Prints, per degree and per parameter group, the relative L2 distance of the
port's gradient from the jitted JAX gradient and from the eager one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_variants_train as T
from tests.test_torch_train import _jax_loss_and_grads


def _jit_grads(jtr, jstate, jdata, draws):
    def f(params, occ, data, img, pix, noise):
        ints, floats = [img, pix], [noise]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "randint",
                       lambda key, shape, minval, maxval, dtype=jnp.int32: ints.pop(0).astype(dtype))
            mp.setattr(jax.random, "uniform",
                       lambda key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0:
                       floats.pop(0).astype(dtype))
            return jax.value_and_grad(jtr._loss_fn, has_aux=True)(
                params, occ, jax.random.PRNGKey(0), data, None, False)

    return jax.jit(f)(jstate.params, jstate.occ, jdata, *(jnp.asarray(a) for a in draws))[1]


def main() -> None:
    T.VARIANTS = {}
    for degree in (4, 8):
        T.FIELD = dict(T.FIELD, sh_degree=degree)
        T._setup.cache_clear()
        jtr, ptr, jstate, jdata = T._setup()
        state = T.train_state_from_jax(jstate, device="cpu")
        data = ptr.scene_to_device(T.PS.make_synthetic_scene(num_views=2, H=64, W=64, num_steps=32))
        draws = T._batch(20, 2, 64 * 64)
        named = T.PTR._leaves(state.params)
        loss, _ = ptr._loss_fn(state.params, state.occ, data, T._port_batch(draws), False, state.rng)
        gp = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        g_jit = T._leaves(jax.tree.map(np.asarray, _jit_grads(jtr, jstate, jdata, draws)))
        g_eager = T._leaves(jax.tree.map(np.asarray, _jax_loss_and_grads(jtr, jstate, jdata, draws)[2]))
        print(f"SH degree {degree}: relative L2 of the port's gradient from JAX jit / eager")
        for (n, _), g in zip(named, gp):
            if g is None or not np.linalg.norm(g_eager[n]):
                continue
            a = g.numpy()
            rel = [np.linalg.norm(a - r) / np.linalg.norm(r) for r in (g_jit[n], g_eager[n])]
            print(f"  {n:24s} jit {rel[0]:.3e}  eager {rel[1]:.3e}")


if __name__ == "__main__":
    main()
