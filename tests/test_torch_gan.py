"""The GAN stack (``utils/gan.py``): the PyTorch port against the JAX
package (CPU), at ``tests/test_gan.py``'s widths.

The JAX networks' weights go to the port through
``carry.gan_params_from_jax``; the standard normal draws are made with
numpy and handed to both (``jax.random.normal`` patched). Tolerance: every
output within 1e-5 of its largest entry, and every gradient leaf within
1e-5 of the largest entry of its network's gradient (float32 convolutions
summed in other orders by XLA and by PyTorch's CPU kernels; a conv bias
before a batch norm has a gradient of zero, which both packages give as
rounding noise).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)
from trinerflet_tpu.utils import gan as JG
from trinerflet_tpu_torch.carry import gan_params_from_jax
from trinerflet_tpu_torch.utils import gan as PG

TOL = 1e-5
JCFG = JG.GANConfig(ch=16, ch_enc=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=2,
                    in_channels=3 + 2, global_code_dim=8, disc_ndf=8, disc_layers=2, groups=8)
PCFG = PG.GANConfig(ch=16, ch_enc=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=2,
                    in_channels=3 + 2, global_code_dim=8, disc_ndf=8, disc_layers=2, groups=8)


def _close(got, want, what="", scale=None):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max() if scale is None else scale, 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= TOL, (what, err)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _close_grads(got: dict, want_jax, prefix: str):
    want = _leaves(gan_params_from_jax({prefix: jax.tree.map(np.asarray, want_jax)}, "cpu"))
    assert {prefix + "." + k for k in got} == set(want)
    assert sum(float(g.abs().sum()) for g in got.values()) > 0
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for k, g in got.items():
        _close(g, want[prefix + "." + k].numpy(), k, scale)


class _Normals:
    """Stands in for jax.random.normal: hands out numpy arrays in order."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, key, shape=(), dtype=jnp.float32):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape)
        return jnp.asarray(a, dtype)


@functools.lru_cache(maxsize=None)
def _stack():
    jp = jax.jit(JG.init_gan_stack, static_argnums=1)(jax.random.PRNGKey(0), JCFG)
    pp = gan_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, pp


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    lr = rng.random((1, 16, 16, 3 + 2 * 2)).astype(np.float32)
    lr[..., 5:] = rng.uniform(-2, 1, (1, 16, 16, 2))  # the log-variances
    gt = rng.random((1, 32, 32, 3)).astype(np.float32)
    return lr, gt


def test_diagonal_gaussian_matches_jax():
    rng = np.random.default_rng(0)
    par = np.concatenate([rng.standard_normal((2, 4, 4, 3)), rng.uniform(-40, 30, (2, 4, 4, 3))],
                         -1).astype(np.float32)
    other = np.concatenate([rng.standard_normal((2, 4, 4, 3)), rng.uniform(-1, 1, (2, 4, 4, 3))],
                           -1).astype(np.float32)
    noise = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    jd, jo = JG.DiagonalGaussian(jnp.asarray(par)), JG.DiagonalGaussian(jnp.asarray(other))
    pd, po = PG.DiagonalGaussian(torch.from_numpy(par)), PG.DiagonalGaussian(torch.from_numpy(other))
    _close(pd.kl(), jd.kl(), "kl")
    _close(pd.kl(po), jd.kl(jo), "kl(other)")
    _close(pd.nll(torch.from_numpy(noise)), jd.nll(jnp.asarray(noise)), "nll")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", _Normals([noise]))
        js = jd.sample(jax.random.PRNGKey(0))
    _close(pd.sample(noise=torch.from_numpy(noise)), js, "sample")
    np.testing.assert_array_equal(pd.mode().numpy(), par[..., :3])
    g = torch.Generator().manual_seed(0)
    s = torch.stack([PG.DiagonalGaussian(torch.cat([torch.full((1, 2, 2, 2), 3.0),
                                                    torch.zeros((1, 2, 2, 2))], -1)).sample(g)
                     for _ in range(200)])
    assert abs(float(s.mean()) - 3.0) < 0.1
    det = PG.DiagonalGaussian(torch.from_numpy(par), deterministic=True)
    assert torch.equal(det.sample(), det.mean) and (det.kl() == 0).all()


def test_losses_and_gate_match_jax():
    rng = np.random.default_rng(2)
    lr, lf = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    for j, p in ((JG.hinge_d_loss, PG.hinge_d_loss), (JG.vanilla_d_loss, PG.vanilla_d_loss)):
        _close(p(torch.from_numpy(lr), torch.from_numpy(lf)), j(jnp.asarray(lr), jnp.asarray(lf)))
    for step in (0, 9, 10, 15):
        assert float(PG.adopt_weight(2.0, step, threshold=10)) == \
            float(JG.adopt_weight(2.0, jnp.asarray(step), threshold=10))


@pytest.mark.parametrize("net", ["discriminator", "local_encoder", "generator", "global_encoder"])
def test_networks_match_jax(net):
    jp, pp = _stack()
    lr, gt = _inputs()
    rng = np.random.default_rng(3)
    if net == "discriminator":
        want = jax.jit(JG.discriminator_apply)(jp[net], jnp.asarray(gt))
        got = PG.discriminator_apply(pp[net], torch.from_numpy(gt))
        assert got.shape == (1, 6, 6, 1)
    elif net == "local_encoder":
        want = jax.jit(JG.taming_encoder_apply, static_argnums=1)(jp[net], JCFG, jnp.asarray(gt))
        got = PG.taming_encoder_apply(pp[net], PCFG, torch.from_numpy(gt))
    elif net == "generator":
        code = rng.standard_normal((1, 8)).astype(np.float32)
        z = rng.random((1, 16, 16, 5)).astype(np.float32)
        want = jax.jit(JG.taming_decoder_apply, static_argnums=1)(jp[net], JCFG, jnp.asarray(z),
                                                                   jnp.asarray(code))
        got = PG.taming_decoder_apply(pp[net], PCFG, torch.from_numpy(z), torch.from_numpy(code))
        assert got.shape == (1, 32, 32, 3)
    else:
        x = rng.random((2, 64, 64, 3)).astype(np.float32)
        want = jax.jit(JG.global_encoder_apply)(jp[net], jnp.asarray(x))
        got = PG.global_encoder_apply(pp[net], torch.from_numpy(x))
        assert got.shape == (2, 8)
    _close(got, want, net)


@pytest.mark.parametrize("level,sample_posterior", [(0, False), (1, False), (2, False), (0, True)])
def test_gan_render_matches_jax(level, sample_posterior):
    jp, pp = _stack()
    lr, gt = _inputs()
    rng = np.random.default_rng(4)
    n1 = rng.standard_normal((1, 16, 16, 2)).astype(np.float32)
    n2 = rng.standard_normal((1, 16, 16, 2)).astype(np.float32)
    draws = ([n1] if sample_posterior else []) + ([n2] if level == 2 else [])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", _Normals(draws))
        jo = jax.jit(lambda p: JG.gan_render(
            p, JCFG, jnp.asarray(lr), jax.random.PRNGKey(3), gt_rgb=jnp.asarray(gt),
            generator_level=level, sample_posterior=sample_posterior))(jp)
    po = PG.gan_render(pp, PCFG, torch.from_numpy(lr), gt_rgb=torch.from_numpy(gt),
                       generator_level=level, sample_posterior=sample_posterior,
                       noise=torch.from_numpy(n1), noise_level2=torch.from_numpy(n2))
    assert po.keys() == jo.keys()
    for k in jo:
        _close(po[k], jo[k], k)
    assert po["comp_gan_rgb"].shape == (1, 32, 32, 3)


def test_generator_and_discriminator_steps_match_jax():
    """One G step's gradient (L1 to the ground truth + 1e-3 x the generator
    loss, through gan_render at level 0) and one D step's (the hinge loss
    on the ground truth against that render), leaf by leaf."""
    jp, pp = _stack()
    lr, gt = _inputs()

    def jg_loss(gen):
        out = JG.gan_render(dict(jp, generator=gen), JCFG, jnp.asarray(lr), jax.random.PRNGKey(3),
                            gt_rgb=jnp.asarray(gt))
        rec = jnp.abs(out["comp_gan_rgb"] - jnp.asarray(gt)).mean()
        return rec + 1e-3 * JG.generator_loss(jp["discriminator"], out["comp_gan_rgb"])

    jl, jgrad = jax.jit(jax.value_and_grad(jg_loss))(jp["generator"])
    gen = _leaves(pp["generator"])
    gen = {k: v.clone().requires_grad_(True) for k, v in gen.items()}
    out = PG.gan_render(dict(pp, generator=_nest(gen)), PCFG, torch.from_numpy(lr),
                        gt_rgb=torch.from_numpy(gt))
    pl = ((out["comp_gan_rgb"] - torch.from_numpy(gt)).abs().mean()
          + 1e-3 * PG.generator_loss(pp["discriminator"], out["comp_gan_rgb"]))
    _close(pl, jl, "G loss")
    _close_grads(dict(zip(gen, torch.autograd.grad(pl, list(gen.values())))), jgrad, "generator")

    jo = jax.jit(lambda p: JG.gan_render(p, JCFG, jnp.asarray(lr), jax.random.PRNGKey(3),
                                         gt_rgb=jnp.asarray(gt)))(jp)
    jd_l, jd_g = jax.jit(jax.value_and_grad(
        lambda d: JG.discriminator_loss(d, jnp.asarray(gt), jo["comp_gan_rgb"])))(jp["discriminator"])
    disc = {k: v.clone().requires_grad_(True) for k, v in _leaves(pp["discriminator"]).items()}
    pd_l = PG.discriminator_loss(_nest(disc), torch.from_numpy(gt), out["comp_gan_rgb"].detach())
    _close(pd_l, jd_l, "D loss")
    _close_grads(dict(zip(disc, torch.autograd.grad(pd_l, list(disc.values())))), jd_g,
                 "discriminator")


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        node = tree
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def test_init_gan_stack_shapes_match_jax():
    jp = _stack()[0]
    pp = PG.init_gan_stack(torch.Generator().manual_seed(0), PCFG, device="cpu")
    want = {k: tuple(v.shape) for k, v in _leaves(gan_params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")).items()}
    assert {k: tuple(v.shape) for k, v in _leaves(pp).items()} == want
    w = pp["discriminator"]["layers"]["0"]["weight"]
    assert 0.015 < float(w.std()) < 0.025  # taming's N(0, 0.02) init
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            PG.init_gan_stack(None, PCFG)
        else:
            raise RuntimeError("CUDA present")
