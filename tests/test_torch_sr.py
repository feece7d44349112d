"""The SR app's host and guidance layers in the PyTorch port against the JAX
package (CPU): the config layer and the repo's four SR configs, the resize
helper, the diffusion schedule, the guidances (``generate_sr`` with the
oracle, conditioning and resize guidances, ``sds_loss`` and its gradient),
the synthetic scenes and the SR data (scene pairs, the shuffled ray
stream, the npz cache read across packages, the Blender and LLFF pairs).

Random draws are handed to both packages (``jax.random.normal`` /
``randint`` patched, the port's ``_randn`` / ``_randint`` patched). Images
go NHWC to JAX and NCHW to the port. Tolerances:
* configs, scheduled scalars, tokens, scenes on the host, the ray stream,
  nearest resize: equal;
* bilinear resize: atol 3e-7 (float32 weights, contracted in another
  order);
* the schedule and a DDIM step: rtol 1e-6 against JAX (``torch.linspace``
  and ``jnp.linspace`` may round the last bit apart), and the diffusers 0.16
  constants of tests/test_diffusion_schedule.py at their tolerances;
* generate_sr: atol 2e-6 (float32, 10-12 DDIM steps); sds_loss rtol 1e-5
  and its gradient atol 1e-6;
* the srtex scene rendered by torch (``backend="torch"``) against the host
  render: atol 1e-5.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_diffusion_schedule import GOLDEN_ALPHAS_CUMPROD, GOLDEN_BETAS
from tests.test_llff import _write_llff_dataset
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.data import synthetic as JS
from trinerflet_tpu.sr import config as JC
from trinerflet_tpu.sr import data as JDATA
from trinerflet_tpu.sr import guidance as JG
from trinerflet_tpu.sr import system as JSYS
from trinerflet_tpu_torch.data import synthetic as PS
from trinerflet_tpu_torch.ops.resize import resize
from trinerflet_tpu_torch.sr import config as PC
from trinerflet_tpu_torch.sr import data as PDATA
from trinerflet_tpu_torch.sr import guidance as PG
from trinerflet_tpu_torch.sr import system as PSYS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "triplane-sr*.yaml"))),
                         ids=os.path.basename)
def test_repo_configs_parse_as_jax(path):
    """Each SR config reads as ``yaml.safe_load`` reads it, as the JAX
    loader reads it, and builds the same SRConfig and GuidanceConfig."""
    with open(path) as f:
        ref = yaml.safe_load(f)
    got = PC.load_yaml_config(path)
    assert got == ref == JC.load_yaml_config(path)
    sys_p = {k: v for k, v in got.get("system", {}).items() if k != "kind"}
    g = {k: v for k, v in got.get("guidance", {}).items() if k not in ("kind", "weights")}
    assert (dataclasses.asdict(PC.parse_structured(PSYS.SRConfig, sys_p))
            == dataclasses.asdict(JC.parse_structured(JSYS.SRConfig, sys_p)))
    assert (dataclasses.asdict(PC.parse_structured(PG.GuidanceConfig, g))
            == dataclasses.asdict(JC.parse_structured(JG.GuidanceConfig, g)))


def test_scheduled_scalars_and_overrides_match_jax():
    for value in (0.5, 3, [6000, 0.0, 1.0, 16000], [0.1, 0.9, 100], [10, 1.0, 2.0, 10]):
        for step in (0, 5, 50, 99, 6000, 11000, 16000, 20000):
            assert PC.C(value, step) == JC.C(value, step), (value, step)
    with pytest.raises(ValueError):
        PC.C([1, 2], 0)
    base = {"system": {"total_steps": 10}}
    ovs = ["system.sr_start_step=100", "data.root=/x", "system.lambda_l1_hr=[0, 0.0, 1.0, 10]",
           "guidance.kind=cond"]
    assert PC.apply_overrides(dict(base), ovs) == JC.apply_overrides(dict(base), ovs)
    with pytest.raises(ValueError, match="unknown config keys"):
        PC.parse_structured(PSYS.SRConfig, {"bogus": 1})


# ------------------------------------------------------------------ resize

@pytest.mark.parametrize("src, dst", [((1, 8, 8, 3), (1, 32, 32, 3)), ((2, 25, 17, 3), (2, 100, 68, 3)),
                                      ((1, 32, 32, 3), (1, 8, 8, 3)), ((1, 31, 45, 3), (1, 7, 13, 3)),
                                      ((1, 10, 10, 3), (1, 15, 23, 3)), ((16, 12, 3), (48, 36, 3))],
                         ids=["grow4", "grow4-odd", "shrink4", "shrink-odd", "grow-odd", "hwc"])
def test_resize_matches_jax_image_resize(src, dst):
    """One helper for every ``jax.image.resize`` of the SR app: bilinear
    (half-pixel centres, edge renormalisation, antialiased shrinking) and
    nearest, growing, shrinking, at odd sizes."""
    x = np.random.default_rng(sum(src)).random(src).astype(np.float32)
    for method, tol in (("bilinear", 3e-7), ("nearest", 0.0)):
        ref = np.asarray(jax.image.resize(jnp.asarray(x), dst, method))
        got = resize(torch.from_numpy(x), dst, method).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=method)
    with pytest.raises(ValueError):
        resize(torch.from_numpy(x), dst, "cubic")


# ---------------------------------------------------------------- schedule

def test_schedule_matches_jax_and_diffusers_constants():
    js, ps = JG.DiffusionSchedule(1000), PG.DiffusionSchedule(1000)
    for name in ("betas", "alphas", "alphas_cumprod"):
        np.testing.assert_allclose(getattr(ps, name).numpy(), np.asarray(getattr(js, name)), rtol=1e-6)
    for i, v in GOLDEN_BETAS.items():
        assert float(ps.betas[i]) == pytest.approx(v, rel=1e-5)
    for i, v in GOLDEN_ALPHAS_CUMPROD.items():
        assert float(ps.alphas_cumprod[i]) == pytest.approx(v, rel=1e-4)
    assert float(ps.final_alpha_cumprod) == pytest.approx(0.9999, rel=1e-6)
    assert float(PG.DiffusionSchedule(1000, set_alpha_to_one=True).final_alpha_cumprod) == 1.0
    for n in (4, 10, 75, 1000):
        assert ps.ddim_timesteps(n).tolist() == np.asarray(js.ddim_timesteps(n)).tolist()
    rng = np.random.default_rng(0)
    x, eps = rng.standard_normal((2, 2, 4, 4, 3)).astype(np.float32)
    for t, t_prev in ((751, 501), (1, -1)):
        jx, jx0 = js.ddim_step(jnp.asarray(eps), t, t_prev, jnp.asarray(x))
        px, px0 = ps.ddim_step(torch.from_numpy(eps), t, t_prev, torch.from_numpy(x))
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(px0.numpy(), np.asarray(jx0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ps.add_noise(torch.from_numpy(x), torch.from_numpy(eps), 20).numpy(),
                               np.asarray(js.add_noise(jnp.asarray(x), jnp.asarray(eps), 20)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("step", [0, 6000, 9000, 16000, 30000])
def test_step_bounds_match_jax(step):
    kw = dict(min_step_percent=0.02, max_step_percent=0.98, sr_start_step=6000, anneal_end_step=16000,
              max_step_percent_final=0.25)
    jg = JG.make_oracle_guidance(JG.GuidanceConfig(**kw), jnp.zeros((1, 4, 4, 3)))
    pg = PG.make_oracle_guidance(PG.GuidanceConfig(**kw), torch.zeros((1, 3, 4, 4)))
    assert pg.step_bounds(step) == jg.step_bounds(step)


# ---------------------------------------------------------------- guidance

class _Draws:
    """The same numpy draws to jax.random.normal / randint (NHWC) and to the
    port's _randn / _randint (NCHW), in order."""

    def __init__(self, normals, ints=()):
        self.jn, self.pn = list(normals), list(normals)
        self.ji, self.pi = list(ints), list(ints)

    def j_normal(self, key, shape=(), dtype=jnp.float32):
        a = self.jn.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a, dtype)

    def p_randn(self, shape, generator, device):
        a = self.pn.pop(0)
        assert (a.shape[0], a.shape[3], a.shape[1], a.shape[2]) == tuple(shape), (a.shape, shape)
        return _nchw(a)

    def j_randint(self, key, shape, minval, maxval, dtype=jnp.int32):
        v = self.ji.pop(0)
        assert int(minval) <= v < int(maxval)
        return jnp.asarray(v, dtype)

    def p_randint(self, lo, hi, generator):
        v = self.pi.pop(0)
        assert lo <= v < hi
        return v

    def patch(self, mp):
        mp.setattr(jax.random, "normal", self.j_normal)
        mp.setattr(jax.random, "randint", self.j_randint)
        mp.setattr(PG, "_randn", self.p_randn)
        mp.setattr(PG, "_randint", self.p_randint)


@pytest.mark.parametrize("kind, ignore_t, cfg_kw",
                         [("oracle", 500, dict(guidance_scale=1.0)),
                          ("oracle", None, dict(guidance_scale=7.5, guidance_scale_sr=3.0)),
                          ("cond", 1000, dict(guidance_scale=1.0)),
                          ("cond", 400, dict(guidance_scale=7.5))])
def test_generate_sr_matches_jax(kind, ignore_t, cfg_kw):
    """SDEdit with the oracle and the conditioning denoisers: the draws
    (ignore_t from the step bounds when not given, the LR condition's noise,
    the initial latents, the image-CFG noise, the re-noise above ignore_t)
    handed to both."""
    cfg_j = JG.GuidanceConfig(num_inference_steps=12, noise_level=20, **cfg_kw)
    cfg_p = PG.GuidanceConfig(num_inference_steps=12, noise_level=20, **cfg_kw)
    rng = np.random.default_rng(3)
    lr = rng.random((1, 8, 8, 3)).astype(np.float32)
    hr = rng.random((1, 32, 32, 3)).astype(np.float32)
    target = rng.random((1, 32, 32, 3)).astype(np.float32)
    if kind == "oracle":
        jg, pg = JG.make_oracle_guidance(cfg_j, jnp.asarray(target)), PG.make_oracle_guidance(cfg_p, _nchw(target))
    else:
        jg, pg = JG.make_cond_guidance(cfg_j), PG.make_cond_guidance(cfg_p)
    ints = [] if ignore_t is not None else [640]
    t_eff = 640 if ignore_t is None else ignore_t
    steps = [int(v) for v in np.asarray(JG.DiffusionSchedule().ddim_timesteps(12))]
    img_cfg = cfg_kw.get("guidance_scale_sr", -1) > 1 and cfg_kw["guidance_scale"] > 1
    shapes = [(1, 32, 32, 3)] * (2 + img_cfg + sum(t > t_eff for t in steps))
    draws = _Draws([rng.standard_normal(s).astype(np.float32) for s in shapes], ints)
    with pytest.MonkeyPatch.context() as mp:
        draws.patch(mp)
        ref = np.asarray(jg.generate_sr(jax.random.PRNGKey(0), jnp.asarray(lr), jnp.asarray(hr),
                                        step=9000, ignore_t=ignore_t))
        got = _nhwc(pg.generate_sr(_nchw(lr), _nchw(hr), step=9000, ignore_t=ignore_t))
    assert not draws.jn and not draws.pn and not draws.ji and not draws.pi
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    if kind == "cond" and ignore_t == 1000:  # a full denoise approaches the upsampled LR
        up = resize(_nchw(lr), (1, 3, 32, 32))
        assert float((torch.from_numpy(got).permute(0, 3, 1, 2) - up).abs().mean()) < 0.08


def test_resize_guidance_matches_jax():
    rng = np.random.default_rng(4)
    lr = rng.random((1, 16, 16, 3)).astype(np.float32)
    hr = rng.random((1, 64, 64, 3)).astype(np.float32)
    jg, pg = JG.make_resize_guidance(JG.GuidanceConfig()), PG.make_resize_guidance(PG.GuidanceConfig())
    ref = np.asarray(jg.generate_sr(jax.random.PRNGKey(0), jnp.asarray(lr), jnp.asarray(hr)))
    np.testing.assert_allclose(_nhwc(pg.generate_sr(_nchw(lr), _nchw(hr))), ref, rtol=0, atol=3e-7)
    assert pg.step_bounds(5) == jg.step_bounds(5) == (0, 1000)
    hr_t = _nchw(hr).requires_grad_(True)
    loss = pg.sds_loss(_nchw(lr), hr_t)
    jloss, jgrad = jax.value_and_grad(lambda h: jg.sds_loss(None, jnp.asarray(lr), h))(jnp.asarray(hr))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(_nhwc(hr_t.grad), np.asarray(jgrad), rtol=0, atol=1e-8)


@pytest.mark.parametrize("t_bounds", [None, (100, 300)])
def test_sds_loss_and_gradient_match_jax(t_bounds):
    cfg_kw = dict(num_inference_steps=10, guidance_scale=1.0)
    rng = np.random.default_rng(5)
    target = rng.random((1, 16, 16, 3)).astype(np.float32)
    lr = rng.random((1, 8, 8, 3)).astype(np.float32)
    hr = rng.random((1, 16, 16, 3)).astype(np.float32)
    jg = JG.make_oracle_guidance(JG.GuidanceConfig(**cfg_kw), jnp.asarray(target))
    pg = PG.make_oracle_guidance(PG.GuidanceConfig(**cfg_kw), _nchw(target))
    draws = _Draws([rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(2)], [250])
    hr_t = _nchw(hr).requires_grad_(True)
    with pytest.MonkeyPatch.context() as mp:
        draws.patch(mp)
        tb = None if t_bounds is None else jnp.asarray(t_bounds, jnp.int32)
        jloss, jgrad = jax.value_and_grad(
            lambda h: jg.sds_loss(jax.random.PRNGKey(0), jnp.asarray(lr), h, step=10, t_bounds=tb))(jnp.asarray(hr))
        loss = pg.sds_loss(_nchw(lr), hr_t, step=10, t_bounds=t_bounds)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(_nhwc(hr_t.grad), np.asarray(jgrad), rtol=0, atol=1e-6)
    assert float(hr_t.grad.abs().sum()) > 0


# ------------------------------------------------------------ scenes, data

@pytest.mark.parametrize("variant", ["spheres", "hf", "srtex"])
def test_synthetic_variants_match_jax(variant):
    """The host render is the JAX package's bit for bit; the same scene
    rendered by torch (``backend="torch"``, the JAX package's "jax") within
    atol 1e-5."""
    kw = dict(num_views=2, H=12, W=10, seed=2, num_steps=16, variant=variant)
    j, p = JS.make_synthetic_scene(**kw), PS.make_synthetic_scene(**kw)
    np.testing.assert_array_equal(p.images, j.images)
    np.testing.assert_array_equal(p.poses, j.poses)
    t = PS.make_synthetic_scene(**kw, backend="torch", device="cpu")
    assert t.images.dtype == np.float32 and t.images.shape == (2, 12, 10, 4)
    np.testing.assert_allclose(t.images, j.images, rtol=0, atol=1e-5)
    pts = np.random.default_rng(1).uniform(-1, 1, (500, 3)).astype(np.float32)
    js, jr = getattr(JS, "field" if variant == "spheres" else f"field_{variant}")(pts)
    ps_, pr = getattr(PS, "field" if variant == "spheres" else f"field_{variant}")(pts)
    np.testing.assert_array_equal(ps_, js)
    np.testing.assert_array_equal(pr, jr)
    with pytest.raises(ValueError, match="backend"):
        PS.make_synthetic_scene(**kw, backend="tpu")


@pytest.mark.parametrize("lr_from", ["downsample", "render"])
def test_synthetic_sr_scene_and_ray_stream_match_jax(lr_from):
    kw = dict(num_views=3, lr_size=8, scale=2, seed=1, background_color=0.3, variant="srtex", lr_from=lr_from)
    j, p = JDATA.make_synthetic_sr_scene(**kw), PDATA.make_synthetic_sr_scene(**kw)
    for side in ("lr", "hr"):
        a, b = getattr(p, side), getattr(j, side)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.poses, b.poses)
        assert (a.intrinsics, a.H, a.W) == (b.intrinsics, b.H, b.W)
    assert p.scale == j.scale == 2 and p.num_views == 3 and not p.pregen_rays
    for v in range(3):
        for a, b in zip(PDATA.view_ray_grid(p.hr, v), JDATA.view_ray_grid(j.hr, v)):
            np.testing.assert_array_equal(a, b)
    js_, ps_ = JDATA.shuffled_ray_stream(j.lr, 50, seed=4), PDATA.shuffled_ray_stream(p.lr, 50, seed=4)
    for _ in range(5):  # past an epoch (192 rays, 3 chunks of 50 each)
        for a, b in zip(next(ps_), next(js_)):
            np.testing.assert_array_equal(a, b)


def test_scene_npz_cache_reads_across_packages(tmp_path):
    """Each package loads the npz the other wrote, array for array."""
    scene = PDATA.make_synthetic_sr_scene(num_views=2, lr_size=8, scale=2, variant="hf")
    pj, pp = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    PDATA.save_sr_scene_npz(scene, pp)
    JDATA.save_sr_scene_npz(JDATA.make_synthetic_sr_scene(num_views=2, lr_size=8, scale=2, variant="hf"), pj)
    for a, b in ((JDATA.load_sr_scene_npz(pp), PDATA.load_sr_scene_npz(pj)),
                 (PDATA.load_sr_scene_npz(pp), JDATA.load_sr_scene_npz(pj))):
        for side in ("lr", "hr"):
            np.testing.assert_array_equal(getattr(a, side).images, getattr(b, side).images)
            np.testing.assert_array_equal(getattr(a, side).poses, getattr(b, side).poses)
            assert getattr(a, side).intrinsics == getattr(b, side).intrinsics


def test_blender_and_llff_pairs_match_jax(tmp_path):
    """Blender pairs through the port's loaders (a scene written here, an
    RGBA PNG set) and LLFF pairs with their NDC ray grids, against JAX's."""
    root = str(tmp_path / "blender")
    PS.write_synthetic_scene(root, num_views=2, num_test_views=1, H=16, W=16, variant="hf")
    j = JDATA.load_sr_blender(root, scale_ratio=2, background_color=1.0, data_scale=1.0)
    p = PDATA.load_sr_blender(root, scale_ratio=2, background_color=1.0, data_scale=1.0)
    for side in ("lr", "hr"):
        np.testing.assert_allclose(getattr(p, side).images, getattr(j, side).images, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(getattr(p, side).poses, getattr(j, side).poses)
        assert getattr(p, side).intrinsics == getattr(j, side).intrinsics
    assert p.lr.images.shape == (2, 8, 8, 3) and p.scale == 2
    llff = _write_llff_dataset(str(tmp_path / "llff"), V=4, H=24, W=32)
    jl = JDATA.load_sr_llff(llff, hr_downscale=1, scale_ratio=2, llff_hold=2)
    pl = PDATA.load_sr_llff(llff, hr_downscale=1, scale_ratio=2, llff_hold=2)
    assert pl.pregen_rays and pl.scale == jl.scale
    for side in ("lr", "hr"):
        for k in ("images", "rays_o", "rays_d"):
            np.testing.assert_allclose(getattr(getattr(pl, side), k), getattr(getattr(jl, side), k),
                                       rtol=0, atol=1e-6, err_msg=f"{side}.{k}")
