"""CLIP guidance (``--rand_pose``) in the PyTorch port against the JAX
package (CPU): the towers, the preprocessing, the loss and its image
gradient, the checkpoint loader of the CLI, and ``Trainer.fit`` with CLIP
steps.

The towers run at tests/test_clip.py's tiny widths (ViT 32^2 / 8, 16 wide,
2 layers; text 16 wide, 2 layers, 64 tokens of which 63 is EOS), on
parameters drawn with numpy in the JAX package's layout and carried into
the port with ``carry.clip_params_from_jax`` (the patch kernel back to the
state dict's OIHW weight).

Tolerances: features atol 2e-5 (tests/test_clip.py's bound against
transformers); ``preprocess`` atol 1e-6 against float64 and the JAX
package's within 1e-6 beyond its own distance from float64 (the test
says why); the loss rtol 1e-4 and its image gradient within 1e-4 of its
largest entry (a sum over 64 patches and 3 colours in another order); the
CLIP-guided ``fit``: losses rtol 1e-4, parameters atol 5e-5.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sr_system import _f32, no_jit
from tests.test_torch_train import TKW, _leaves, _setup
from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu import cli as JCLI
from trinerflet_tpu.sr.text import TextConfig as JTextConfig
from trinerflet_tpu.train import trainer as JTR
from trinerflet_tpu.utils import clip_loss as JC
from trinerflet_tpu_torch import cli as PCLI
from trinerflet_tpu_torch.carry import clip_params_from_jax, train_state_from_jax
from trinerflet_tpu_torch.data import synthetic as PS
from trinerflet_tpu_torch.sr.text import TextConfig as PTextConfig
from trinerflet_tpu_torch.train import trainer as PTR
from trinerflet_tpu_torch.utils import clip_loss as PC

V = dict(image_size=32, patch_size=8, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
         projection_dim=12, hidden_act="quick_gelu")
T = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32, max_length=16,
         hidden_act="quick_gelu")
TOKENS = np.array([[5, 9, 3, 63, 0, 0, 0, 0], [7, 63, 0, 0, 0, 0, 0, 0]], np.int32)


def _params():
    """A CLIP tree in the JAX package's layout, every leaf drawn with
    numpy (layer norms around 1, the rest around 0), and the port's carry."""
    rng = np.random.default_rng(0)
    shapes = JC.init_clip_params(jax.random.PRNGKey(0), JC.VisionConfig(**V), JTextConfig(**T))

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name and name.endswith("['weight']"):
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)

    jp = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree.map(jnp.asarray, jp), clip_params_from_jax(jp, "cpu")


def test_carry_turns_the_patch_kernel_back():
    jp, pp = _params()
    k = np.asarray(jp["vision_model"]["embeddings"]["patch_embedding"]["kernel"])   # (P*P*3, D)
    w = pp["vision_model"]["embeddings"]["patch_embedding"]["weight"].numpy()       # (D, 3, P, P)
    assert w.shape == (16, 3, 8, 8)
    np.testing.assert_array_equal(w.transpose(2, 3, 1, 0).reshape(-1, 16), k)
    assert "kernel" not in pp["vision_model"]["embeddings"]["patch_embedding"]


def test_features_match_jax():
    jp, pp = _params()
    imgs = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(PC.image_features(pp, PC.VisionConfig(**V), torch.from_numpy(imgs)).numpy(),
                               np.asarray(JC.image_features(jp, JC.VisionConfig(**V), jnp.asarray(imgs))),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(PC.vision_encode(pp, PC.VisionConfig(**V), torch.from_numpy(imgs)).numpy(),
                               np.asarray(JC.vision_encode(jp, JC.VisionConfig(**V), jnp.asarray(imgs))),
                               rtol=0, atol=2e-5)
    # EOS (the largest id) mid-sequence: the pooled output indexes it
    np.testing.assert_allclose(PC.text_features(pp, PTextConfig(**T), torch.from_numpy(TOKENS)).numpy(),
                               np.asarray(JC.text_features(jp, JTextConfig(**T), jnp.asarray(TOKENS))),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("side", [20, 32, 141, 800])
def test_preprocess_matches_jax(side):
    """Up (20^2, 141^2 to 224 at ViT-B/16's size; 20^2 to 32), the same
    size, and down (800^2). The port is within 1e-6 of the same resize and
    normalisation in float64 (the JAX package's weights, contracted
    exactly); the JAX package's own ``jax.image.resize`` contraction on the
    CPU is up to 6.9e-6 from it at 141^2 -> 224 (measured; 1e-6 at the
    sizes it shrinks or grows by under 2), so the port is held to the JAX
    package within 1e-6 beyond that distance."""
    from trinerflet_tpu_torch.ops.resize import bilinear_weights

    x = np.random.default_rng(side).random((1, side, side, 3)).astype(np.float32)
    for size in (32, 224):
        w = bilinear_weights(side, size).double().numpy()
        up = np.tensordot(np.tensordot(x.astype(np.float64), w, (1, 0)), w, (1, 0))  # (1, c, H, W)
        exact = (up.transpose(0, 2, 3, 1) - np.array(PC.CLIP_MEAN)) / np.array(PC.CLIP_STD)
        got = PC.preprocess(torch.from_numpy(x), size).numpy()
        ref = np.asarray(JC.preprocess(jnp.asarray(x), size))
        assert got.shape == ref.shape == (1, size, size, 3)
        np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
        assert np.abs(got - ref).max() <= 1e-6 + np.abs(ref - exact).max(), (side, size)


def _losses(jp, pp):
    jl = JC.CLIPLoss(params=jp, vision_cfg=JC.VisionConfig(**V), text_cfg=JTextConfig(**T))
    pl = PC.CLIPLoss(params=pp, vision_cfg=PC.VisionConfig(**V), text_cfg=PTextConfig(**T))
    for loss in (jl, pl):
        loss.prepare_text(["x", "y"], tokens=TOKENS)
    return jl, pl


@pytest.mark.parametrize("prompt", [0, 1])
def test_loss_and_image_gradient_match_jax(prompt):
    jp, pp = _params()
    jl, pl = _losses(jp, pp)
    x = np.random.default_rng(3).random((2, 22, 22, 3)).astype(np.float32)
    vj, gj = jax.value_and_grad(lambda im: jl(im, prompt))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    vp = pl(xt, prompt)
    (gp,) = torch.autograd.grad(vp, [xt])
    np.testing.assert_allclose(float(vp.detach()), float(vj), rtol=1e-4)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gp.numpy(), gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())
    assert np.abs(gj).max() > 0 and pl.text_zs.requires_grad is False


def test_requires_weights_or_a_loss_fn():
    with pytest.raises(NotImplementedError, match="no|none"):
        PC.CLIPLoss()
    loss = PC.CLIPLoss(loss_fn=lambda im: im.mean())
    loss.prepare_text(["ignored"])
    assert float(loss(torch.ones((1, 4, 4, 3)))) == 1.0
    with pytest.raises(ValueError, match="prepare_text"):
        PC.CLIPLoss(params=_params()[1], vision_cfg=PC.VisionConfig(**V), text_cfg=PTextConfig(**T))(
            torch.zeros((1, 32, 32, 3)))


def _checkpoint_dir(tmp_path, form):
    """A tiny transformers CLIPModel written as a --clip_ckpt directory
    (``config.json``, the weights as ``model.safetensors`` or
    ``pytorch_model.bin``) with a character-level vocabulary."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=64, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=32, max_position_embeddings=16, eos_token_id=63),
        vision_config=dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=2, intermediate_size=32,
                           image_size=32, patch_size=8),
        projection_dim=12)
    torch.manual_seed(0)
    model = transformers.CLIPModel(cfg).eval()
    d = tmp_path / form
    if form == "safetensors":
        model.save_pretrained(str(d), safe_serialization=True)
    else:
        d.mkdir()
        model.config.to_json_file(str(d / "config.json"))
        torch.save(model.state_dict(), str(d / "pytorch_model.bin"))
    vocab = {"<|startoftext|>": 62, "<|endoftext|>": 63}
    for i, c in enumerate("abcdefghijklmnopqrstuvwxyz"):
        vocab[c] = i
        vocab[c + "</w>"] = 26 + i
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    return str(d)


@pytest.mark.parametrize("form", ["safetensors", "bin"])
def test_build_clip_loss_from_a_checkpoint_matches_jax(tmp_path, form):
    d = _checkpoint_dir(tmp_path, form)
    assert any(f.endswith(".safetensors" if form == "safetensors" else ".bin")
               for f in __import__("os").listdir(d))
    opt = types.SimpleNamespace(clip_ckpt=d, clip_text="a red cube")
    jl = JCLI._build_clip_loss(opt)
    pl = PCLI._build_clip_loss(opt, "cpu")
    assert pl.vision_cfg == PC.VisionConfig(**dict(V, projection_dim=12))
    np.testing.assert_array_equal(pl.tokenizer("a red cube"), jl.tokenizer("a red cube"))
    x = np.random.default_rng(5).random((1, 22, 22, 3)).astype(np.float32)
    np.testing.assert_allclose(float(pl(torch.from_numpy(x))), float(jl(jnp.asarray(x))), rtol=1e-4)
    with pytest.raises(NotImplementedError, match="--clip_ckpt"):
        PCLI._build_clip_loss(types.SimpleNamespace(clip_ckpt=str(tmp_path / "none"), clip_text=""), "cpu")


class _Draws:
    """Two numpy generators of one seed: ``j`` feeds the JAX trainer's
    patched draws, ``p`` the port's steps, in the same order (the refresh's
    jitter, each supervised step's batch and noise, each CLIP step's
    noise)."""

    def __init__(self, seed):
        self.j, self.p = np.random.default_rng(seed), np.random.default_rng(seed)

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(_f32(float(minval), self.j.random(tuple(shape)), float(maxval)), dtype)

    def randint(self, key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.asarray(self.j.integers(int(minval), int(maxval), tuple(shape)), dtype)

    def patch(self, mp):
        rng = self.p
        mp.setattr(jax.random, "uniform", self.uniform)
        mp.setattr(jax.random, "randint", self.randint)
        train_step, clip_step, update_grid = PTR.Trainer.train_step, PTR.Trainer._clip_step, \
            PTR.Trainer.update_grid

        def _train_step(tr, state, data, with_stats=True, batch=None):
            N = tr.cfg.num_rays
            V, H, W = data["images"].shape[:3]
            img, pix = rng.integers(0, V, N), rng.integers(0, H * W, N)
            noise = _f32(0.0, rng.random(N), 1.0)
            return train_step(tr, state, data, with_stats, {"img_idx": torch.from_numpy(img),
                                                            "pix_idx": torch.from_numpy(pix),
                                                            "noise": torch.from_numpy(noise)})

        def _clip_step(tr, state, rays_o, rays_d, noise=None, jitter=None, u=None):
            return clip_step(tr, state, rays_o, rays_d,
                             torch.from_numpy(_f32(0.0, rng.random(rays_o.shape[0]), 1.0)))

        def _update_grid(tr, params, occ, jitter=None, generator=None, full=True):
            cfg = tr.render_cfg
            H = cfg.grid_size
            halves = [min(2**c, cfg.bound) / H for c in range(cfg.cascades)]
            jit = np.stack([_f32(-h, rng.random((H**3, 3)), h) for h in halves])
            return update_grid(tr, params, occ, torch.from_numpy(jit), generator, full)

        mp.setattr(PTR.Trainer, "train_step", _train_step)
        mp.setattr(PTR.Trainer, "_clip_step", _clip_step)
        mp.setattr(PTR.Trainer, "update_grid", _update_grid)


def test_fit_with_clip_steps_matches_jax():
    """4 iterations of ``fit`` with ``rand_pose_interval`` 1 (a CLIP step
    after every supervised one: 6 steps in all) and the CLIP loss at the tiny
    widths, every draw handed to both packages (the random poses come from
    both trainers' own host generator of seed + 7): the supervised losses
    rtol 1e-4; parameters and EMA within 5e-5 everywhere. (The CLIP steps'
    image gradient agrees to 1e-4 of its largest entry, test above; through
    Adam's normalisation that moved entries of every plane group and
    sigma_net.w0 by up to 3.3e-5 in these 6 steps, measured: 0.13% of
    sigma_net.w0 beyond 1e-5. 5e-5 is 1/2400 of the trajectory tests'
    bound of 2 lr a step.)"""
    jtr0, ptr0, jstate0, _ = _setup("float32")
    jp, pp = _params()
    jl, pl = _losses(jp, pp)
    scene = PS.make_synthetic_scene(num_views=2, H=64, W=64, num_steps=32)
    draws = _Draws(21)
    with pytest.MonkeyPatch.context() as mp:
        no_jit(mp)
        # 484 rays: the CLIP render's 22^2, so both steps run at one shape
        tkw = dict(TKW, iters=4, num_rays=484)
        jtr = JTR.Trainer(jtr0.nerf_cfg, jtr0.render_cfg, JTR.TrainConfig(**tkw))
        ptr = PTR.Trainer(ptr0.nerf_cfg, ptr0.render_cfg, PTR.TrainConfig(**tkw), device="cpu")
        jtr.set_clip_guidance(jl, 1)
        ptr.set_clip_guidance(pl, 1)
        assert ptr.clip_hw == jtr.clip_hw == (22, 22)
        state = train_state_from_jax(jstate0, device="cpu")
        draws.patch(mp)
        ja, pa = [], []
        jstate = jtr.fit(jstate0, scene, log_every=0, callback=lambda s, a: ja.append(float(a["loss"])))
        state = ptr.fit(state, scene, log_every=0, callback=lambda s, a: pa.append(float(a["loss"])))
    assert state.step == int(jstate.step) == 6 and state.ema_count == int(jstate.ema_count) == 6
    np.testing.assert_allclose(pa, ja, rtol=1e-4)
    for tree_p, tree_j in ((state.params, jstate.params), (state.ema_params, jstate.ema_params)):
        lp, lj = _leaves(tree_p), _leaves(jax.tree.map(np.asarray, tree_j))
        for n in lj:
            d = np.abs(lp[n] - lj[n])
            assert d.max() <= 5e-5, (n, d.max())
