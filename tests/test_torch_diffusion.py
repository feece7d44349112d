"""The SR app's networks in the PyTorch port against the JAX package (CPU):
the x4 upscaler's UNet and VAE, the CLIP text encoder, its tokenizer and
prompt cache, the safetensors reader, and ``generate_sr`` through a real
(tiny, random) UNet and VAE.

Shapes are the JAX package's own test shapes: ``TINY_UNET`` / ``TINY_VAE``
(tests/test_diffusion.py) and the text ``TINY`` (tests/test_text.py). The
JAX package draws the weights (biases and norms moved off their
initial zeros and ones so they are exercised) and ``carry.
network_params_from_jax`` carries them (conv kernels HWIO -> OIHW).
Inputs are made with numpy; images go NHWC to JAX and NCHW to the port.

Tolerances, float32 on both sides (the convolutions and matmuls sum in
another order; the attention is a fused softmax here, an einsum there):
* UNet eps and VAE decode: atol 1e-5 on values of order 1;
* VAE encode (latents x 0.08333): atol 1e-6;
* text encoder hidden states (final LayerNorm, order 1): atol 2e-5;
* the tokenizer: equal ids; the prompt cache: the same file, read by both;
* generate_sr through the networks: atol 1e-4 after 4 DDIM steps
  (each step feeds the last's rounding back through the UNet).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import one_torch_thread  # noqa: F401 (autouse)
from trinerflet_tpu.sr import diffusion as JD
from trinerflet_tpu.sr import guidance as JG
from trinerflet_tpu.sr import text as JX
from trinerflet_tpu_torch.carry import network_params_from_jax
from trinerflet_tpu_torch.sr import diffusion as PD
from trinerflet_tpu_torch.sr import guidance as PG
from trinerflet_tpu_torch.sr import text as PX

TINY_UNET_KW = dict(in_channels=7, out_channels=4, block_out_channels=(16, 32),
                    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
                    layers_per_block=1, cross_attention_dim=24, attention_head_dim=(2, 2),
                    norm_num_groups=8)
TINY_VAE_KW = dict(block_out_channels=(8, 16), latent_channels=4, layers_per_block=1, norm_num_groups=4)
TINY_TEXT_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                    max_length=16)


def _jostled(init, cfg, seed):
    """A tree with the keys and (JAX-layout) shapes of ``init(key, cfg)``
    (from ``jax.eval_shape``: the JAX initialisers would compile every
    random draw), filled with numpy: weights U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), norm scales 1 + N(0, 0.02^2), biases N(0, 0.02^2), so
    every leaf is exercised."""
    rng = np.random.default_rng(seed)

    def fill(name, shape):
        if len(shape) == 1:
            return (float(name == "weight") + 0.02 * rng.standard_normal(shape)).astype(np.float32)
        fan = int(np.prod(shape[:-1])) if len(shape) == 4 else shape[-1]
        return (rng.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else fill(k, v.shape) for k, v in tree.items()}

    return walk(jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg)))


@functools.lru_cache(maxsize=None)
def _unet():
    jc, pc = JD.UNetConfig(**TINY_UNET_KW), PD.UNetConfig(**TINY_UNET_KW)
    jp = _jostled(JD.init_unet_params, jc, 0)
    return jc, pc, jax.tree.map(jnp.asarray, jp), network_params_from_jax(jp, "cpu")


@functools.lru_cache(maxsize=None)
def _vae():
    jc, pc = JD.VAEConfig(**TINY_VAE_KW), PD.VAEConfig(**TINY_VAE_KW)
    jp = _jostled(JD.init_vae_params, jc, 2)
    return jc, pc, jax.tree.map(jnp.asarray, jp), network_params_from_jax(jp, "cpu")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_shapes(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: tuple(v.shape)})
    return out


@pytest.mark.parametrize("t, noise_level, ctx_scale", [(10, 20, 1.0), (500, 300, 2.0)])
def test_unet_matches_jax(t, noise_level, ctx_scale):
    jc, pc, jp, pp = _unet()
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, 16, 16, 7)).astype(np.float32)
    ctx = (ctx_scale * rng.standard_normal((2, 5, 24))).astype(np.float32)
    ref = np.asarray(jax.jit(JD.unet_apply, static_argnums=1)(
        jp, jc, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), class_labels=jnp.asarray(noise_level)))
    got = _nhwc(PD.unet_apply(pp, pc, _nchw(x), t, torch.from_numpy(ctx), class_labels=noise_level))
    assert got.shape == (2, 16, 16, 4) and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_unet_takes_latents_off_the_downsampling_grid():
    """A latent side that the UNet's downsampling does not halve evenly (15
    -> 8 here; the x4 upscaler's 100^2 latents go 100 -> 50 -> 25 -> 13):
    the JAX package's UNet stops with a shape error at the skip
    concatenation; the port resizes to the skip's size with a nearest
    ``F.interpolate(size=...)``, as diffusers does (``forward_upsample_size``).
    On even sides the two agree (above)."""
    jc, pc, jp, pp = _unet()
    x = np.random.default_rng(9).standard_normal((1, 15, 15, 7)).astype(np.float32)
    ctx = np.random.default_rng(10).standard_normal((1, 5, 24)).astype(np.float32)
    with pytest.raises(TypeError):
        JD.unet_apply(jp, jc, jnp.asarray(x), jnp.asarray(3), jnp.asarray(ctx), class_labels=jnp.asarray(20))
    got = PD.unet_apply(pp, pc, _nchw(x), 3, torch.from_numpy(ctx), class_labels=20)
    assert got.shape == (1, 4, 15, 15) and torch.isfinite(got).all()
    centre = torch.zeros((1, 1, 3, 3))
    centre[0, 0, 1, 1] = 1.0  # the 3x3 conv as the identity: the resize alone
    up = PD._upsample({"conv": {"weight": centre, "bias": torch.zeros(1)}},
                      torch.arange(16.0).reshape(1, 1, 4, 4), (7, 7))
    assert up[0, 0, :, 0].tolist() == [0.0, 0.0, 4.0, 4.0, 8.0, 8.0, 12.0]  # row floor(o * 4 / 7)


def test_vae_encode_decode_match_jax():
    jc, pc, jp, pp = _vae()
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    ze = np.asarray(jax.jit(JD.vae_encode, static_argnums=1)(jp, jc, jnp.asarray(img)))
    pe = _nhwc(PD.vae_encode(pp, pc, _nchw(img)))
    assert pe.shape == (1, 16, 16, 4)
    np.testing.assert_allclose(pe, ze, rtol=0, atol=1e-6)
    z = (0.1 * rng.standard_normal((1, 16, 16, 4))).astype(np.float32)
    jd = np.asarray(jax.jit(JD.vae_decode, static_argnums=1)(jp, jc, jnp.asarray(z)))
    pd = _nhwc(PD.vae_decode(pp, pc, _nchw(z)))
    assert pd.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(pd, jd, rtol=0, atol=1e-5)
    # a posterior sample differs from its mode, and is seeded
    g = torch.Generator().manual_seed(0)
    zs = PD.vae_encode(pp, pc, _nchw(img), generator=g)
    assert float((zs - _nchw(pe)).abs().max()) > 0
    assert torch.equal(zs, PD.vae_encode(pp, pc, _nchw(img), generator=torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("which", ["unet", "vae", "x4_vae"])
def test_init_shapes_match_jax(which):
    """The port's random trees have JAX's keys and shapes (convs OIHW), at
    the tiny shapes and at the published x4 upscaler VAE's (55.3 M
    parameters; JAX's through ``eval_shape``). The published UNet (468 M)
    is built on the card by chip_smoke.py."""
    if which == "unet":
        jc, pc = JD.UNetConfig(**TINY_UNET_KW), PD.UNetConfig(**TINY_UNET_KW)
        j = jax.eval_shape(lambda: JD.init_unet_params(jax.random.PRNGKey(0), jc))
        p = PD.init_unet_params(pc, device="cpu")
    else:
        jc, pc = ((JD.VAEConfig(**TINY_VAE_KW), PD.VAEConfig(**TINY_VAE_KW)) if which == "vae"
                  else (JD.SD_X4_UPSCALER_VAE, PD.SD_X4_UPSCALER_VAE))
        j = jax.eval_shape(lambda: JD.init_vae_params(jax.random.PRNGKey(0), jc))
        p = PD.init_vae_params(pc, device="cpu")
    jshape = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                jshape[prefix + k] = (v.shape[3], v.shape[2], v.shape[0], v.shape[1]) if len(v.shape) == 4 \
                    else tuple(v.shape)

    walk(j)
    assert _shapes(p) == jshape
    if which == "x4_vae":
        assert sum(int(np.prod(s)) for s in jshape.values()) == 55_325_927


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_configs_and_from_json_match_jax(tmp_path):
    assert dataclasses_equal(JD.SD_X4_UPSCALER_UNET, PD.SD_X4_UPSCALER_UNET)
    assert dataclasses_equal(JD.SD_X4_UPSCALER_VAE, PD.SD_X4_UPSCALER_VAE)
    assert dataclasses_equal(JX.TextConfig(), PX.TextConfig())
    u = {"in_channels": 7, "out_channels": 4, "block_out_channels": [256, 512, 512, 1024],
         "down_block_types": ["DownBlock2D"] + ["CrossAttnDownBlock2D"] * 3,
         "up_block_types": ["CrossAttnUpBlock2D"] * 3 + ["UpBlock2D"],
         "layers_per_block": 2, "cross_attention_dim": 1024, "attention_head_dim": 8,
         "use_linear_projection": True, "class_embed_type": "timestep"}
    v = {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
         "block_out_channels": [128, 256, 512], "scaling_factor": 0.08333}
    t = {"vocab_size": 49408, "hidden_size": 1024, "num_hidden_layers": 24,
         "num_attention_heads": 16, "intermediate_size": 4096, "hidden_act": "gelu"}
    for name, cfg in (("u", u), ("v", v), ("t", t)):
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump(cfg, f)
    assert dataclasses_equal(JD.unet_config_from_json(str(tmp_path / "u.json")),
                             PD.unet_config_from_json(str(tmp_path / "u.json")))
    assert dataclasses_equal(JD.vae_config_from_json(str(tmp_path / "v.json")),
                             PD.vae_config_from_json(str(tmp_path / "v.json")))
    assert dataclasses_equal(JX.TextConfig.from_json(str(tmp_path / "t.json")),
                             PX.TextConfig.from_json(str(tmp_path / "t.json")))
    assert PX.TextConfig.from_json(str(tmp_path / "t.json")).num_layers == 23


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _flat_oihw(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flat_oihw(v, name))
        else:
            a = np.asarray(v)
            flat[name] = np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a)
    return flat


def test_safetensors_reader(tmp_path):
    """The port's reader on files written here: a UNet state dict written
    by the safetensors package loads to the carried tree exactly, and gives
    the JAX loader's UNet output; bf16 and f16 tensors read as written; a
    hand-written file with an unknown dtype or a short buffer is refused."""
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    jc, pc, jp, pp = _unet()
    path = str(tmp_path / "unet.safetensors")
    save_file(_flat_oihw(jax.tree.map(np.asarray, jp)), path)
    loaded = PD.load_safetensors_params(path, device="cpu")
    assert _shapes(loaded) == _shapes(pp)
    flat_p = {k: v.numpy() for k, v in _flat(pp).items()}
    read = PD.read_safetensors(path)
    assert set(read) == set(flat_p)
    for k, a in read.items():
        np.testing.assert_array_equal(a.numpy(), flat_p[k], err_msg=k)
    x = np.random.default_rng(0).standard_normal((1, 8, 8, 7)).astype(np.float32)
    ctx = np.random.default_rng(1).standard_normal((1, 5, 24)).astype(np.float32)
    ref = np.asarray(jax.jit(JD.unet_apply, static_argnums=1)(
        JD.load_safetensors_params(path), jc, jnp.asarray(x), jnp.asarray(3), jnp.asarray(ctx),
        jnp.asarray(20)))
    got = _nhwc(PD.unet_apply(loaded, pc, _nchw(x), 3, torch.from_numpy(ctx), 20))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)

    mixed = {"a.b": torch.randn(3, 4).to(torch.bfloat16), "c": torch.randn(5).half(),
             "d": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    save_torch(mixed, str(tmp_path / "mixed.safetensors"))
    back = PD.read_safetensors(str(tmp_path / "mixed.safetensors"))
    for k, v in mixed.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    tree = PD.load_safetensors_params(str(tmp_path / "mixed.safetensors"), device="cpu")
    assert tree["a"]["b"].dtype == torch.float32 and torch.equal(tree["a"]["b"], mixed["a.b"].float())

    def write(header, payload):
        h = json.dumps(header).encode()
        p = str(tmp_path / "hand.safetensors")
        with open(p, "wb") as f:
            f.write(len(h).to_bytes(8, "little") + h + payload)
        return p

    ok = write({"__metadata__": {"format": "pt"}, "w": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}},
               np.array([1.5, -2.0], np.float32).tobytes())
    assert PD.read_safetensors(ok)["w"].tolist() == [1.5, -2.0]
    with pytest.raises(ValueError, match="F8_E4M3"):
        PD.read_safetensors(write({"w": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}}, b"\0\0"))
    with pytest.raises(ValueError, match="need 12"):
        PD.read_safetensors(write({"w": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, b"\0" * 8))


def test_text_encoder_matches_jax():
    jc, pc = JX.TextConfig(**TINY_TEXT_KW), PX.TextConfig(**TINY_TEXT_KW)
    jp = jax.tree.map(jnp.asarray, _jostled(JX.init_text_params, jc, 5))
    pp = network_params_from_jax(jp, "cpu")
    toks = np.random.default_rng(0).integers(0, 64, (2, 16)).astype(np.int32)
    encode_j = jax.jit(JX.text_encode, static_argnums=1)
    ref = np.asarray(encode_j(jp, jc, jnp.asarray(toks)))
    got = PX.text_encode(pp, pc, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    quick_j = JX.TextConfig(**TINY_TEXT_KW, hidden_act="quick_gelu")
    quick_p = PX.TextConfig(**TINY_TEXT_KW, hidden_act="quick_gelu")
    np.testing.assert_allclose(PX.text_encode(pp, quick_p, torch.from_numpy(toks)).numpy(),
                               np.asarray(encode_j(jp, quick_j, jnp.asarray(toks))), rtol=0, atol=2e-5)
    # causal: a later token leaves earlier positions as they were
    toks2 = toks.copy()
    toks2[:, 10] = (toks2[:, 10] + 1) % 64
    got2 = PX.text_encode(pp, pc, torch.from_numpy(toks2)).numpy()
    np.testing.assert_array_equal(got2[:, :10], got[:, :10])
    assert np.abs(got2[:, 10:] - got[:, 10:]).max() > 1e-6
    p0 = PX.init_text_params(pc, device="cpu")
    assert _shapes(p0) == _shapes(jp)


def _write_tokenizer(tmp_path):
    letters = list("abcdefghijklmnopqrstuvwxyz ")
    vocab = {}
    for ch in letters:
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    for tok in ["he", "ll", "llo</w>", "hello</w>"]:
        vocab[tok] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    vp, mp = str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")
    with open(vp, "w") as f:
        json.dump(vocab, f)
    with open(mp, "w") as f:
        f.write("#version: 0.2\nh e\nl l\nll o</w>\nhe llo</w>\n")
    return vp, mp


def test_tokenizer_and_prompt_cache_match_jax(tmp_path):
    """Equal ids on prompts with merges, unknown bytes, digits, punctuation
    and truncation; the prompt cache is one file: the port reads the npz
    the JAX package wrote (and the JAX package the port's)."""
    vp, mp = _write_tokenizer(tmp_path)
    jt, pt = JX.CLIPTokenizer(vp, mp, max_length=16), PX.CLIPTokenizer(vp, mp, max_length=16)
    for p in ("hello", "zq", "hello 42 world!!", "it's_a  test\t", "emoji \U0001f600 " * 5):
        np.testing.assert_array_equal(pt(p), jt(p), err_msg=p)
    jc, pc = JX.TextConfig(**TINY_TEXT_KW), PX.TextConfig(**TINY_TEXT_KW)
    jparams = jax.tree.map(jnp.asarray, _jostled(JX.init_text_params, jc, 1))
    pparams = network_params_from_jax(jparams, "cpu")
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    jc1, ju1 = JX.PromptProcessor("hello", "zq", params=jparams, cfg=jc, tokenizer=jt, cache_dir=jdir)()
    pp = PX.PromptProcessor("hello", "zq", params=pparams, cfg=pc, tokenizer=pt, cache_dir=pdir, device="cpu")
    pc1, pu1 = pp()
    assert os.listdir(jdir) == os.listdir(pdir) and os.listdir(pdir)[0].startswith("prompt_")
    np.testing.assert_allclose(pc1.numpy(), np.asarray(jc1), rtol=0, atol=2e-5)
    np.testing.assert_allclose(pu1.numpy(), np.asarray(ju1), rtol=0, atol=2e-5)
    # each package reads the other's cache file
    cross_p = PX.PromptProcessor("hello", "zq", params=pparams, cfg=pc, tokenizer=pt, cache_dir=jdir, device="cpu")
    np.testing.assert_array_equal(cross_p()[0].numpy(), np.asarray(jc1))
    cross_j = JX.PromptProcessor("hello", "zq", params=jparams, cfg=jc, tokenizer=jt, cache_dir=pdir)
    np.testing.assert_array_equal(np.asarray(cross_j()[0]), pc1.numpy())
    assert PX.PromptProcessor(embeds=(pc1, pu1), device="cpu")()[0] is pc1
    with pytest.raises(NotImplementedError, match="no weights"):
        PX.PromptProcessor("x", device="cpu")()


class _Normals:
    """Hands out numpy draws in order: NHWC to jax.random.normal, the same
    values NCHW to the port's ``_randn``."""

    def __init__(self, arrays):
        self.j, self.p = list(arrays), list(arrays)

    def jax(self, key, shape=(), dtype=jnp.float32):
        a = self.j.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a, dtype)

    def port(self, shape, generator, device):
        a = self.p.pop(0)
        assert (a.shape[0], a.shape[3], a.shape[1], a.shape[2]) == tuple(shape), (a.shape, shape)
        return _nchw(a).to(device)


@pytest.mark.parametrize("guidance_scale, guidance_scale_sr", [(7.5, -1.0), (7.5, 3.0)])
def test_generate_sr_through_unet_and_vae_matches_jax(guidance_scale, guidance_scale_sr):
    """The full SDEdit loop: the HR render VAE-encoded, the LR condition
    noised, 4 DDIM steps through the UNet with text (or image) CFG and the
    noise-level class, the VAE decode; ``ignore_t`` 600 makes the first
    step re-noise only. Every normal draw is handed to both packages."""
    jc, pc, jup, pup = _unet()
    jvc, pvc, jvp, pvp = _vae()
    rng = np.random.default_rng(7)
    ctx_c = rng.standard_normal((1, 5, 24)).astype(np.float32)
    ctx_u = np.zeros((1, 5, 24), np.float32)
    lr = rng.random((1, 8, 8, 3)).astype(np.float32)
    hr = rng.random((1, 32, 32, 3)).astype(np.float32)
    g_kw = dict(num_inference_steps=4, guidance_scale=guidance_scale, guidance_scale_sr=guidance_scale_sr,
                noise_level=20)
    jg = JG.UpscalerGuidance(JG.GuidanceConfig(**g_kw),
                             JD.make_unet_denoiser(jup, jc, jnp.asarray(ctx_c), jnp.asarray(ctx_u)),
                             encode=lambda x: JD.vae_encode(jvp, jvc, 2 * x - 1),
                             decode=lambda z: 0.5 * (JD.vae_decode(jvp, jvc, z) + 1))
    pg = PG.UpscalerGuidance(PG.GuidanceConfig(**g_kw),
                             PD.make_unet_denoiser(pup, pc, torch.from_numpy(ctx_c), torch.from_numpy(ctx_u)),
                             encode=lambda x: PD.vae_encode(pvp, pvc, 2 * x - 1),
                             decode=lambda z: 0.5 * (PD.vae_decode(pvp, pvc, z) + 1))
    # the LR condition's noise, the initial latents, [the image-CFG
    # condition's noise], the one re-noise above ignore_t (t = 751)
    shapes = ([(1, 16, 16, 3), (1, 16, 16, 4)] + ([(1, 16, 16, 3)] if guidance_scale_sr > 1 else [])
              + [(1, 16, 16, 4)])
    draws = _Normals([rng.standard_normal(s).astype(np.float32) for s in shapes])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", draws.jax)
        mp.setattr(PG, "_randn", draws.port)
        ref = np.asarray(jg.generate_sr(jax.random.PRNGKey(0), jnp.asarray(lr), jnp.asarray(hr), ignore_t=600))
        got = _nhwc(pg.generate_sr(_nchw(lr), _nchw(hr), ignore_t=600))
    assert not draws.j and not draws.p
    assert got.shape == (1, 32, 32, 3) and 0 <= got.min() and got.max() <= 1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
