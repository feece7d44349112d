"""CLIP text encoder and prompt processor (port of ``trinerflet_tpu/sr/text.py``).

The text tower is the standard CLIPTextModel transformer (token and
position embeddings, pre-LN blocks with causal self-attention, a final
LN), its parameters keyed by the transformers state-dict names, so a
``text_encoder/model.safetensors`` of an SD checkpoint loads with
``sr.diffusion.load_safetensors_params``. A byte-level BPE tokenizer reads
the checkpoint's own ``vocab.json`` / ``merges.txt`` (the JAX package's,
line for line). ``PromptProcessor`` embeds (prompt, negative prompt) once
and caches them in ``prompt_{hash}.npz``, the same file in both packages.
Without weights, ``init_text_params`` and ``PromptProcessor(tokens=...)``
keep the path testable.

The activations are the JAX package's: exact GELU, or quick GELU
(x sigmoid(1.702 x)) for SD1.x's CLIP-L.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import hashlib
import html
import json
import math
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device

__all__ = [
    "TextConfig", "init_text_params", "text_encode",
    "CLIPTokenizer", "PromptProcessor",
]


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024          # OpenCLIP-H (SD2.x family)
    num_layers: int = 23             # penultimate layer of a 24-layer tower
    num_heads: int = 16
    intermediate_size: int = 4096
    max_length: int = 77
    hidden_act: str = "gelu"         # SD1.x CLIP-L uses "quick_gelu"

    @classmethod
    def from_json(cls, path: str) -> "TextConfig":
        """From a transformers ``config.json``. SD2-family checkpoints ship
        the penultimate-layer trim already (23 layers, all run); only an
        untrimmed 24-layer tower is trimmed here."""
        with open(path) as f:
            c = json.load(f)
        layers = c["num_hidden_layers"]
        return cls(
            vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
            num_layers=layers - 1 if layers >= 24 else layers,
            num_heads=c["num_attention_heads"],
            intermediate_size=c["intermediate_size"],
            max_length=c.get("max_position_embeddings", 77),
            hidden_act=c.get("hidden_act", "gelu"),
        )


def _ln(p, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], p["weight"], p["bias"], eps)


def _lin(p, x):
    return F.linear(x, p["weight"], p["bias"])


def _act(name, x):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


def text_encode(params: Dict, cfg: TextConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, L) integer -> hidden states (B, L, D)."""
    tm = params["text_model"]
    B, L = tokens.shape
    x = tm["embeddings"]["token_embedding"]["weight"][tokens.long()]
    x = x + tm["embeddings"]["position_embedding"]["weight"][:L]
    H = cfg.num_heads
    d = cfg.hidden_size // H
    for i in range(cfg.num_layers):
        lp = tm["encoder"]["layers"][str(i)]
        h = _ln(lp["layer_norm1"], x)
        a = lp["self_attn"]
        q, k, v = (_lin(a[n], h).reshape(B, L, H, d).transpose(1, 2)
                   for n in ("q_proj", "k_proj", "v_proj"))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + _lin(a["out_proj"], o.transpose(1, 2).reshape(B, L, -1))
        h = _ln(lp["layer_norm2"], x)
        x = x + _lin(lp["mlp"]["fc2"], _act(cfg.hidden_act, _lin(lp["mlp"]["fc1"], h)))
    return _ln(tm["final_layer_norm"], x)


def init_text_params(cfg: TextConfig, generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> Dict:
    """Seeded random parameters of ``cfg``'s shapes on ``device`` (``cuda``
    by default): linear weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)), token
    embeddings N(0, 0.02^2), positions N(0, 0.01^2)."""
    gen = generator or torch.Generator().manual_seed(0)
    device = resolve_device(device)

    def lin(ci, co):
        s = 1.0 / math.sqrt(ci)
        u = torch.rand((co, ci), generator=gen)
        return {"weight": ((2.0 * u - 1.0) * s).to(device), "bias": torch.zeros((co,), device=device)}

    def ln(D):
        return {"weight": torch.ones((D,), device=device), "bias": torch.zeros((D,), device=device)}

    D = cfg.hidden_size
    layers = {}
    for i in range(cfg.num_layers):
        layers[str(i)] = {
            "layer_norm1": ln(D),
            "self_attn": {n: lin(D, D) for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm2": ln(D),
            "mlp": {"fc1": lin(D, cfg.intermediate_size), "fc2": lin(cfg.intermediate_size, D)},
        }
    tok = 0.02 * torch.randn((cfg.vocab_size, D), generator=gen)
    pos = 0.01 * torch.randn((cfg.max_length, D), generator=gen)
    return {"text_model": {
        "embeddings": {"token_embedding": {"weight": tok.to(device)},
                       "position_embedding": {"weight": pos.to(device)}},
        "encoder": {"layers": layers},
        "final_layer_norm": ln(D),
    }}


# ---------------------------------------------------------------------------
# Tokenizer (CLIP byte-level BPE; loads the checkpoint's vocab/merges)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP byte-level fallback map: every byte gets a printable unicode
    char that exists in the vocab, so no input can tokenize to <unk>."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPTokenizer:
    # CLIP's BPE regex ('s|'t|...|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+) in
    # stdlib-re form: letter runs, SINGLE digits, greedy non-alnum runs
    # (underscore counts as punctuation, not a word char).
    PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|\d|(?:[^\w\s]|_)+",
        re.IGNORECASE,
    )

    def __init__(self, vocab_path: str, merges_path: str, max_length: int = 77):
        with open(vocab_path) as f:
            self.vocab: Dict[str, int] = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            lines = f.read().split("\n")
        lines = [l for l in lines if l and not l.startswith("#version")]
        self.ranks = {tuple(l.split()): i for i, l in enumerate(lines)}
        self.max_length = max_length
        self.bos = self.vocab.get("<|startoftext|>", 49406)
        self.eos = self.vocab.get("<|endoftext|>", 49407)
        self.byte_encoder = _bytes_to_unicode()

    def _bpe(self, word: str) -> List[str]:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(self.ranks.get((a, b), 1 << 30), i)
                     for i, (a, b) in enumerate(zip(parts, parts[1:]))]
            rank, i = min(pairs)
            if rank == 1 << 30:
                break
            parts = parts[:i] + [parts[i] + parts[i + 1]] + parts[i + 2:]
        return parts

    def __call__(self, text: str) -> np.ndarray:
        text = html.unescape(html.unescape(text.strip()))
        text = re.sub(r"\s+", " ", text).lower()
        ids = [self.bos]
        for tok in self.PAT.findall(text):
            if tok in ("<|startoftext|>", "<|endoftext|>"):
                ids.append(self.bos if tok == "<|startoftext|>" else self.eos)
                continue
            # byte-level fallback: every byte maps to a vocab char, so
            # arbitrary input (emoji, CJK, ...) never produces <unk>
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(tok):
                ids.append(self.vocab.get(piece, self.eos))
            if len(ids) >= self.max_length - 1:
                break
        ids = ids[: self.max_length - 1] + [self.eos]
        ids += [self.eos] * (self.max_length - len(ids))
        return np.asarray(ids, np.int32)[None]


# ---------------------------------------------------------------------------
# Prompt processor
# ---------------------------------------------------------------------------

class PromptProcessor:
    """Embed (prompt, negative prompt) once and cache them in
    ``cache_dir/prompt_{hash}.npz`` (the JAX package's file name and keys).

    Give either (params, cfg, tokenizer) for the real path, or ``embeds=``
    precomputed (cond, uncond) embeddings."""

    def __init__(self, prompt: str = "", negative_prompt: str = "",
                 params: Optional[Dict] = None, cfg: Optional[TextConfig] = None,
                 tokenizer: Optional[CLIPTokenizer] = None,
                 cache_dir: Optional[str] = None,
                 embeds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 device: DeviceLike = None):
        self.prompt = prompt
        self.negative_prompt = negative_prompt
        self._embeds = embeds
        self.params, self.cfg, self.tokenizer = params, cfg, tokenizer
        self.cache_dir = cache_dir
        self.device = resolve_device(device)

    @property
    def available(self) -> bool:
        return self._embeds is not None or (self.params is not None and self.tokenizer is not None)

    def _cache_path(self) -> Optional[str]:
        if not self.cache_dir:
            return None
        h = hashlib.sha1(f"{self.prompt}\x00{self.negative_prompt}".encode()).hexdigest()[:16]
        return os.path.join(self.cache_dir, f"prompt_{h}.npz")

    def __call__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cond_embeds (1, L, D), uncond_embeds (1, L, D)) on the device."""
        if self._embeds is not None:
            return self._embeds
        if not self.available:
            raise NotImplementedError(
                "PromptProcessor needs a CLIP text encoder checkpoint (params + tokenizer "
                "files) or precomputed embeds=; no weights are in the repository")
        cp = self._cache_path()
        if cp and os.path.exists(cp):
            z = np.load(cp)
            return (torch.from_numpy(z["cond"]).to(self.device),
                    torch.from_numpy(z["uncond"]).to(self.device))
        with torch.no_grad():
            cond, uncond = (text_encode(self.params, self.cfg,
                                        torch.from_numpy(self.tokenizer(p)).to(self.device))
                            for p in (self.prompt, self.negative_prompt))
        if cp:
            os.makedirs(self.cache_dir, exist_ok=True)
            np.savez(cp, cond=cond.cpu().numpy(), uncond=uncond.cpu().numpy())
        return cond, uncond
