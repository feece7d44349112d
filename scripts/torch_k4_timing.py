"""K4, one IDWT level, forward and adjoint, on the card: each level of
``bench.py``'s ladder (3 planes x 16 channels, bf16, bior6.8: 72^2 -> 128^2,
136^2 -> 256^2, 264^2 -> 512^2, 520^2 -> 1024^2) and the variants' zoom-in
crop (a 520^2 window of a larger plane -> 1024^2).

    python scripts/torch_k4_timing.py [--profile] [--sass] [--save PATH] [--compare PATH]

Builds ``idwt``, holds each level's forward and adjoint to their plain
versions (bf16: 2^-6 of the largest value, as the kernel tests), and prints
one row per level: the kernels' device times (median of 20 calls, each behind
a device sleep, warm L2, as ``chip_smoke.py`` times), launches per call, the
bound (bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s, whichever is
larger), the plain versions' times and one PyTorch call computing the same
level (a grouped ``F.conv_transpose2d``, and a strided grouped ``F.conv2d``
for the adjoint). ``--profile`` prints the device time of each CUDA kernel
over one ladder forward and adjoint under ``torch.profiler``, ``--sass``
prints each bf16 K4 kernel's registers, stack frame and instructions by
opcode (``cuobjdump`` of the built library), ``--save``
writes every output to a file and ``--compare`` reports whether each output
equals the saved one bit for bit (run from another checkout's root, it times
that checkout's kernel). The tile sizes are constants of
``kernels/csrc/idwt.cu``. Prints the card's name and power limit first and
needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, ".")
from trinerflet_tpu_torch import kernels  # noqa: E402
from trinerflet_tpu_torch.kernels import _build  # noqa: E402
from trinerflet_tpu_torch.ops import wavelets as W  # noqa: E402

NAME = "bior6.8"
P_SHAPE = (3, 16)
LEVELS = (72, 136, 264, 520)
CROP = (520, 252)  # (window, offset in a 1024^2 plane)
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call: a device sleep longer than the call's
    host time is queued ahead of the start event, so the events bracket the
    call's kernels and not the host's work of issuing them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cycles = int(2.0 * (time.perf_counter() - t0) * 2.0e9) + 100_000
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def level_inputs(n: int, crop_off: int, dev):
    g = torch.Generator().manual_seed(n)
    if crop_off:
        yl = torch.randn(P_SHAPE + (n + 2 * crop_off,) * 2, generator=g)
        yl = yl.to(dev, torch.bfloat16)[:, :, crop_off : crop_off + n, crop_off : crop_off + n]
    else:
        yl = torch.randn(P_SHAPE + (n, n), generator=g).to(dev, torch.bfloat16)
    yh = (0.3 * torch.randn(P_SHAPE + (3, n, n), generator=g)).to(dev, torch.bfloat16)
    return yl, yh


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _bound(nbytes: int, flops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def _library(yl, yh, G):
    """The level as one grouped transposed convolution over the four bands'
    outer-product filters, and its adjoint as one strided grouped convolution
    of the padded cotangent (full-length outputs, cropped outside the timing)."""
    g0, g1 = W.synthesis_taps(NAME, torch.bfloat16)
    L, pl = len(g0), W.synthesis_pads(NAME)[0]
    P, n = yl.shape[0] * yl.shape[1], yl.shape[-1]
    Ho = G.shape[-1]
    w2 = torch.stack([torch.outer(torch.tensor(a), torch.tensor(c)) for a, c in
                      ((g0, g0), (g0, g1), (g1, g0), (g1, g1))])  # yl, lh, hl, hh
    wt = w2.repeat(P, 1, 1).reshape(4 * P, 1, L, L).to(yl.device, torch.bfloat16)
    inp = torch.stack([yl.reshape(P, n, n), yh[:, :, 1].reshape(P, n, n),
                       yh[:, :, 0].reshape(P, n, n), yh[:, :, 2].reshape(P, n, n)], 1)
    inp = inp.reshape(1, 4 * P, n, n).contiguous()
    st = L - 1 - pl
    Gp = F.pad(G.reshape(1, P, Ho, Ho), (st, 2 * n + L - 2 - st - Ho) * 2)
    return (lambda: F.conv_transpose2d(inp, wt, stride=2, groups=P),
            lambda: F.conv2d(Gp, wt, stride=2, groups=P))


def run_level(n: int, crop_off: int, dev, saved, out, library: bool):
    yl, yh = level_inputs(n, crop_off, dev)
    L = len(W.synthesis_taps(NAME, torch.bfloat16)[0])
    n0 = kernels.launches["idwt"]
    got = W.idwt2d(yl, yh, NAME)
    fwd_launches = kernels.launches["idwt"] - n0
    ref = W.idwt2d_plain(yl, yh, NAME)
    err = (got.float() - ref.float()).abs().max().item()
    if err > 2.0**-6 * ref.float().abs().max().item():
        raise RuntimeError(f"K4 {n}: max|err| {err} over 2^-6 of the level's largest value")
    G = torch.randn(got.shape, generator=torch.Generator().manual_seed(n + 1)).to(dev, torch.bfloat16)
    n0 = kernels.launches["idwt_adjoint"]
    adj = W._idwt2d_adjoint_cuda(G, NAME)
    adj_launches = kernels.launches["idwt_adjoint"] - n0
    adj_err = max(_rel(a, b) for a, b in zip(adj, W.idwt2d_adjoint_plain(G, NAME)))
    if adj_err > 2.0**-6:
        raise RuntimeError(f"K4 adjoint {n}: rel err {adj_err} > 2^-6")
    key = f"{n}" + (f"_crop{crop_off}" if crop_off else "")
    out[key] = (got.cpu(), adj[0].cpu(), adj[1].cpu())
    same = None
    if saved is not None:
        same = all(torch.equal(a, b) for a, b in zip(out[key], saved[key]))
    P, Ho = yl.shape[0] * yl.shape[1], got.shape[-1]
    flops = P * n * Ho * 4 * (L // 2) * 2 + P * Ho * Ho * 2 * (L // 2) * 2
    nb = sum(t.numel() * t.element_size() for t in (yl, yh, got))
    row = dict(level=f"{n}->{Ho}" + (" (zoom-in crop)" if crop_off else ""),
               fwd_ms=time_ms(lambda: W.idwt2d(yl, yh, NAME)),
               adj_ms=time_ms(lambda: W._idwt2d_adjoint_cuda(G, NAME)),
               fwd_launches=fwd_launches, adj_launches=adj_launches, bound_ms=_bound(nb, flops),
               fwd_err=err, adj_rel_err=adj_err, bit_equal_saved=same)
    if library:
        lib_f, lib_a = _library(yl, yh, G)
        row.update(plain_fwd_ms=time_ms(lambda: W.idwt2d_plain(yl, yh, NAME), iters=5),
                   plain_adj_ms=time_ms(lambda: W.idwt2d_adjoint_plain(G, NAME), iters=5),
                   library_fwd_ms=time_ms(lib_f), library_adj_ms=time_ms(lib_a))
    return row


def profile_ladder(dev) -> None:
    """Device time per CUDA kernel name over 5 ladder forwards and adjoints."""
    from torch.profiler import ProfilerActivity, profile
    inputs = [level_inputs(n, 0, dev) for n in LEVELS]
    cts = [torch.randn(W.idwt2d(yl, yh, NAME).shape, device=dev).to(torch.bfloat16) for yl, yh in inputs]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            for (yl, yh), G in zip(inputs, cts):
                W.idwt2d(yl, yh, NAME)
                W._idwt2d_adjoint_cuda(G, NAME)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if dt > 0:
            print(f"profile {e.key[:70]}: {e.count} calls, {dt / 1e3 / 5:.4f} ms per ladder")


SASS_OPS = ("FFMA", "LDS", "STS", "LDG", "STG", "LDL", "STL", "LDC", "IMAD", "IADD3", "ISETP", "BRA")


def sass_summary() -> None:
    """Registers, stack frame and instruction counts of every bf16 kernel in
    the built ``idwt`` library, from ``cuobjdump -res-usage`` and ``-sass``."""
    lib = str(_build._target("idwt"))
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    run = lambda flag: subprocess.run([tool, flag, lib], capture_output=True,  # noqa: E731
                                      text=True, check=True).stdout
    usage = dict(re.findall(r"Function (\S+):\s*\n\s*(REG:\d+ STACK:\d+)", run("-res-usage")))
    ops, name = {}, None
    for line in run("-sass").splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            ops[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if m and name:
            ops[name][m.group(1)] += 1
    for f, c in ops.items():
        if "bfloat16" in f:
            print(f"sass {f}: {usage.get(f, '?')} total {sum(c.values())} "
                  + " ".join(f"{k}={c[k]}" for k in SASS_OPS))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all(["idwt"])
    print(f"built idwt in {time.perf_counter() - t0:.1f} s", flush=True)
    saved = torch.load(args.compare) if args.compare else None
    out = {}
    cases = [(n, 0) for n in LEVELS] + [CROP]
    rows = [run_level(n, off, dev, saved, out, library=True) for n, off in cases]
    keys = ("fwd_ms", "adj_ms", "bound_ms", "plain_fwd_ms", "plain_adj_ms", "library_fwd_ms",
            "library_adj_ms")
    for r in rows:
        print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in r.items()))
    ladder = rows[: len(LEVELS)]
    print("ladder " + " ".join(f"{k}={sum(r[k] for r in ladder):.4f}" for k in keys)
          + f" fwd_launches={sum(r['fwd_launches'] for r in ladder)}"
          + f" adj_launches={sum(r['adj_launches'] for r in ladder)}")
    if args.profile:
        profile_ladder(dev)
    if args.sass:
        sass_summary()
    if args.save:
        torch.save(out, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
