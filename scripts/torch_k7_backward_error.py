"""K7 backward's summation error on the card: the kernel (float32 atomics)
and the plain version (``index_add_``, also atomic on CUDA) each against a
float64 accumulation of the same float32 terms, on the inputs of
``tests/test_torch_kernels.py::test_grid_encode_backward_kernel_matches_plain``
(50,000 points, 3,000 of them on one cell), several repeats per case.

    python scripts/torch_k7_backward_error.py

Prints per case and repeat: the largest error of each as a fraction of the
float-summation bound n (eps sum|term| + tiny) (within 1 passes), its largest
absolute error against float64, and the kernel-vs-plain difference relative
to the largest gradient (the test's former measure, bound 1e-5). Needs a
CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

import torch

sys.path.insert(0, ".")
from tests.test_torch_kernels import K7_CASES, _k7_inputs  # noqa: E402
from trinerflet_tpu_torch.models import gridencoder as GE  # noqa: E402

REPEATS = 3


def _abs_err(grads, ct, x, cfg, bound):
    """The largest |grad - float64 sum| over the levels."""
    out = 0.0
    C = cfg.level_dim
    for l in range(cfg.num_levels):
        w, rows = GE._corners_plain(x, cfg, bound, l)
        exact = torch.zeros((cfg.level_size(l), C), dtype=torch.float64, device=ct.device)
        for k in range(w.shape[0]):
            exact.index_add_(0, rows[k], (w[k][:, None] * ct[:, l * C:(l + 1) * C]).double())
        out = max(out, (grads[l].double() - exact).abs().max().item())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    for case in sorted(K7_CASES):
        cfg = GE.GridEncoderConfig(**K7_CASES[case])
        x, _ = _k7_inputs(dev, cfg, 1.5, 50000, 11)
        x[:3000] = 0.01
        ct = torch.randn((50000, cfg.output_dim), generator=torch.Generator().manual_seed(12)).to(dev)
        ct[5000:9000] = 0.0
        for r in range(REPEATS):
            got = GE._grid_encode_backward_cuda(ct, x, cfg, 1.5)
            ref = GE.grid_encode_backward_plain(ct, x, cfg, 1.5)
            torch.cuda.synchronize()
            fk = max(GE.grid_encode_backward_error(got, ct, x, cfg, 1.5))
            fp = max(GE.grid_encode_backward_error(ref, ct, x, cfg, 1.5))
            rel = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                      for a, b in zip(got, ref))
            print(f"{case:17s} repeat {r}: kernel {fk:.4f} of the bound (max|err| "
                  f"{_abs_err(got, ct, x, cfg, 1.5):.3e}), plain {fp:.4f} (max|err| "
                  f"{_abs_err(ref, ct, x, cfg, 1.5):.3e}); kernel vs plain {rel:.3e} of max|grad|")
    return 0


if __name__ == "__main__":
    sys.exit(main())
