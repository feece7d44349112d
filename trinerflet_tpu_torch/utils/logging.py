"""Experiment logging, tracing and config snapshots (port of
``trinerflet_tpu/utils/logging.py``).

* ``ExperimentLogger``: an append-only text log ``log_{name}.txt`` (and the
  console), tensorboardX scalars when tensorboardX is installed (else the
  writer is ``None`` and ``scalars`` does nothing, as in the JAX package),
  and ``config()``, the JSON snapshot of the run's config dataclasses.
* ``profile_trace(logdir)``: ``torch.profiler`` around a block (the CPU, and
  the card when there is one), its Chrome trace written into ``logdir``
  (the JAX package captures a ``jax.profiler`` trace there).
* ``StepTimer``: a rolling step-time meter.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict

__all__ = ["ExperimentLogger", "profile_trace", "StepTimer"]


class ExperimentLogger:
    def __init__(self, workspace: str, name: str = "trinerflet", use_tensorboard: bool = True):
        self.workspace = workspace
        self.name = name
        os.makedirs(workspace, exist_ok=True)
        self.log_path = os.path.join(workspace, f"log_{name}.txt")
        self.writer = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(os.path.join(workspace, "run", name))
            except Exception:  # not installed (or unusable): no scalars, as in the JAX package
                self.writer = None

    def text(self, msg: str, to_console: bool = True):
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        with open(self.log_path, "a") as f:
            f.write(f"[{stamp}] {msg}\n")
        if to_console:
            print(msg)

    def scalars(self, step: int, values: Dict[str, float], prefix: str = "train"):
        """One scalar per entry; ``float()`` of each value (a device sync
        for a tensor), so call it on log steps only."""
        if self.writer is None:
            return
        for k, v in values.items():
            try:
                self.writer.add_scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def config(self, cfg: Any, fname: str = "config.json"):
        """JSON snapshot of configs: dataclasses as their dicts, anything
        else JSON does not take as its ``str``."""

        def enc(o):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            return str(o)

        with open(os.path.join(self.workspace, fname), "w") as f:
            json.dump(cfg, f, indent=2, default=enc)

    def close(self):
        if self.writer is not None:
            self.writer.close()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA when
    a card is present) and write its Chrome trace to
    ``logdir/trace_{pid}_{time}.json``. Yields ``logdir``."""
    import torch

    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield logdir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d-%H%M%S')}.json"))


class StepTimer:
    """Rolling step-time / throughput meter."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times = []
        self.last = None
        self.t0 = time.perf_counter()

    def tick(self):
        now = time.perf_counter()
        if self.last is not None:
            self.times.append(now - self.last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self.last = now

    @property
    def mean_ms(self) -> float:
        return 1e3 * sum(self.times) / max(len(self.times), 1)

    @property
    def total_s(self) -> float:
        return time.perf_counter() - self.t0
