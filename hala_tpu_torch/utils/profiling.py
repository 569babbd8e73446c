"""Tracing / profiling hooks.

Counterpart of the JAX package's utils/profiling.py (the reference's GPU
timestamp query pairs per frame, 1 Hz statistics log and debug labels
for capture tools):

* `trace()` — a `torch.profiler` window over the block (CPU, and CUDA
  where the card is there), exported as a Chrome trace into `log_dir`
  (the capture-tool analog);
* `annotate()` — a `torch.profiler.record_function` named range (the
  begin/end_debug_label analog, rz_renderer.rs:989-992);
* `FrameTimer` — wall-clock pass timing that waits for a CUDA result
  with `torch.cuda.synchronize` (the timestamp-query analog,
  renderer.rs:274-277).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str = "./out/profile"):
    """Profile everything inside the block; on exit write
    `log_dir`/trace.json (chrome://tracing, Perfetto). Yields log_dir."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named trace range (debug-label analog)."""
    return record_function(name)


class FrameTimer:
    """Per-pass wall time; a pass that hands over a CUDA tensor is timed
    up to the end of its device work."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        """Time the block. The block may set holder["result"] (or pass
        `result`): a CUDA tensor there is waited for before the clock
        stops."""
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            value = holder.get("result", result)
            if isinstance(value, torch.Tensor) and value.is_cuda:
                torch.cuda.synchronize(value.device)
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        return ", ".join(f"{k}: {v * 1000:.2f}ms" for k, v in self.times.items())
