"""Profiling and structured metrics (counterpart of l2n_tpu.utils.profiling).

Step timing and throughput counters (`StepTimer`, the JAX package's
arithmetic and keys), the metrics log line (`log_metrics`), and an
on-demand torch.profiler trace (`trace`) of the card's timeline.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

_log = logging.getLogger("l2n_tpu_torch.metrics")


class StepTimer:
    """Rolling per-step wall-clock and derived throughput counters."""

    def __init__(self, window: int = 120):
        self.window = window
        self.times: list[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)
        if len(self.times) > 2 * self.window:
            del self.times[:self.window]

    def metrics(self, samples_per_step: int, pixels: int,
                mean_segments: float = 1.0) -> dict[str, float]:
        times = self.times[-self.window:] or [float("nan")]
        ms = sum(times) / len(times) * 1e3
        sps = samples_per_step / (ms * 1e-3)
        return {
            "ms_per_step": ms,
            "fps": 1e3 / ms,
            "samples_per_sec": sps,
            "spp_per_sec": sps / pixels,
            "mrays_per_sec": sps * mean_segments / 1e6,
        }


def log_metrics(step: int, metrics: dict[str, float]) -> None:
    _log.info("step=%d %s", step,
              " ".join(f"{k}={v:.3f}" for k, v in metrics.items()))


@contextlib.contextmanager
def trace(log_dir: str | Path = "l2n_trace"):
    """torch.profiler trace (host and card) around a block, exported as a
    Chrome trace to `log_dir`/trace.json (chrome://tracing, Perfetto). The
    profiler may drop part of a window's device events: read device times
    from CUDA events where a figure must be whole."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))
