"""A traced stretch: torch.profiler over a few more calls of the mix after
the measured window, for the device's busy time, the kernels' times by
name and the idle gaps by what the host was doing (the generator labels
its host phases while traced). The profiler may drop device events, so
per-launch times come from CUDA events (generator.py), not from here."""

from __future__ import annotations

import collections
import time

import torch


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def traced_stretch(gen, seconds: float, label: str = "portbench") -> dict:
    """Profile `gen`'s calls for `seconds`; returns busy_s, window_s (the
    stretch on the host clock), span_s (first device event's start to the
    last's end), the calls, and the breakdown's two lists."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the profiler's own start-up
        gen.call(label=label)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window, _ = gen.run(seconds, label=label)
        window_s = time.perf_counter() - t0
    calls = window.calls
    events = prof.events()
    # The host labels' ranges appear on the device timeline too; they are
    # no device work.
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.time_range.elapsed_us() > 0
           and not e.name.startswith(label + ".")]
    busy = _merge([(e.time_range.start, e.time_range.end) for e in dev])
    busy_us = sum(b - a for a, b in busy)
    span_us = (busy[-1][1] - busy[0][0]) if busy else 0.0
    by_name = collections.defaultdict(float)
    for e in dev:
        by_name[e.name[:96]] += e.time_range.elapsed_us() * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith(label + "."))
    gaps = collections.defaultdict(float)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        doing = "other host work"
        for a, b, name in host:  # the innermost label covering the gap
            if a <= end < b:
                doing = name
        gaps[doing] += (start - end) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": window_s,
            "span_s": span_us * 1e-6, "calls": calls,
            "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
