"""Profiling and structured metrics (counterpart of l2n_tpu.utils.profiling).

The metrics log line (`log_metrics`), the program's spans (`Site`,
`recording`, `drain_spans`, `self_times`), and an on-demand torch.profiler
trace (`trace`) of the card's timeline with the spans beside it.

A span names a stretch of the host's work at a layer boundary: the camera
block, a clear, a render step, its schedule gather, a kernel wrapper's
checks, parameters and launch, a graph capture or replay. Each place that
records one holds a `Site`, made once when its module is imported, and
wraps the work in `with SITE:`. Spans are recorded only inside a
`recording()` block; outside one, entering and leaving a site call a
builtin that does nothing: no Python frame, no allocation. A span that
opens with no span open around it starts a call (a `Renderer.step`, a
clear, a camera build), and every span under it carries that call's id.
Spans are stamped with `time.time_ns()`, the clock torch.profiler stamps
its events with (CLOCK_REALTIME ns), so that a span and a profiler event
convert into one time base: the events' times are microseconds after the
profiler's `kineto_results.trace_start_ns()`. Spans are recorded from the
thread that drives the renderer.

The counts of what ran, beside the spans, are `ops/kernels/common.py`'s
`launches` and `graph_calls`.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import time
from pathlib import Path
from typing import NamedTuple

_log = logging.getLogger("l2n_tpu_torch.metrics")

# The most spans kept between two drains; past it the oldest go first.
SPAN_CAPACITY = 1 << 17
# The process id of the spans' row in an exported Chrome trace.
TRACE_PID = 1 << 30


class Span(NamedTuple):
    """One recorded span: its name, start and end (`time.time_ns()`), its
    id, the id of the span open around it (0 at a call's root) and the id
    of its call (the root span's id)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    call: int


_depth = 0  # recording() blocks open
_now = time.time_ns
# The recorded spans as Span's fields, made into Spans when drained.
_spans: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
# (id, call, parent, start) of the open spans, innermost last
_open: list = []
_ids = itertools.count(1)
# Enter and exit of a site outside a recording block: a builtin that takes
# any arguments and returns "" (false, so an exception passes through).
_NOTHING = "".format


class Site:
    """A place in the program that records the spans `name`: `with SITE:`
    records the block inside a `recording()` block, and outside one does
    nothing (its enter and exit are `_NOTHING` until `recording` puts
    `_enter` and `_exit` in their place)."""

    __slots__ = ("name",)
    __enter__ = __exit__ = _NOTHING

    def __init__(self, name: str):
        self.name = name


def _enter(site: Site) -> None:
    sid = next(_ids)
    if _open:
        top = _open[-1]
        _open.append((sid, top[1], top[0], _now()))
    else:
        _open.append((sid, sid, 0, _now()))


def _exit(site: Site, *exc) -> bool:
    # A `with` statement keeps the exit it found on entering, so every
    # _exit follows its own _enter.
    end = _now()
    sid, call, parent, start = _open.pop()
    _spans.append((site.name, start, end, sid, parent, call))
    return False


@contextlib.contextmanager
def recording():
    """Record spans for the duration of the block (blocks nest); a block
    entered before it began is not recorded."""
    global _depth
    if _depth == 0:
        Site.__enter__, Site.__exit__ = _enter, _exit
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
        if _depth == 0:
            Site.__enter__ = Site.__exit__ = _NOTHING


def drain_spans() -> list[Span]:
    """The spans recorded so far, in the order they ended; the record is
    left empty."""
    out = [Span(*fields) for fields in _spans]
    _spans.clear()
    return out


def self_times(spans) -> dict[int, int]:
    """Each span's self time in ns, by id: its duration less the part of
    it that its children's spans cover."""
    children = collections.defaultdict(list)
    for s in spans:
        children[s.parent].append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        covered, reach = 0, s.start_ns
        for a, b in sorted(children.get(s.id, ())):
            a, b = max(a, reach), min(b, s.end_ns)
            if b > a:
                covered += b - a
                reach = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


def log_metrics(step: int, metrics: dict[str, float]) -> None:
    _log.info("step=%d %s", step,
              " ".join(f"{k}={v:.3f}" for k, v in metrics.items()))


@contextlib.contextmanager
def trace(log_dir: str | Path = "l2n_trace"):
    """torch.profiler trace (host and card) around a block, exported as a
    Chrome trace to `log_dir`/trace.json (chrome://tracing, Perfetto), with
    the spans the block recorded (it records them, draining the record at
    its end) as a process row of their own, "l2n_tpu_torch spans", on the
    events' time base. The profiler may drop part of a window's device
    events: read device times from CUDA events where a figure must be
    whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof, recording():
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = log_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    # An event's "ts" is microseconds after baseTimeNanoseconds.
    base = doc.get("baseTimeNanoseconds", 0)
    rows = [{"ph": "M", "name": "process_name", "pid": TRACE_PID, "tid": 0,
             "args": {"name": "l2n_tpu_torch spans"}},
            {"ph": "M", "name": "process_sort_index", "pid": TRACE_PID,
             "tid": 0, "args": {"sort_index": -1}}]
    rows += [{"ph": "X", "cat": "l2n_tpu_torch", "name": s.name,
              "pid": TRACE_PID, "tid": 0, "ts": (s.start_ns - base) / 1e3,
              "dur": (s.end_ns - s.start_ns) / 1e3,
              "args": {"id": s.id, "parent": s.parent, "call": s.call}}
             for s in drain_spans()]
    doc["traceEvents"] = doc.get("traceEvents", []) + rows
    path.write_text(json.dumps(doc))
