"""The program's spans over a traced stretch, against the device's
timeline: each idle instant of the device goes to the innermost program
span open on the host at that instant, or to "outside the program" where
none is; each span's host self time; the counters' change per call; and
how far the profiler's events and the program's launches agree.

A tool of its own, beside the benchmark's runs:

    python3 -m portbench.spans --workload <cell> --seed <n> [--seconds 1]

builds the cell as a run does, warms it up, and profiles a stretch of its
calls with the program's recording block open (l2n_tpu_torch/utils/
profiling.py `recording`); it prints one [spans] line to standard error
and the readings as a JSON object to standard output. The benchmark's own
traced stretch (devtrace.py) opens no recording block, so a run's metrics
read none of this.

Self time and the innermost span are computed here from the spans alone,
not by the program's own helpers: the benchmark reads the program, and
keeps its arithmetic apart from it."""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys
import time

import numpy as np
import torch

from portbench import devtrace, harness
from portbench.generator import Generator

OUTSIDE = "outside the program"
# The children a kernel wrapper's span (kernel.<name>) holds.
KERNEL_PARTS = ("kernel.check", "kernel.params", "kernel.launch")


def innermost(spans) -> list:
    """[start, end, name] pieces of the host's time line, each under the
    innermost span open there (spans as [name, start, end, id, parent,
    call]); time under no span has no piece."""
    marks = []
    for name, a, b, sid, *_ in spans:
        if b > a:
            marks.append((a, 1, sid, name))
            marks.append((b, 0, sid, name))
    marks.sort(key=lambda m: (m[0], m[1]))  # ends before starts at a tie
    out, stack, last = [], [], None
    for t, is_start, sid, name in marks:
        if stack and last is not None and t > last:
            out.append([last, t, stack[-1][1]])
        if is_start:
            stack.append((sid, name))
        else:
            stack.remove(next(e for e in stack if e[0] == sid))
        last = t
    return out


def _overlap(pieces, starts, a, b):
    """[(us, piece)] of the pieces (sorted, disjoint [start, end, ...])
    that overlap [a, b]."""
    out = []
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(pieces) and pieces[i][0] < b:
        lo, hi = max(pieces[i][0], a), min(pieces[i][1], b)
        if hi > lo:
            out.append((hi - lo, pieces[i]))
        i += 1
    return out


def split_idle(busy, spans):
    """The device's idle time between its merged busy intervals `busy`,
    split over the innermost program span open at each instant: ({name:
    us}, us outside every span, total idle us, the largest difference over
    one gap between the gap and its split plus its time outside). The time
    outside is the gap less its cover by the union of the spans, taken
    apart from the split, so the last figure checks that the split tiles
    the spans."""
    pieces = innermost(spans)
    starts = [p[0] for p in pieces]
    cover = merged([(s[1], s[2]) for s in spans])
    cover_starts = [c[0] for c in cover]
    by_name = collections.defaultdict(float)
    outside = total = worst = 0.0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        gap = b - a
        total += gap
        inside = 0.0
        for us, piece in _overlap(pieces, starts, a, b):
            by_name[piece[2]] += us
            inside += us
        out = gap - sum(us for us, _ in
                        _overlap(cover, cover_starts, a, b))
        outside += out
        worst = max(worst, abs(gap - inside - out))
    return dict(by_name), outside, total, worst


def self_us(spans) -> dict:
    """Each span's host self time in us, by id: its duration less the part
    its children's spans cover."""
    children = collections.defaultdict(list)
    for _, a, b, _, parent, _ in spans:
        children[parent].append((a, b))
    out = {}
    for _, a, b, sid, _, _ in spans:
        covered, reach = 0.0, a
        for ca, cb in sorted(children.get(sid, ())):
            ca, cb = max(ca, reach), min(cb, b)
            if cb > ca:
                covered += cb - ca
                reach = cb
        out[sid] = b - a - covered
    return out


def merged(intervals) -> list:
    """The union of [a, b] intervals as sorted disjoint [a, b] lists."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def launch_agreement(spans, launch_events, kernel_events, kernel: str):
    """(the share of kernel.launch spans that hold a kernel-launch API event
    of the profiler, the share of those whose `kernel` started on the
    device after the span started, matched by correlation id, and the
    least and the median us from such an event's start to its kernel's
    start on the device: below 0, the profiler put the device's clock
    ahead of the host's); Nones where there is no kernel.launch span."""
    launches = [s for s in spans if s[0] == "kernel.launch"]
    if not launches:
        return None, None, None
    events = sorted(launch_events, key=lambda e: e[1])
    starts = [e[1] for e in events]
    device_start = {}
    for name, cid, a, _ in kernel_events:
        if kernel in name:
            device_start.setdefault(cid, a)
    held = after = 0
    lags = []
    for _, a, b, *_ in launches:
        i = bisect.bisect_left(starts, a)
        inside = [e for e in events[i:bisect.bisect_right(starts, b)]
                  if e[2] <= b]
        if inside:
            held += 1
            if any(device_start.get(e[0], -1.0) > a for e in inside):
                after += 1
            lags += [device_start[e[0]] - e[1] for e in inside
                     if e[0] in device_start]
    lags.sort()
    lag = [lags[0], lags[len(lags) // 2]] if lags else None
    return held / len(launches), (after / held if held else None), lag


def align(kernel_events, launch_events, sync_events, kernel: str):
    """The device events' [start, end] moved onto the host's time line,
    frame by frame, by the least that puts each `kernel` launch's kernel
    after the start of its launch API call and its end before the end of
    the first device synchronize the host began after that call (the
    profiler's device clock can drift against the host's within a stretch;
    where it does not, nothing moves), and the shift of each such launch,
    in us. A device event takes the shift of the first such kernel that
    ends at or after its start. Where no launch of `kernel` matches, the
    events stay as they are."""
    api = {cid: a for cid, a, _ in launch_events}
    syncs = sorted(sync_events)
    sync_starts = [a for a, _ in syncs]
    anchors = []
    for name, cid, a, b in kernel_events:
        if kernel in name and cid in api:
            lo = api[cid] - a
            i = bisect.bisect_left(sync_starts, api[cid])
            hi = syncs[i][1] - b if i < len(syncs) else float("inf")
            shift = min(max(0.0, lo), hi) if lo <= hi else (lo + hi) / 2
            anchors.append((b, shift))
    anchors.sort()
    if not anchors:
        return [[a, b] for _, _, a, b in kernel_events], []
    ends = [b for b, _ in anchors]
    out = []
    for _, _, a, b in kernel_events:
        i = min(bisect.bisect_left(ends, a), len(anchors) - 1)
        out.append([a + anchors[i][1], b + anchors[i][1]])
    return out, [shift for _, shift in anchors]


def attribute(prof: dict, kernel: str) -> dict | None:
    """What the [spans] line reads, from a stretch's record (`stretch`) of
    the cell's kernel `kernel`; None where it made no calls."""
    if not prof or not prof["calls"]:
        return None
    calls = prof["calls"]
    spans = prof["spans"]
    counters = prof["counters"]
    out = {"calls": calls, "counters": counters}
    launches = sum(counters.get("launches", {}).values())
    out["launches_per_call"] = (launches / calls if "launches" in counters
                                else None)
    graph = counters.get("graph_calls")
    out["eager_share"] = None
    if graph is not None and graph.get("eager", 0) + graph.get("replay", 0):
        out["eager_share"] = 100.0 * graph.get("eager", 0) / (
            graph.get("eager", 0) + graph.get("replay", 0))
    kept = sum(1 for e in prof["kernel_events"] if kernel in e[0])
    counted = counters.get("launches", {}).get(kernel, 0)
    out["kept_share"] = 100.0 * kept / counted if counted else None
    if not spans:
        out.update(program_host_ms=None, launch_host_us=None,
                   idle_in_program_ms=None, idle_ms=None, self_ms=None,
                   launch_held=None, device_after=None, launch_lag_us=None,
                   shift_us=None, worst_gap_us=None,
                   idle_total_ms=None, outside_ms=None)
        return out
    busy = prof["busy"]
    out["shift_us"] = None
    if any(s[0] == "kernel.launch" for s in spans):
        events, shifts = align(prof["kernel_events"], prof["launch_events"],
                               prof["sync_events"], kernel)
        if shifts:
            busy = merged(events)
            shifts.sort()
            out["shift_us"] = [shifts[0], shifts[len(shifts) // 2],
                               shifts[-1]]
    idle, outside, total, worst = split_idle(busy, spans)
    out["idle_ms"] = {k: v / 1e3 / calls for k, v in idle.items()}
    out["outside_ms"] = outside / 1e3 / calls
    out["idle_total_ms"] = total / 1e3 / calls
    out["worst_gap_us"] = worst
    out["idle_in_program_ms"] = (total - outside) / 1e3 / calls
    selfs = self_us(spans)
    by_name = collections.defaultdict(float)
    for s in spans:
        by_name[s[0]] += selfs[s[3]]
    out["self_ms"] = {k: v / 1e3 / calls for k, v in by_name.items()}
    roots = [(s[1], s[2]) for s in spans if s[4] == 0]
    out["program_host_ms"] = sum(b - a for a, b in merged(roots)) / 1e3 \
        / calls
    wrappers = [s[2] - s[1] for s in spans
                if s[0].startswith("kernel.") and s[0] not in KERNEL_PARTS]
    out["launch_host_us"] = (sum(wrappers) / len(wrappers) if wrappers
                             else None)
    out["launch_held"], out["device_after"], out["launch_lag_us"] = \
        launch_agreement(
            spans, prof["launch_events"], prof["kernel_events"], kernel)
    return out


def _ms(d: dict) -> str:
    return ", ".join(f"{k} {v!r}" for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1]))


def line(a: dict, card: str) -> str:
    """The [spans] line of a traced run."""
    parts = [f"[spans] {a['calls']} calls"]
    if a.get("idle_ms") is not None:
        parts.append(f"device idle ms per call {a['idle_total_ms']!r}: "
                     f"{_ms(a['idle_ms'])}, {OUTSIDE} {a['outside_ms']!r} "
                     f"(split less total, largest over a gap: "
                     f"{a['worst_gap_us']!r} us)")
        parts.append(f"host self ms per call: {_ms(a['self_ms'])}")
        parts.append(f"program host ms per call {a['program_host_ms']!r}, "
                     f"kernel wrapper us per launch {a['launch_host_us']!r}")
        parts.append(f"kernel.launch spans holding a launch API event "
                     f"{a['launch_held']!r}, of those with the kernel "
                     f"starting after the span {a['device_after']!r}; us "
                     f"from the API event to the kernel's start, least and "
                     f"median {a['launch_lag_us']!r}; the device's time "
                     f"line moved onto the host's by us, least, median "
                     f"and greatest {a['shift_us']!r}")
    parts.append(f"counters {a['counters']}")
    parts.append(f"launches per call {a['launches_per_call']!r}, eager "
                 f"share {a['eager_share']!r}%, the profiler kept a device "
                 f"event of {a['kept_share']!r}% of the counted launches")
    return "; ".join(parts) + f"; card {card}"


class ProgramRecord:
    """The program's own record over a stretch: its spans (recorded only
    between this object's making and `close`, where the program has a span
    recorder) and the change of its counters (ops/kernels/common.py
    `launches` and `graph_calls`, where it has them). A program without
    them gives no spans and no such counter, and nothing raises."""

    COUNTERS = ("launches", "graph_calls")

    def __init__(self):
        try:
            from l2n_tpu_torch.ops.kernels import common
            from l2n_tpu_torch.utils import profiling
        except ImportError:
            common = profiling = None
        self.common = common
        self.profiling = (profiling if hasattr(profiling, "recording")
                          else None)
        self.block = None
        self.spans = []
        self.counters = {}
        self.before = self._counts()
        if self.profiling is not None:
            self.profiling.drain_spans()
            self.block = self.profiling.recording()
            self.block.__enter__()

    def _counts(self) -> dict:
        return {name: dict(getattr(self.common, name))
                for name in self.COUNTERS if hasattr(self.common, name)}

    def close(self) -> None:
        if self.block is not None:
            self.block.__exit__(None, None, None)
            self.spans = self.profiling.drain_spans()
        after = self._counts()
        self.counters = {
            name: {k: v - self.before[name].get(k, 0)
                   for k, v in counts.items()
                   if v != self.before[name].get(k, 0)}
            for name, counts in after.items()}

    def keys(self, prof, events, busy, label: str) -> dict:
        """The stretch's record: the merged device busy intervals, the
        profiler's origin (its events' times are microseconds after it),
        the spans on that time base as [name, start, end, id, parent,
        call], the counters' change, the host's kernel-launch API events as
        [correlation id, start, end], its device-synchronize API events as
        [start, end] and the device events as [name, correlation id, start,
        end]."""
        try:
            origin = prof.profiler.kineto_results.trace_start_ns()
        except AttributeError:
            origin = None
        spans = [] if origin is None else [
            [s.name, (s.start_ns - origin) / 1e3, (s.end_ns - origin) / 1e3,
             s.id, s.parent, s.call] for s in self.spans]
        cpu = torch.autograd.DeviceType.CPU
        cuda = torch.autograd.DeviceType.CUDA
        return {
            "busy": busy, "origin_ns": origin, "spans": spans,
            "counters": self.counters,
            "launch_events": [
                [e.id, e.time_range.start, e.time_range.end] for e in events
                if e.device_type == cpu and "LaunchKernel" in e.name],
            "sync_events": [
                [e.time_range.start, e.time_range.end] for e in events
                if e.device_type == cpu and "DeviceSynchronize" in e.name],
            "kernel_events": [
                [e.name[:96], e.id, e.time_range.start, e.time_range.end]
                for e in events if e.device_type == cuda
                and e.time_range.elapsed_us() > 0
                and not e.name.startswith(label + ".")]}


def stretch(gen, seconds: float, label: str = "portbench") -> dict:
    """Profile `gen`'s calls for `seconds`, as devtrace.py's traced stretch
    does, with the program's recording block open around the calls; returns
    the calls and `ProgramRecord.keys`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the profiler's own start-up
        gen.call(label=label)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        record = ProgramRecord()
        window, _ = gen.run(seconds, label=label)
        record.close()
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.time_range.elapsed_us() > 0
           and not e.name.startswith(label + ".")]
    busy = devtrace._merge([(e.time_range.start, e.time_range.end)
                            for e in dev])
    return {"calls": window.calls, **record.keys(prof, events, busy, label)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The program's spans over a "
                                 "traced stretch of one cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--warm-seconds", type=float, default=2.0,
                    help="untraced calls before the stretch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from l2n_tpu_torch.camera.camera import Camera
    device = torch.device("cuda")
    c = harness.load_cell(args.workload, args.seed)
    cfg = harness.port_config(c.ref_cfg)
    renderer, _ = harness.build_renderer(c, device, "cuda")
    pixels = cfg.effective_tiles_per_step * cfg.tile_height * cfg.tile_width
    gen = Generator(c.mix, renderer,
                    lambda view: Camera.from_config(cfg, view_matrix=view),
                    np.asarray(c.config["view"], np.float32), args.seed,
                    pixels * cfg.spp_per_step, device)
    t0 = time.perf_counter()
    for _ in range(3):  # the build, the capture and a replay
        gen.call()
    gen.run(args.warm_seconds)
    warm_s = time.perf_counter() - t0
    kernel = "sphere_pt" if cfg.scene_kind == "sphere" else "triangle_pt"
    a = attribute(stretch(gen, args.seconds), kernel)
    if a is None:
        print("portbench.spans: the stretch made no calls", file=sys.stderr)
        return 1
    print(line(a, harness.card_line()) + f"; warm-up {warm_s!r} s",
          file=sys.stderr)
    print(json.dumps(dict(a, workload=args.workload, seed=args.seed)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
