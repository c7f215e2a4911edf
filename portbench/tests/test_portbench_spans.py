"""spans.py's split of the device's idle time over the program's spans, its
readings, and its record of the program on the CPU (a program with spans
and counters, and one without); the readers of the program's counters."""

import collections
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans
from portbench.tests.frames import SMALL

# [name, start, end, id, parent, call] in us: two calls, the second with a
# step holding a kernel wrapper that holds its launch.
SPANS = [["camera.build", 10.0, 20.0, 1, 0, 1],
         ["kernel.launch", 46.0, 50.0, 5, 4, 3],
         ["kernel.sphere_pt", 40.0, 55.0, 4, 3, 3],
         ["renderer.step", 30.0, 70.0, 3, 0, 3]]
# Busy intervals: idle gaps [5, 15], [25, 45], [48, 60], [65, 100].
BUSY = [[0.0, 5.0], [15.0, 25.0], [45.0, 48.0], [60.0, 65.0],
        [100.0, 110.0]]


def test_the_idle_split_tiles_the_gaps():
    idle, outside, total, worst = spans.split_idle(BUSY, SPANS)
    assert total == 10 + 20 + 12 + 35
    assert idle == {"camera.build": 5.0, "renderer.step": 5 + 10 + 5,
                    "kernel.sphere_pt": 5.0 + 5.0, "kernel.launch": 2.0}
    assert outside == 5 + 5 + 30
    assert sum(idle.values()) + outside == total
    assert worst == 0.0


def test_innermost_and_self_time():
    pieces = spans.innermost(SPANS)
    assert pieces == [[10.0, 20.0, "camera.build"],
                      [30.0, 40.0, "renderer.step"],
                      [40.0, 46.0, "kernel.sphere_pt"],
                      [46.0, 50.0, "kernel.launch"],
                      [50.0, 55.0, "kernel.sphere_pt"],
                      [55.0, 70.0, "renderer.step"]]
    assert spans.self_us(SPANS) == {1: 10.0, 5: 4.0, 4: 11.0, 3: 25.0}


PROFILE = {
    "calls": 2, "busy": BUSY, "spans": SPANS,
    "counters": {"launches": {"sphere_pt": 2},
                 "graph_calls": {"eager": 2}},
    "launch_events": [[7, 47.0, 49.0]], "sync_events": [[50.0, 66.0]],
    "kernel_events": [["elementwise", 0, 0.0, 5.0],
                      ["elementwise", 1, 15.0, 25.0],
                      ["elementwise", 2, 45.0, 48.0],
                      ["void sphere_pt_kernel<>", 7, 60.0, 65.0],
                      ["elementwise", 3, 100.0, 110.0]]}


def test_attribute_reads_the_metrics():
    a = spans.attribute(PROFILE, "sphere_pt")
    assert a["launches_per_call"] == 1.0
    assert a["eager_share"] == 100.0
    assert a["kept_share"] == 50.0
    assert a["program_host_ms"] == (10 + 40) / 1e3 / 2
    assert a["launch_host_us"] == 15.0
    assert a["idle_in_program_ms"] == (77 - 40) / 1e3 / 2
    assert a["idle_total_ms"] == 77 / 1e3 / 2
    assert (a["launch_held"], a["device_after"]) == (1.0, 1.0)
    assert a["launch_lag_us"] == [13.0, 13.0]
    assert a["shift_us"] == [0.0, 0.0, 0.0]
    line = spans.line(a, "card")
    assert line.startswith("[spans] 2 calls") and "outside" in line


def test_a_program_without_spans_or_graph_calls():
    """An older program: launches counted, no spans, no graph_calls; the
    metrics that need them read None, and nothing raises."""
    prof = dict(PROFILE, spans=[], counters={"launches": {"sphere_pt": 2}})
    a = spans.attribute(prof, "sphere_pt")
    assert a["launches_per_call"] == 1.0
    assert a["eager_share"] is None and a["program_host_ms"] is None
    assert a["idle_in_program_ms"] is None and a["launch_host_us"] is None
    spans.line(a, "card")
    assert spans.attribute(None, "sphere_pt") is None
    assert spans.attribute(dict(PROFILE, calls=0), "sphere_pt") is None


def test_graph_replays_share():
    prof = dict(PROFILE, counters={"launches": {"sphere_pt": 16},
                                   "graph_calls": {"replay": 2}})
    a = spans.attribute(prof, "sphere_pt")
    assert a["launches_per_call"] == 8.0 and a["eager_share"] == 0.0


def test_program_record_on_the_cpu():
    """The record of the program around a CPU profile: the spans of
    a call on the profiler's time base, inside its window, and the
    counters' change."""
    c = harness.load_cell("spheres128.orbit", 5, SMALL)
    renderer, _ = harness.build_renderer(c, torch.device("cpu"), "torch")
    from l2n_tpu_torch.camera.camera import Camera
    cfg = harness.port_config(c.ref_cfg)
    camera = Camera.from_config(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
        rec = spans.ProgramRecord()
        renderer.on_camera_moved()
        renderer.step(camera)
        rec.close()
        torch.ones(4).sum()
    events = prof.events()
    keys = rec.keys(prof, events, [], "portbench")
    assert keys["counters"]["graph_calls"] == {"eager": 1}
    assert keys["counters"].get("launches", {}) == {}
    names = {s[0] for s in keys["spans"]}
    assert {"renderer.clear", "renderer.step", "camera.pack", "step.eager",
            "step.gather"} <= names
    first, last = min(e.time_range.start for e in events), max(
        e.time_range.end for e in events)
    assert all(first < s[1] <= s[2] < last for s in keys["spans"])
    assert keys["origin_ns"] == prof.profiler.kineto_results.trace_start_ns()


@pytest.mark.parametrize("busy", [[], [[0.0, 1.0]]])
def test_no_gap_no_idle(busy):
    idle, outside, total, worst = spans.split_idle(busy, SPANS)
    assert idle == {} and outside == total == worst == 0.0


def test_align_moves_the_device_line_only_where_it_must():
    """Frame 1's kernel was put 50 us before its launch call: it and the
    device op before it move 50 us later; frame 2's kernel ends after the
    synchronize that waited for it returned: it moves 5 us earlier; frame
    3 is consistent and stays."""
    kernels = [["clear", 0, 40.0, 45.0], ["sphere_pt_kernel", 1, 50.0, 80.0],
               ["sphere_pt_kernel", 2, 300.0, 330.0],
               ["sphere_pt_kernel", 3, 500.0, 530.0]]
    launches = [[1, 100.0, 105.0], [2, 290.0, 295.0], [3, 495.0, 498.0]]
    syncs = [[110.0, 200.0], [296.0, 325.0], [499.0, 540.0]]
    events, shifts = spans.align(kernels, launches, syncs, "sphere_pt")
    assert shifts == [50.0, -5.0, 0.0]
    assert events == [[90.0, 95.0], [100.0, 130.0], [295.0, 325.0],
                      [500.0, 530.0]]
    assert spans.align(kernels, [], syncs, "sphere_pt") == (
        [[40.0, 45.0], [50.0, 80.0], [300.0, 330.0], [500.0, 530.0]], [])


@pytest.mark.parametrize("counts, eager, per_call", [
    ({"eager": 3}, 100.0, 8.0),
    ({"eager": 1, "capture": 1, "replay": 2}, 100.0 / 3, 8.0),
    ({}, None, None)])
def test_counter_readers(monkeypatch, counts, eager, per_call):
    """The two metrics that read the program's counters from its module:
    eager over eager + replays, and launches over the same calls."""
    common = type(sys)("l2n_tpu_torch.ops.kernels.common")
    common.graph_calls = collections.Counter(counts)
    common.launches = collections.Counter(sphere_pt=24)
    monkeypatch.setitem(sys.modules, common.__name__, common)
    assert harness.reader("eager_share.frame")({}) == eager
    assert harness.reader("launches_per_call.throughput")({}) == per_call


def test_counter_readers_without_the_counter(monkeypatch):
    """An older program: `launches` and no `graph_calls`; or no program."""
    common = type(sys)("l2n_tpu_torch.ops.kernels.common")
    common.launches = collections.Counter(sphere_pt=24)
    monkeypatch.setitem(sys.modules, common.__name__, common)
    for name in ("eager_share.frame", "launches_per_call.throughput"):
        assert harness.reader(name)({}) is None
    monkeypatch.delitem(sys.modules, common.__name__)
    for name in ("eager_share.frame", "launches_per_call.throughput"):
        assert harness.reader(name)({}) is None
