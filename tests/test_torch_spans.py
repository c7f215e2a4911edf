"""l2n_tpu_torch's spans and counters on the CPU (backend="torch"): the span
recorder of utils/profiling.py, the span tree of a renderer call, the
launch and graph-call counters of ops/kernels/common.py, self time, the
clock the spans share with torch.profiler, and the spans in trace()'s
Chrome trace."""

import collections
import contextlib
import json
import sys
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.kernels import build, common
from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt
from l2n_tpu_torch.render.program import SphereProgram
from l2n_tpu_torch.render.renderer import Renderer
from l2n_tpu_torch.render.state import init_frame_state
from l2n_tpu_torch.render.step import MultiStep
from l2n_tpu_torch.scene.spheres import compute_spheres
from l2n_tpu_torch.utils import profiling
from l2n_tpu_torch.utils.profiling import (
    Site,
    Span,
    drain_spans,
    recording,
    self_times,
    trace,
)


def _forget_port():
    """Drop the port's modules from sys.modules; this file keeps its own
    bindings. tests/test_aot_cache.py asserts that every loaded module
    named "l2n_tpu*" lies in the JAX package's AOT digest scope, and every
    xdist worker imports every test file, so the port (a separate package
    whose name shares that prefix) must not stay loaded."""
    for name in [m for m in sys.modules if m.startswith("l2n_tpu_torch")]:
        del sys.modules[name]


_forget_port()


@pytest.fixture(scope="module", autouse=True)
def _port_unloaded_after_module():
    # One torch thread while this module runs (the suite's workers share
    # the machine's cores).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _forget_port()


@pytest.fixture(autouse=True)
def _empty_record():
    drain_spans()
    common.reset_launches()
    yield
    drain_spans()
    common.reset_launches()


CFG = RenderConfig(width=64, height=32, tile_width=8, tile_height=8,
                   tiles_per_step=3, max_bounces=2, sphere_count=16,
                   emissive_every=2).validate()
VIEW = look_at(np.array([0.0, 0.0, 40.0], np.float32),
               np.zeros(3, np.float32),
               np.array([0.0, 1.0, 0.0], np.float32))


def _renderer(steps_per_call=1):
    return Renderer({"spherePT": SphereProgram(
        CFG, backend="torch", steps_per_call=steps_per_call)})


def _frame(renderer):
    """One frame of a viewer dragging the camera: the camera block, a
    clear, one step."""
    camera = Camera.from_config(CFG, view_matrix=VIEW)
    renderer.on_camera_moved()
    renderer.step(camera)


def _fake_library(monkeypatch):
    """`launch_raw` on the CPU: a kernel library whose entry points return
    0, and the CUDA device and stream lookups stood in for."""
    lib = types.SimpleNamespace(l2n_sphere_pt=lambda *args: 0)
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))


def test_no_span_outside_a_recording_block(monkeypatch):
    """Outside a recording block nothing is recorded and a site's enter
    and exit are a builtin that does nothing (no Python frame), while the
    counters still count; inside one they record."""
    assert Site.__enter__ is Site.__exit__ is profiling._NOTHING
    with recording():
        assert Site.__enter__ is not profiling._NOTHING
    assert Site.__enter__ is Site.__exit__ is profiling._NOTHING
    renderer = _renderer()
    _fake_library(monkeypatch)
    _frame(renderer)
    common.launch_raw("sphere_pt", torch.device("cpu"))
    assert drain_spans() == []
    assert common.graph_calls == {"eager": 1}
    assert common.launches == {"sphere_pt": 1}
    common.reset_launches()
    assert not common.launches and not common.graph_calls


def test_a_frame_s_span_tree():
    """A frame on the plain path: the camera block and the clear are calls
    of their own; the step is a call whose root holds the camera's
    packing and the eager step, which holds the schedule's gather."""
    renderer = _renderer()
    _frame(renderer)  # the first step of a program is no different here
    with recording():
        _frame(renderer)
    spans = drain_spans()
    by_name = {s.name: s for s in spans}
    assert sorted(by_name) == ["camera.build", "camera.pack",
                               "renderer.clear", "renderer.step",
                               "step.eager", "step.gather"]
    assert len(spans) == 6
    roots = [s for s in spans if s.parent == 0]
    assert [s.name for s in sorted(roots, key=lambda s: s.start_ns)] == [
        "camera.build", "renderer.clear", "renderer.step"]
    assert all(s.call == s.id for s in roots)
    step = by_name["renderer.step"]
    assert by_name["camera.pack"].parent == step.id
    assert by_name["step.eager"].parent == step.id
    assert by_name["step.gather"].parent == by_name["step.eager"].id
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            parent = next(p for p in spans if p.id == s.parent)
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            assert s.call == step.id
    assert common.graph_calls == {"eager": 2}


def test_kernel_launch_span_and_count(monkeypatch):
    """`launch_raw` records the ctypes call as kernel.launch and counts
    it; `step_params` records kernel.params; the sphere wrapper's checks
    are kernel.check under kernel.sphere_pt (its plain version on CPU
    tensors counts no launch)."""
    _fake_library(monkeypatch)
    st = init_frame_state(CFG)
    sched = torch.tensor([[0, 0]], dtype=torch.int32)
    camera = Camera.from_config(CFG, view_matrix=VIEW).packed()
    spheres = compute_spheres(CFG.sphere_count).packed()
    with recording():
        common.launch_raw("sphere_pt", torch.device("cpu"))
        common.step_params(CFG, 1, CFG.sphere_count, camera)
        sphere_pt(CFG, sched, camera, spheres, st.accum, st.output)
    spans = drain_spans()
    assert [s.name for s in spans[:2]] == ["kernel.launch", "kernel.params"]
    assert all(s.parent == 0 for s in spans[:2])
    wrapper = spans[-1]
    assert wrapper.name == "kernel.sphere_pt"
    assert [s.name for s in spans[2:-1]] == ["kernel.check"]
    assert spans[2].parent == wrapper.id
    assert common.launches == {"sphere_pt": 1}


def test_multistep_without_graphs_counts_eager_calls():
    """steps_per_call=2 on the plain path runs every call eagerly: one
    eager call each, one gather each."""
    renderer = _renderer(steps_per_call=2)
    camera = Camera.from_config(CFG, view_matrix=VIEW)
    with recording():
        for _ in range(3):
            renderer.step(camera)
    assert common.graph_calls == {"eager": 3}
    names = collections.Counter(s.name for s in drain_spans())
    assert names == {"renderer.step": 3, "camera.pack": 3, "step.eager": 3,
                     "step.gather": 3}


def test_multistep_graph_calls_capture_and_replay(monkeypatch):
    """With graphs (the CUDA graph stood in for on the CPU) the first call
    of a camera is eager, the second captures and replays, the third
    replays: each counted once where it happens, each a span."""
    class FakeGraph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    plain = SphereProgram(CFG, backend="torch", steps_per_call=2).step
    graphed = MultiStep(CFG, plain.render, plain.tiles, 2,
                        torch.device("cpu"), graphs=True)
    camera = Camera.from_config(CFG, view_matrix=VIEW).packed()
    st = init_frame_state(CFG)
    with recording():
        for _ in range(3):
            st = graphed(st, camera)
    assert common.graph_calls == {"eager": 1, "capture": 1, "replay": 2}
    roots = [s.name for s in drain_spans() if s.parent == 0]
    assert roots == ["step.eager", "step.capture", "step.replay"]


@pytest.mark.parametrize("k,n,calls", [(3, 12, 2), (3, 5, 1), (8, 32, 8),
                                       (32, 3, 3)])
def test_multistep_launches_per_call_reads_groups(monkeypatch, k, n, calls):
    """`launches` over `graph_calls` (portbench's launches_per_call) reads
    ceil(N / G) kernel calls a call, G = max(1, min(N, T // k)) on the
    32-tile frame, through eager calls, a capture and replays (the CUDA
    graph stood in for on the CPU, as above; a stand-in render counts one
    launch a kernel call)."""
    class FakeGraph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    cfg = CFG.replace(tiles_per_step=k).validate()
    plain = SphereProgram(cfg, backend="torch", steps_per_call=n).step

    def render(sched, *planes):
        common.launches["sphere_pt"] += 1

    graphed = MultiStep(cfg, render, plain.tiles, n, torch.device("cpu"),
                        graphs=True)
    camera = Camera.from_config(cfg, view_matrix=VIEW).packed()
    st = init_frame_state(cfg)
    for _ in range(4):
        st = graphed(st, camera)
    assert common.graph_calls == {"eager": 1, "capture": 1, "replay": 3}
    per_call = sum(common.launches.values()) / (
        common.graph_calls["eager"] + common.graph_calls["replay"])
    assert per_call == calls


def test_self_time_is_duration_less_the_children_s_cover():
    spans = [Span("a", 0, 100, 1, 0, 1), Span("b", 10, 30, 2, 1, 1),
             Span("c", 25, 40, 3, 1, 1), Span("d", 90, 120, 4, 1, 1),
             Span("e", 12, 14, 5, 2, 1)]
    got = self_times(spans)
    assert got == {1: 100 - (40 - 10) - (100 - 90), 2: 20 - 2, 3: 15,
                   4: 30, 5: 2}
    outer_site, inner_site = Site("outer"), Site("inner")
    with recording():
        with outer_site:
            time.sleep(0.001)
            for _ in range(2):
                with inner_site:
                    time.sleep(0.001)
    recorded = drain_spans()
    outer = recorded[-1]
    inner = sum(s.end_ns - s.start_ns for s in recorded[:-1])
    assert self_times(recorded)[outer.id] == \
        outer.end_ns - outer.start_ns - inner


def test_the_record_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=4))
    sites = [Site(f"s{i}") for i in range(10)]
    with recording():
        for site in sites:
            with site:
                pass
    assert [s.name for s in drain_spans()] == ["s6", "s7", "s8", "s9"]
    assert drain_spans() == []


def test_spans_share_the_profiler_s_clock():
    """A CPU op run 2 ms inside a span has its profiler event inside the
    span, with those 2 ms to spare on each side, once the span is put on
    the events' time base (microseconds after the trace's start)."""
    x = torch.ones(1 << 16)
    around = Site("around")
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording():
        with around:
            time.sleep(0.002)
            torch.cumsum(x, 0)
            time.sleep(0.002)
    origin = prof.profiler.kineto_results.trace_start_ns()
    (s,) = drain_spans()
    start_us = (s.start_ns - origin) / 1e3
    end_us = (s.end_ns - origin) / 1e3
    (op,) = [e for e in prof.events() if e.name == "aten::cumsum"]
    assert start_us + 1500 < op.time_range.start
    assert op.time_range.end + 1500 < end_us


def test_trace_json_holds_the_spans(tmp_path):
    """trace() records the block's spans and writes them into its Chrome
    trace as a process row of their own, on the events' time base."""
    x = torch.ones(1 << 16)
    around = Site("around")
    with trace(tmp_path / "t") as log_dir:
        with around:
            time.sleep(0.002)
            torch.cumsum(x, 0)
            time.sleep(0.002)
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    row = [e for e in events if e.get("pid") == profiling.TRACE_PID]
    assert {e["name"] for e in row if e["ph"] == "M"} == {
        "process_name", "process_sort_index"}
    (s,) = [e for e in row if e["ph"] == "X"]
    assert s["name"] == "around" and s["args"]["parent"] == 0
    (op,) = [e for e in events if e.get("name") == "aten::cumsum"]
    assert s["ts"] + 1500 < op["ts"]
    assert op["ts"] + op["dur"] + 1500 < s["ts"] + s["dur"]
    assert drain_spans() == []


def test_exceptions_pass_and_nesting():
    """A site lets an exception through, recording or not; recording
    blocks nest; a block entered before recording began is not recorded,
    and its exit takes nothing from the record."""
    site = Site("s")
    for on in (False, True):
        with pytest.raises(KeyError):
            with recording() if on else contextlib.nullcontext():
                with site:
                    raise KeyError("x")
    assert [s.name for s in drain_spans()] == ["s"]
    with recording():
        with recording():
            pass
        with site:
            pass
    assert len(drain_spans()) == 1
    with site:
        with recording():
            with site:
                pass
    assert [(s.name, s.parent) for s in drain_spans()] == [("s", 0)]
