"""The progressive render step (counterpart of l2n_tpu.render.step).

One call = one frame dispatch: render `effective_tiles_per_step` tiles of
the shuffled schedule, accumulate radiance, tonemap the touched pixels,
advance the tile cursor.

Backends:
  * "cuda"  — the hand-written CUDA kernel of the scene's family
    (ops/kernels/sphere_pt.py or ops/kernels/triangle_pt.py) on a CUDA
    device: the main path. Without a card it raises; there is no automatic
    choice of the CPU.
  * "torch" — the plain torch version of the same step on any device: the
    counterpart of the JAX package's XLA oracle, and what the CPU tests run.

A sphere config with `wavefront=True` and the pathtracing AOV takes the
wavefront step instead (ops/kernels/wavefront.py: three kernels, or their
plain versions); a triangle config or another AOV ignores the flag and
renders through its single-pass kernel, as the JAX package does
(l2n_tpu/ops/kernels/__init__.py::build_pallas_step).

Every rng mode runs on both backends: the counter-based threefry and
tpu_hw (Philox on the card, rng/philox.py), and the stateful tinymt and
tauslcg, whose per-pixel state planes ride in the FrameState.

Next event estimation and MIS (cfg.nee, cfg.mis) are config settings too:
the lights are the scene's own (ops/nee.py), the emissive spheres of the
packed sphere buffer, or the packed mesh bounds of TriangleBuffers for
meshes, which the plain steps read from the buffers they are handed and the
kernels from the same buffers staged in shared memory.

The material modes and the bump are config settings. Explicit lights and
the Phong albedo override come as `lights` (ops/lights.ExplicitLights):
the override is written into the scene's albedo table once, the lights go
to the fused kernels; lights that change nothing are dropped, and lights
with `wavefront=True` raise, as in the JAX package.

The step updates the state's `accum`, `output` and `rng_state` IN PLACE and
returns a new FrameState sharing them with advanced counters
(render/state.py).

`steps_per_call=N` runs N scheduler steps per call, the counterpart of the
JAX step's lax.fori_loop: the same image as N single steps, to the bit.
Every step is a `MultiStep`, N = 1 included. Its N schedules come from a
device cursor (render/tiles.py), gathered once per call, and render in
groups of G consecutive steps, one kernel call a group: G = max(1, min(N,
T // k)) for T tiles in the frame and k a step.
Any G * k consecutive entries of the wrapping schedule are distinct tiles,
wherever the cursor starts, and a kernel renders distinct tiles in one
launch to the same bits as one launch per step (a pixel's sample index is
its own accumulated count, and a stateful sampler loads and stores its
planes once per pixel per launch). So a partial-frame schedule of N steps
takes ceil(N / G) launches, and whole-frame steps (k = T) one a step. The
wavefront step keeps one launch sequence per step (its lane buffers hold
one step's tiles), and so does every step under utils/validate.debug_mode,
which audits each step. With backend="cuda" the N steps are captured once
into a CUDA graph and replayed, so that the host dispatches one replay
where it dispatched N steps of wrapper calls. The kernels read the camera
from the step's device buffer (ops/kernels/common.DeviceCamera), which a
call writes only when its camera's bytes differ from the last written, so
one graph serves every camera pose; the kernels' other parameters, the
camera's slab extras among them, are baked in at capture, and so are the
state buffers' addresses: the step keeps one graph, for one (slab extras,
buffers) key. The first call for a key runs its N steps eagerly (which
builds the kernel library and does the launchers' shared-memory opt-ins,
neither of which may happen while a stream captures), the second captures
and replays, and later ones replay; new buffers drop the graph. A capture
that fails raises: nothing falls back. A call made while its stream is
already capturing (someone else's graph around the step) runs eagerly, so
that the outer capture records its launches, the camera's write among
them. Under utils/validate.debug_mode the N steps run eagerly, each launch
checked and each step audited (a capture cannot synchronize).
backend="torch" runs the same N steps eagerly, from the host camera.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from l2n_tpu_torch.camera.camera import PACKED_SHAPE, slab_extras
from l2n_tpu_torch.ops.kernels.common import (
    DeviceCamera,
    capture,
    check_camera,
    check_supported,
    debug_checks,
    graph_calls,
    replay,
    stream_capturing,
    write_camera,
)
from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt, sphere_pt_plain
from l2n_tpu_torch.ops.kernels.triangle_pt import (
    TriangleBuffers,
    triangle_pt,
    triangle_pt_plain,
)
from l2n_tpu_torch.ops.kernels.wavefront import (
    sphere_wavefront_step,
    sphere_wavefront_step_plain,
    wavefront_lanes,
)
from l2n_tpu_torch.ops.lights import ExplicitLights
from l2n_tpu_torch.render.state import FrameState
from l2n_tpu_torch.render.tiles import (
    advance_cursor,
    advance_offset,
    scheduled_tiles,
    tile_grid,
)
from l2n_tpu_torch.scene.spheres import SphereScene
from l2n_tpu_torch.scene.tessellate import TriangleScene
from l2n_tpu_torch.utils.profiling import Site

# The spans this module records (utils/profiling.py).
_STEP_EAGER = Site("step.eager")
_STEP_GATHER = Site("step.gather")
_STEP_REPLAY = Site("step.replay")
_STEP_CAPTURE = Site("step.capture")

BACKENDS = ("cuda", "torch")


def resolve_device(backend: str, device=None) -> torch.device:
    """The device a backend renders on; backend="cuda" without a card (or on
    a non-CUDA device) raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("backend='cuda' needs a CUDA device and none "
                               "is available; use backend='torch' for the "
                               "plain version")
        device = torch.device(device if device is not None else "cuda")
        if device.type != "cuda":
            raise ValueError(f"backend='cuda' cannot render on {device}")
        return device
    return torch.device(device if device is not None else "cpu")


def build_render_step(cfg, scene, backend: str = "cuda", device=None,
                      lights: ExplicitLights | None = None,
                      steps_per_call: int = 1):
    """A step(state, packed_camera) -> FrameState for (config, scene).

    `scene` is a SphereScene or a TriangleScene, per cfg.scene_kind, whose
    buffers move to the step's device once; or, for meshes, TriangleBuffers
    already packed on that device (e.g. with other tables,
    TriangleBuffers.with_tables). The camera is the packed
    (10, 4) host array (Camera.packed()). `lights`: see the module doc.
    `steps_per_call`: scheduler steps per call (see the module doc).
    """
    check_supported(cfg)
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    device = resolve_device(backend, device)
    fuse = True  # whether one kernel call may render several steps' tiles
    if lights is not None and not lights.enabled:
        lights = None
    if lights is not None and cfg.wavefront:
        raise ValueError(
            "explicit lights + wavefront is unsupported (the wavefront "
            "split does not thread the light term); use the single-pass "
            "kernels")
    kernel_lights = lights if lights is not None and lights.has_lights \
        else None
    if cfg.scene_kind == "sphere":
        if not isinstance(scene, SphereScene):
            raise TypeError("sphere config needs a SphereScene")
        if lights is not None:
            scene = scene.with_tables(
                albedo=lights.override_albedo(scene.albedo))
        buffers = scene.packed().to(device)
        if cfg.wavefront and cfg.aov == "pathtracing":
            fuse = False  # the lane buffers hold one step's tiles
            kernel = sphere_wavefront_step_plain
            if backend == "cuda":  # the kernels' buffers, kept by the step
                kernel = functools.partial(
                    sphere_wavefront_step, lanes=wavefront_lanes(
                        cfg, cfg.effective_tiles_per_step, device))
        else:
            kernel = functools.partial(
                sphere_pt if backend == "cuda" else sphere_pt_plain,
                lights=kernel_lights)
    else:
        if isinstance(scene, TriangleBuffers):
            buffers = scene
        elif isinstance(scene, TriangleScene):
            buffers = TriangleBuffers.from_scene(scene, device)
        else:
            raise TypeError("triangle config needs a TriangleScene")
        if lights is not None:
            buffers = buffers.with_tables(
                albedo=lights.override_albedo(buffers.albedo.T))
        kernel = functools.partial(
            triangle_pt if backend == "cuda" else triangle_pt_plain,
            lights=kernel_lights)
    tiles = torch.as_tensor(tile_grid(cfg)).to(device)

    def render(sched, cam, accum, output, rng_state):
        kernel(cfg, sched, cam, buffers, accum, output, rng_state)

    return MultiStep(cfg, render, tiles, steps_per_call, device,
                     graphs=backend == "cuda", fuse=fuse)


def audit(accum: torch.Tensor, output: torch.Tensor) -> None:
    """Under utils/validate.debug_mode, raise FloatingPointError where the
    frame planes hold a NaN, an Inf or a negative sample count."""
    if debug_checks():
        # utils/validate.py imports this module.
        from l2n_tpu_torch.utils.validate import check_frame_state
        report = check_frame_state(FrameState(accum, output, 0, 0))
        if not report.ok:
            raise FloatingPointError(f"frame state after a step: {report}")


class MultiStep:
    """step(state, packed_camera) -> FrameState over N scheduler steps per
    call (`build_render_step(..., steps_per_call=N)`; module doc). `render`
    renders the tiles `sched` in place, with the camera the host array or,
    with `graphs`, the step's DeviceCamera: the tiles of `group`
    consecutive steps at once where `fuse`, else those of one step."""

    def __init__(self, cfg, render, tiles: torch.Tensor, n: int,
                 device: torch.device, graphs: bool, fuse: bool = True):
        self.cfg, self.render, self.tiles, self.n = cfg, render, tiles, n
        self.device, self.graphs = device, graphs
        self.group = max(1, min(
            n, cfg.tile_count // cfg.effective_tiles_per_step)) if fuse else 1
        self.cursor = torch.zeros((1,), dtype=torch.int32, device=device)
        # The camera the kernels read. What the host knows the cursor and
        # the camera to hold once the work it has queued has run (None:
        # unknown, e.g. after an outer capture recorded writes to them).
        self.camera = torch.zeros(PACKED_SHAPE, dtype=torch.float32,
                                  device=device) if graphs else None
        self._cursor_at = None
        self._written = None
        self._graph = None  # (key, graph, launches it holds)
        self._warm = None   # the key of the last eager run

    def _steps(self, cam, accum, output, rng_state) -> None:
        """The N steps from the cursor, which they advance, `group` at a
        time (one at a time under debug_mode)."""
        k = self.cfg.effective_tiles_per_step
        group = 1 if debug_checks() else self.group
        with _STEP_GATHER:
            scheds = scheduled_tiles(self.tiles, self.cursor, self.n * k)
        for sched in scheds.split(group * k):
            self.render(sched, cam, accum, output, rng_state)
            audit(accum, output)
        advance_cursor(self.cfg, self.cursor, self.n)

    def _device_camera(self, cam: np.ndarray, outer: bool) -> DeviceCamera:
        """The step's camera buffer holding `cam`: written in stream order
        unless it already holds these bytes. Inside an `outer` capture it
        is written always, since that graph may replay after later writes,
        and its bytes are then unknown."""
        data = cam.tobytes()
        if outer or data != self._written:
            write_camera(self.camera, cam)
            self._written = None if outer else data
        return DeviceCamera(self.camera, slab_extras(cam))

    def __call__(self, state: FrameState, camera) -> FrameState:
        cam = check_camera(camera)
        planes = (state.accum, state.output, state.rng_state)
        outer = stream_capturing(self.device)
        if outer or state.tile_offset != self._cursor_at:
            self.cursor.fill_(state.tile_offset)
        self._cursor_at = None  # until the steps below are queued
        if not self.graphs:
            with _STEP_EAGER:
                graph_calls["eager"] += 1
                self._steps(cam, *planes)
            return self._advanced(state, outer)
        dcam = self._device_camera(cam, outer)
        key = (dcam.extras, tuple(0 if p is None else p.data_ptr()
                                  for p in planes))
        if outer or debug_checks():
            with _STEP_EAGER:
                graph_calls["eager"] += 1
                self._steps(dcam, *planes)
        elif self._graph is not None and self._graph[0] == key:
            with _STEP_REPLAY:
                replay(*self._graph[1:])
        elif self._warm == key:
            with _STEP_CAPTURE:
                self._graph = None  # its memory goes before the next capture
                graph, held = capture(lambda: self._steps(dcam, *planes),
                                      self.device)
                self._graph = (key, graph, held)
                replay(graph, held)
        else:
            with _STEP_EAGER:
                graph_calls["eager"] += 1
                self._graph = None
                self._steps(dcam, *planes)
                self._warm = key
        return self._advanced(state, outer)

    def _advanced(self, state: FrameState, outer: bool) -> FrameState:
        """`state` with its counters N steps on (the planes are shared),
        where the cursor stands once the call has run, unless an outer
        capture only recorded it."""
        offset = advance_offset(self.cfg, state.tile_offset, self.n)
        self._cursor_at = None if outer else offset
        return dataclasses.replace(state, tile_offset=offset,
                                   iteration=state.iteration + self.n)
