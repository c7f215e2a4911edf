"""The one general generator: drives `Renderer.step(camera)` as a traffic
mix's parameters say (traffic/<mix>.json), and records what the metrics
read.

Parameters of a mix:
  * camera: "still" (the configuration's view for every call) or "orbit"
    (each frame the view turns `deg_per_frame` degrees about the world's
    vertical axis through the origin, keeping the view's distance, height
    and pitch; the starting angle is the seed modulo 360 degrees);
  * tiles_per_step, spp_per_step: the schedule, set on the configuration;
  * steps_per_call: scheduler steps per `Renderer.step` call (more than
    one: a CUDA-graph replay of them);
  * clear_each_frame: `Renderer.on_camera_moved()` before each call;
  * sync_each_frame: a frame ends when the device has finished it (a
    synchronize, as a viewer would wait to present it); each frame is
    timed on the host clock from the camera update to that point.

A call is snapshotted for the output check (check.py) at times drawn from
the seed: the frame planes are copied on the device before and after it,
in stream order, so nothing waits on the host.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time

import numpy as np
import torch


# Calls the host may run ahead of the device: the next call waits for the
# one this many calls back, so that the launch queue never fills and the
# window closes a few calls after its deadline.
IN_FLIGHT = 3


@dataclasses.dataclass
class Snapshot:
    """The frame planes around one call: `steps_before` scheduler steps ran
    since the state was made, the last clear came after `clear_step` of
    them, `view` is the call's (4, 4) view matrix, `rgb_before` the
    radiance sums before the call (None where the call starts from a
    clear), `accum` and `output` the planes after it."""

    steps_before: int
    clear_step: int
    view: np.ndarray
    rgb_before: torch.Tensor | None
    accum: torch.Tensor
    output: torch.Tensor


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    calls: int = 0
    samples: int = 0
    launches: int = 0
    host_call_ms: list = dataclasses.field(default_factory=list)
    frame_ms: list = dataclasses.field(default_factory=list)
    host_frame_ms: list = dataclasses.field(default_factory=list)
    device_ms: float | None = None  # CUDA-event ms summed over the calls


def orbit_view(view0: np.ndarray, degrees: float) -> np.ndarray:
    """The view `view0` with the camera turned by `degrees` about the world
    y axis through the origin: view0 @ R_y(degrees)^T, in float64."""
    a = math.radians(degrees)
    c, s = math.cos(a), math.sin(a)
    rot = np.array([[c, 0.0, s, 0.0], [0.0, 1.0, 0.0, 0.0],
                    [-s, 0.0, c, 0.0], [0.0, 0.0, 0.0, 1.0]])
    return (np.asarray(view0, np.float64) @ rot.T).astype(np.float32)


class Generator:
    """Feeds one renderer the calls of a mix; `steps` counts the scheduler
    steps run since the renderer's state was made."""

    def __init__(self, mix: dict, renderer, camera_of, view0: np.ndarray,
                 seed: int, samples_per_step: int, device):
        self.mix = mix
        self.renderer = renderer
        self.camera_of = camera_of  # view matrix -> the port's Camera
        self.view0 = np.asarray(view0, np.float32)
        self.orbit = mix["camera"] == "orbit"
        if mix["camera"] not in ("still", "orbit"):
            raise ValueError(f"unknown camera motion {mix['camera']!r}")
        self.angle0 = float(seed % 360)
        self.spc = int(mix["steps_per_call"])
        self.samples_per_step = samples_per_step
        self.device = device
        self.steps = 0
        self.frames = 0
        self.clear_step = 0
        self.still_camera = camera_of(self.view0)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def view(self) -> np.ndarray:
        if not self.orbit:
            return self.view0
        return orbit_view(self.view0, self.angle0
                          + self.frames * float(self.mix["deg_per_frame"]))

    def call(self, window: Window | None = None, snapshot: bool = False,
             events=None, label=None) -> Snapshot | None:
        """One call of the mix (a frame); returns its snapshot if asked."""
        view = self.view()
        t0 = time.perf_counter()
        with _label(label, "camera"):
            camera = self.camera_of(view) if self.orbit else self.still_camera
        if self.mix.get("clear_each_frame"):
            with _label(label, "clear"):
                self.renderer.on_camera_moved()
            self.clear_step = self.steps
        before = None
        if snapshot and self.clear_step != self.steps:
            before = self.renderer.state.accum[:3].clone()
        if events is not None:
            events[0].record()
        t1 = time.perf_counter()
        with _label(label, "renderer.step"):
            st = self.renderer.step(camera)
        t2 = time.perf_counter()
        if events is not None:
            events[1].record()
        if self.mix.get("sync_each_frame"):
            with _label(label, "synchronize"):
                self._sync()
        t3 = time.perf_counter()
        snap = None
        if snapshot:
            snap = Snapshot(self.steps, self.clear_step, view, before,
                            st.accum.clone(), st.output.clone())
            if self.mix.get("sync_each_frame"):
                self._sync()  # the copies stay out of the next frame's time
        if window is not None:
            window.calls += 1
            window.launches += self.spc
            window.samples += self.spc * self.samples_per_step
            window.host_call_ms.append((t2 - t1) * 1e3)
            if self.mix.get("sync_each_frame"):
                window.frame_ms.append((t3 - t0) * 1e3)
                window.host_frame_ms.append((t2 - t0) * 1e3)
        self.steps += self.spc
        self.frames += 1
        return snap

    def run(self, seconds: float, snap_times=(), timed_events=False,
            label=None) -> tuple[Window, list]:
        """Calls for `seconds` (a call that a due snapshot waits for runs
        past them), at most IN_FLIGHT of them ahead of the device; returns
        the window's record and its snapshots. The window ends with a
        synchronize. With `timed_events`, CUDA events around every call
        give the device time of the calls. `label` names the host phases
        for a traced stretch."""
        win = Window()
        due = sorted(snap_times)
        snaps = []
        pairs = []
        flight = collections.deque()
        self._sync()
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            now = time.perf_counter()
            # A snapshot still due at the deadline takes the next call.
            take = bool(due) and (now - t_start >= due[0] or now >= deadline)
            if now >= deadline and not take:
                break
            if len(flight) >= IN_FLIGHT:
                flight.popleft().synchronize()
            events = None
            if timed_events:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                pairs.append(events)
            snap = self.call(win, snapshot=take, events=events, label=label)
            if self.device.type == "cuda":
                flight.append(torch.cuda.Event())
                flight[-1].record()
            if take:
                due.pop(0)
                snaps.append(snap)
        self._sync()
        win.seconds = time.perf_counter() - t_start
        if pairs:
            win.device_ms = sum(a.elapsed_time(b) for a, b in pairs)
        return win, snaps


def _label(label, name):
    """A torch.profiler range named `name` while a traced stretch runs."""
    if label is None:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"{label}.{name}")
