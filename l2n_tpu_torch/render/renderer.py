"""Renderer: owns frame state + programs, drives progressive steps
(counterpart of l2n_tpu.render.renderer): current program, clear-on-switch,
clear-on-move, step timing, and loading a state into the live buffers.

A program's step may run several scheduler steps per call
(`steps_per_call`); `metrics` divides a call's time by them, so its figures
stay per scheduler step. (The JAX package's `metrics` does not: its
figures are per call; ROADMAP Queue 3 #17.)"""

from __future__ import annotations

import time

import numpy as np
import torch

from l2n_tpu_torch.camera.camera import Camera
from l2n_tpu_torch.render.program import PathtracingProgram
from l2n_tpu_torch.render.state import (
    FrameState,
    clear_accumulation,
    display_image,
    init_frame_state,
    load_state,
)
from l2n_tpu_torch.utils.profiling import Site

# The spans this module records (utils/profiling.py).
_RENDERER_CLEAR = Site("renderer.clear")
_RENDERER_SYNC = Site("renderer.sync")
_RENDERER_STEP = Site("renderer.step")


class Renderer:
    def __init__(self, programs: dict[str, PathtracingProgram],
                 current: str | None = None):
        if not programs:
            raise ValueError("need at least one program")
        self.programs = programs
        self.current = current or next(iter(programs))
        self.state: FrameState = init_frame_state(self.program.cfg,
                                                  self.program.device)
        self._step_times: list[float] = []
        self._warm: set[str] = set()

    @property
    def program(self) -> PathtracingProgram:
        return self.programs[self.current]

    @property
    def cfg(self):
        return self.program.cfg

    def switch(self, name: str) -> None:
        """Renderer switch => clear accumulation."""
        if name not in self.programs:
            raise KeyError(name)
        if name != self.current:
            self.current = name
            with _RENDERER_CLEAR:
                self.state = clear_accumulation(self.state)

    def on_camera_moved(self) -> None:
        """Camera moved => clear accumulation."""
        with _RENDERER_CLEAR:
            self.state = clear_accumulation(self.state)

    def load_state(self, state: FrameState) -> None:
        """Make `state` (e.g. a loaded session, on any device) the live
        state by copying it into the live buffers, which the programs'
        step graphs keep (render/state.load_state)."""
        self.state = load_state(self.state, state)

    def _sync(self) -> None:
        if self.state.accum.is_cuda:
            with _RENDERER_SYNC:
                torch.cuda.synchronize(self.state.accum.device)

    def step(self, camera: Camera, block: bool = False) -> FrameState:
        """One progressive step. With block=True the device finishes the
        step before this returns, so the recorded time is the step's; else
        it is the host's dispatch of it."""
        with _RENDERER_STEP:
            t0 = time.perf_counter()
            self.state = self.program.step(self.state, camera.packed())
            if block:
                self._sync()
            if self.current in self._warm:
                self._step_times.append(time.perf_counter() - t0)
            else:
                # The first step of a program pays the kernel build/load.
                self._warm.add(self.current)
            if len(self._step_times) > 240:
                del self._step_times[:120]
            return self.state

    def display(self) -> np.ndarray:
        """(H, W, 3) float32 tonemapped image on the host, cropped."""
        return display_image(self.cfg, self.state)

    def metrics(self) -> dict[str, float]:
        """Per scheduler step, over the last 120 timed calls of `step`: the
        host clock around each call, which is the host's dispatch of the
        step unless the call passed block=True (then the device's finishing
        it too). Where the host's time goes inside a call, and the device's
        idle time beside it, are for the spans (utils/profiling.py) under
        torch.profiler."""
        cfg = self.cfg
        times = self._step_times[-120:] or [float("nan")]
        ms = float(np.mean(times)) * 1e3 / self.program.steps_per_call
        pixels_per_step = (cfg.effective_tiles_per_step
                           * cfg.tile_height * cfg.tile_width)
        samples_per_step = pixels_per_step * cfg.spp_per_step
        return {
            "ms_per_step": ms,
            "fps": 1e3 / ms if ms > 0 else float("nan"),
            "samples_per_sec": samples_per_step / (ms * 1e-3),
            "spp_per_sec": samples_per_step / (ms * 1e-3)
            / (cfg.width * cfg.height),
            "iteration": int(self.state.iteration),
        }
