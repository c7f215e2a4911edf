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
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from l2n_tpu_torch.ops.kernels.common import check_supported
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
from l2n_tpu_torch.render.tiles import advance_offset, scheduled_tiles, tile_grid
from l2n_tpu_torch.scene.spheres import SphereScene
from l2n_tpu_torch.scene.tessellate import TriangleScene

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
                      lights: ExplicitLights | None = None):
    """A step(state, packed_camera) -> FrameState for (config, scene).

    `scene` is a SphereScene or a TriangleScene, per cfg.scene_kind, whose
    buffers move to the step's device once; or, for meshes, TriangleBuffers
    already packed on that device (e.g. with other tables,
    TriangleBuffers.with_tables). The camera is the packed
    (10, 4) host array (Camera.packed()). `lights`: see the module doc.
    """
    check_supported(cfg)
    device = resolve_device(backend, device)
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
    k = cfg.effective_tiles_per_step

    def step(state: FrameState, camera) -> FrameState:
        sched = scheduled_tiles(tiles, state.tile_offset, k)
        kernel(cfg, sched, np.asarray(camera, np.float32), buffers,
               state.accum, state.output, state.rng_state)
        return dataclasses.replace(
            state, tile_offset=advance_offset(cfg, state.tile_offset),
            iteration=state.iteration + 1)

    return step
