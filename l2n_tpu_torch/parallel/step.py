"""The sharded render step over the (tile, sample) mesh (counterpart of
l2n_tpu.parallel.step).

Each rank is one process holding one shard of the frame:

  accum   (4, h, Wp)  its sample replica of its slab's rows (the JAX
                      package's (n_sample, 4, Hp, Wp), P("sample", None,
                      "tile", None), one block per rank)
  output  (3, h, Wp)  its slab's display, the same on every replica
  rng     (S, h, Wp)  the slab's rows of the stateful modes' per-pixel
                      state planes (sample axis 1)
  tile offset, iteration: host ints, the same on every rank

with h = Hp / n_tile rows per slab. Slab `tile_rank` covers global rows
[tile_rank * h, (tile_rank + 1) * h) and renders under the random stream
sample_rank * n_tile + tile_rank: the slab extras of the packed camera
(camera/camera.py), which the kernels (sphere_pt, triangle_pt) and their
plain versions read. Each slab has its own shuffled schedule
(`slab_tile_grids`), and every step renders `effective_tiles_per_step` of
the *whole* frame's tiles from it, the JAX package's count. The slab's
sampler state and image are the single-card step's on a slab config
(height h, ndc_height the frame's), so a rank renders with no traffic.

The one collective of a step is the sample axis' fold: all_reduce(SUM) of
the scheduled pixels' accumulation over the rank's sample group, then
the display pow(max(rgb, 0) / max(n, 1e-20), gamma) (the JAX step's form)
written to those pixels of `output`. Each replica keeps its own `accum`.
Under gloo the fold runs on the tensors where they are (gloo reduces
CUDA tensors); `display` and the sessions gather through the host
(parallel/mesh.py).

A schedule that wraps (more tiles per step than a slab has, e.g.
whole-frame steps of the full frame over two slabs) names a tile more than
once. The JAX oracle merges the copies through its pixel mask, and the
JAX Pallas call's grid, the slab config's own tile count per step, takes
the schedule's first min(k, T_local) entries; two CUDA blocks on one tile
would race on its accumulation. So the step renders those distinct tiles,
each once, and still advances the offset by k mod T_local: the schedule
stays the JAX package's, and so does the image.

The sharded step renders one scheduler step per call, as the JAX
package's (no loop): `steps_per_call` does not apply to it. It renders
sphere and triangle scenes through the fused kernels (backend "cuda") or
their plain versions (backend "torch"), never through the wavefront step
(the JAX sharded step builds only the fused call), and takes no explicit
lights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from l2n_tpu_torch.camera.camera import slab_camera
from l2n_tpu_torch.ops.kernels.common import (
    check_camera,
    check_supported,
    tile_pixel_coords,
)
from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt, sphere_pt_plain
from l2n_tpu_torch.ops.kernels.triangle_pt import (
    TriangleBuffers,
    triangle_pt,
    triangle_pt_plain,
)
from l2n_tpu_torch.parallel.mesh import (
    gather_replicas,
    gather_slabs,
    mesh_coordinate,
    mesh_shape,
)
from l2n_tpu_torch.render.state import FrameState, init_rng_state
from l2n_tpu_torch.render.step import resolve_device
from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
from l2n_tpu_torch.scene.spheres import SphereScene
from l2n_tpu_torch.scene.tessellate import TriangleScene


@dataclasses.dataclass(frozen=True)
class ShardedFrameState:
    """One rank's shard (module doc); accum, output and rng_state are
    updated IN PLACE by a step, as the single-card FrameState's."""

    accum: torch.Tensor   # (4, h, Wp) f32, this rank's replica of its slab
    output: torch.Tensor  # (3, h, Wp) f32, the slab's display
    tile_offset: int
    iteration: int
    rng_state: torch.Tensor | None = None  # (S, h, Wp) i32, stateful modes


def slab_rows(cfg, n_tile: int) -> int:
    """Rows per slab, h = Hp / n_tile; ValueError unless n_tile divides
    the tile rows."""
    if n_tile < 1 or cfg.tile_count_y % n_tile != 0:
        raise ValueError(
            f"tile rows {cfg.tile_count_y} not divisible by tile axis {n_tile}")
    return cfg.padded_height // n_tile


def slab_config(cfg, n_tile: int):
    """The config a slab renders: h rows of the frame, whose NDC still
    spans the frame's height."""
    return cfg.replace(height=slab_rows(cfg, n_tile),
                       ndc_height=cfg.ndc_height or cfg.height)


def slab_tile_grids(cfg, n_tile: int) -> np.ndarray:
    """(n_tile, T_local, 2) int32: an independently shuffled schedule per
    row slab (slab-local tile coordinates), slab s shuffled with seed
    tile_shuffle_seed + s; the JAX package's, bit for bit."""
    rows = slab_rows(cfg, n_tile)
    grids = [tile_grid(cfg.replace(height=rows,
                                   tile_shuffle_seed=cfg.tile_shuffle_seed + s))
             for s in range(n_tile)]
    return np.stack(grids).astype(np.int32)


def _check_stateful(cfg, n_sample: int) -> None:
    # One stream per pixel (the reference's computeTinyMTStateVector): a
    # sample axis would have replicas retrace identical streams. Row slabs
    # are fine: the planes are the frame's, sliced by row.
    if cfg.rng_stateful and n_sample != 1:
        raise ValueError(
            "stateful parity samplers (tinymt/tauslcg) shard over 'tile' "
            "only: the reference's streams are per-pixel, so sample-axis "
            "replicas would duplicate them — use mesh sample=1 or a "
            "stateless sampler")


def init_slab_state(cfg, n_tile: int, tile_rank: int, device="cpu"
                    ) -> FrameState:
    """A zero slab of (tile_rank of n_tile) as a FrameState on `device`:
    the planes of `ShardedFrameState`, the rng planes the frame's rows of
    the slab."""
    h, w = slab_rows(cfg, n_tile), cfg.padded_width
    rng_state = init_rng_state(cfg)
    if rng_state is not None:
        rng_state = rng_state[:, tile_rank * h:(tile_rank + 1) * h]
        rng_state = rng_state.contiguous().to(device)
    return FrameState(
        accum=torch.zeros((4, h, w), dtype=torch.float32, device=device),
        output=torch.zeros((3, h, w), dtype=torch.float32, device=device),
        tile_offset=0, iteration=0, rng_state=rng_state)


def init_sharded_state(cfg, mesh, device=None) -> ShardedFrameState:
    """This rank's zero shard; ValueError for a stateful rng mode on a
    sample axis ("per-pixel", as the JAX package). `device`: the rank's
    renderer device (default: the current card for a CUDA mesh, else the
    CPU)."""
    shape = mesh_shape(mesh)
    _check_stateful(cfg, shape["sample"])
    tile_rank, _ = _coordinate(mesh)
    if device is None:
        device = _mesh_device(mesh)
    s = init_slab_state(cfg, shape["tile"], tile_rank, device)
    return ShardedFrameState(s.accum, s.output, 0, 0, s.rng_state)


def _coordinate(mesh) -> tuple[int, int]:
    coord = mesh_coordinate(mesh)
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh_shape(mesh)}")
    return coord


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class SlabStep:
    """step(state, packed_camera) -> FrameState over one slab: the body of
    the sharded step without the fold, which a rank runs on its shard and
    the tests run alone. `state` is a slab FrameState (`init_slab_state`);
    the camera is the frame's packed camera, to which the step adds the
    slab extras. Renders in place, as build_render_step's steps."""

    def __init__(self, cfg, scene, n_tile: int, tile_rank: int,
                 sample_rank: int = 0, backend: str = "cuda", device=None):
        check_supported(cfg)
        self.device = resolve_device(backend, device)
        self.slab_cfg = slab_config(cfg, n_tile)
        self.tiles = torch.as_tensor(
            slab_tile_grids(cfg, n_tile)[tile_rank]).to(self.device)
        self.k = cfg.effective_tiles_per_step
        self.row_offset = tile_rank * self.slab_cfg.height
        self.stream = sample_rank * n_tile + tile_rank
        if cfg.scene_kind == "sphere":
            if not isinstance(scene, SphereScene):
                raise TypeError("sphere config needs a SphereScene")
            self.buffers = scene.packed().to(self.device)
            self.kernel = sphere_pt if backend == "cuda" else sphere_pt_plain
        else:
            if isinstance(scene, TriangleScene):
                scene = TriangleBuffers.from_scene(scene, self.device)
            elif not isinstance(scene, TriangleBuffers):
                raise TypeError("triangle config needs a TriangleScene")
            self.buffers = scene
            self.kernel = (triangle_pt if backend == "cuda"
                           else triangle_pt_plain)

    def schedule(self, offset: int) -> torch.Tensor:
        """The distinct tiles of the step from `offset` (module doc)."""
        return scheduled_tiles(self.tiles, offset,
                               min(self.k, self.tiles.shape[0]))

    def __call__(self, state: FrameState, camera) -> FrameState:
        cam = slab_camera(check_camera(camera), self.row_offset, self.stream)
        self.kernel(self.slab_cfg, self.schedule(state.tile_offset), cam,
                    self.buffers, state.accum, state.output, state.rng_state)
        return dataclasses.replace(
            state,
            tile_offset=(state.tile_offset + self.k) % self.tiles.shape[0],
            iteration=state.iteration + 1)


class ShardedStep:
    """step(ShardedFrameState, packed_camera) -> ShardedFrameState for this
    rank (`build_sharded_step`): its slab through `body` (a SlabStep), then
    `fold`."""

    def __init__(self, cfg, body: SlabStep, group):
        self.body = body
        self.group = group  # the sample group; None on a sample axis of 1
        self.gamma = float(cfg.gamma)

    def fold(self, state: ShardedFrameState, sched: torch.Tensor) -> None:
        """The sample axis' fold over the pixels of the tiles `sched`
        (module doc): their accumulation summed over the sample group, then
        their display written to `state.output` IN PLACE."""
        cfg = self.body.slab_cfg
        row, col = tile_pixel_coords(cfg, sched)
        flat = (row * cfg.padded_width + col).reshape(-1)
        folded = state.accum.view(4, -1)[:, flat]
        if self.group is not None:
            dist.all_reduce(folded, op=dist.ReduceOp.SUM, group=self.group)
        display = torch.pow(
            torch.clamp(folded[:3], min=0.0)
            / torch.clamp(folded[3:4], min=1e-20), self.gamma)
        state.output.view(3, -1)[:, flat] = display

    def __call__(self, state: ShardedFrameState, camera) -> ShardedFrameState:
        sched = self.body.schedule(state.tile_offset)
        local = self.body(FrameState(state.accum, state.output,
                                     state.tile_offset, state.iteration,
                                     state.rng_state), camera)
        self.fold(state, sched)
        return dataclasses.replace(state, tile_offset=local.tile_offset,
                                   iteration=local.iteration)


def build_sharded_step(cfg, scene, mesh, backend: str = "cuda",
                       device=None) -> ShardedStep:
    """The sharded step of this rank (module doc): its slab through
    `SlabStep`, then the fold over its sample group. Every rank of the mesh
    calls the step once per scheduler step. backend "cuda" renders with the
    kernels on the rank's card (the current device unless `device` names
    one) and raises without a card; "torch" with the plain versions."""
    shape = mesh_shape(mesh)
    _check_stateful(cfg, shape["sample"])
    tile_rank, sample_rank = _coordinate(mesh)
    if device is None and backend == "cuda" and mesh.device_type == "cuda":
        device = _mesh_device(mesh)
    body = SlabStep(cfg, scene, shape["tile"], tile_rank, sample_rank,
                    backend, device)
    group = mesh.get_group("sample") if shape["sample"] > 1 else None
    return ShardedStep(cfg, body, group)


class ShardedRenderer:
    """One rank of a sharded progressive render, host side. Every rank
    of the mesh builds one and calls each method together: `step` folds
    over the sample groups, `display` and `save_session` gather to rank
    0."""

    def __init__(self, cfg, scene, mesh, backend: str = "cuda", device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.step_fn = build_sharded_step(cfg, scene, mesh, backend, device)
        self.state = init_sharded_state(cfg, mesh, self.step_fn.body.device)

    def step(self, camera) -> ShardedFrameState:
        """One scheduler step of the Camera `camera` (or its packed
        array)."""
        packed = camera.packed() if hasattr(camera, "packed") else camera
        self.state = self.step_fn(self.state, packed)
        return self.state

    def clear(self) -> None:
        """Zero this rank's accumulation (not the display, the offset or
        the rng states), as the JAX renderer's clear."""
        self.state.accum.zero_()

    def display(self) -> np.ndarray | None:
        """The (H, W, 3) float32 display image at rank 0 (None on the other
        ranks): the slabs of sample rank 0 gathered through the host or the
        card (parallel/mesh.py), then cropped."""
        tile, sample = _coordinate(self.mesh)
        if sample != 0:
            return None
        img = gather_slabs(self.mesh, self.state.output)
        if img is None:
            return None
        img = img[:, :self.cfg.height, :self.cfg.width].cpu().numpy()
        return np.moveaxis(img, 0, -1)

    def save_session(self, path, view_matrix=None):
        """Gather to rank 0, which writes the NPZ (utils/checkpoint.py)."""
        from l2n_tpu_torch.utils.checkpoint import save_sharded_session
        return save_sharded_session(path, self.cfg, self.state, self.mesh,
                                    view_matrix)

    def load_session(self, path):
        """Every rank reads its shard of the session into its live
        buffers; returns the view matrix (or None)."""
        from l2n_tpu_torch.utils.checkpoint import load_sharded_session
        cfg, state, view = load_sharded_session(path, self.mesh,
                                                self.state.accum.device)
        if cfg != self.cfg:
            raise ValueError("session config does not match renderer config")
        pairs = [(self.state.accum, state.accum),
                 (self.state.output, state.output)]
        if (self.state.rng_state is None) != (state.rng_state is None):
            raise ValueError("rng_state: the session is of another rng mode")
        if state.rng_state is not None:
            pairs.append((self.state.rng_state, state.rng_state))
        for dst, src in pairs:
            dst.copy_(src)
        self.state = dataclasses.replace(
            self.state, tile_offset=state.tile_offset,
            iteration=state.iteration)
        return view


def gather_state(mesh, state: ShardedFrameState
                 ) -> dict[str, np.ndarray] | None:
    """The frame's arrays at rank 0 as numpy (None on the other ranks):
    sharded_accum (n_sample, 4, Hp, Wp), output (3, Hp, Wp), tile_offset
    and iteration (0-d int32) and, for the stateful modes, rng_state (S,
    Hp, Wp) uint32. Every rank of the mesh calls it."""
    tile, sample = _coordinate(mesh)
    accum = gather_slabs(mesh, state.accum)
    if tile == 0:
        accum = gather_replicas(mesh, accum)
    output = rng_state = None
    if sample == 0:
        output = gather_slabs(mesh, state.output)
        if state.rng_state is not None:
            rng_state = gather_slabs(mesh, state.rng_state)
    if (tile, sample) != (0, 0):
        return None
    arrays = {"sharded_accum": accum.cpu().numpy(),
              "output": output.cpu().numpy(),
              "tile_offset": np.asarray(state.tile_offset, np.int32),
              "iteration": np.asarray(state.iteration, np.int32)}
    if rng_state is not None:
        arrays["rng_state"] = rng_state.cpu().numpy().view(np.uint32)
    return arrays
