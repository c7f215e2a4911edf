"""The wavefront sphere step: three CUDA kernels and their plain torch
versions (counterpart of l2n_tpu/ops/kernels/wavefront.py).

The fused step (sphere_pt.py) traces every sample's whole path in one
thread. The wavefront step, `RenderConfig(wavefront=True)`, cuts each path
after its first vertex:

  pass A  (`wavefront_pass_a`, csrc/wavefront.cu): per sample of every pixel
          of the scheduled tiles, the jittered primary ray (sweeping only
          the tile's cone-visible spheres), its first vertex and the b=0
          scatter + Russian roulette -> the partial radiance `col` and, for
          a path that ends there, `back` = 0, both by lane; each survivor's
          ray planes and meta (pixel, sample, lane) appended to a dense
          prefix of slots, counted in `n_alive` (zeroed by a memset first);
  pass B  (`wavefront_pass_b`): over the n_alive slots, the bounce
          continuation from the sampler's resume point, written to `back`
          at the survivor's lane (under NEE it goes on from the lane's
          `col`, pass A's direct light, writes the whole sum to `back`
          and 0 to `col`: the fused step's sum, to the bit);
  pass C  (`wavefront_pass_c`): per pixel, sum + colA + back per sample,
          then accumulate + tonemap IN PLACE.

On the card no torch operation runs between the passes: pass A's append is
the JAX step's compaction, pass B's write by lane its scatter-back, and
n_alive stays on the device (no host sync). The slot order changes from
run to run; the image does not. The plain pass A compacts in stable lane
order (`compact_survivors`, the JAX step's formula), which is the order the
kernel's append gives within a warp.

Lane arrays have the JAX package's layout (planes, K, spp * tile_height,
tile_width); see csrc/wavefront.cuh. The image equals the fused step's to
the bit: both compose the same path helpers (ops/pathtrace.py, csrc/
pathtrace.cuh) and the counter-based stream (threefry, or Philox for
rng="tpu_hw") resumes in pass B exactly where pass A stopped. The stateful
rng modes cannot resume across the split; RenderConfig refuses them with
the wavefront step, and the passes raise for them. Nor does it render a
slab of a sharded frame (l2n_tpu_torch.parallel): the JAX package's
sharded step builds only the fused kernels, and every pass here raises
ValueError for a camera whose slab extras (camera/camera.py, row offset
and stream) are not 0, rather than key a slab's pixels as the frame's.
The material modes,
the bump and NEE run through passes A and B (their resume point depends
on the mode and NEE: ops/pathtrace.wavefront_draw_position; pass A does
NEE at the first vertex, and under MIS a survivor carries the pdf of its
direction as a 10th ray plane); the explicit lights do not (render/step.py
raises for them, as the JAX package does).

A wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version (`*_plain`) for CPU tensors; `sphere_wavefront_step` chains
the wrappers (`backend="cuda"`, with the lane buffers a built step owns,
`wavefront_lanes`), `sphere_wavefront_step_plain` the plain versions
(`backend="torch"`, on any device).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from l2n_tpu_torch.ops.kernels.common import (
    accumulate_and_tonemap,
    camera_extras,
    check_schedule,
    check_step_camera,
    check_supported,
    check_tensor,
    host_camera,
    kernel_camera,
    launch,
    step_params,
    tile_pixel_coords,
)
from l2n_tpu_torch.ops.kernels.sphere_pt import check_spheres, max_spheres
from l2n_tpu_torch.ops.nee import sphere_light_sampler
from l2n_tpu_torch.ops.pathtrace import (
    WAVEFRONT_FAR_THRESHOLD,
    generate_rays,
    trace_wavefront_continue,
    trace_wavefront_primary,
    wavefront_draw_position,
)
from l2n_tpu_torch.ops.scenes import sphere_anyhit, sphere_intersector
from l2n_tpu_torch.rng.sampler import COUNTER_SAMPLERS, config_max_pairs
from l2n_tpu_torch.utils.profiling import Site

# The spans this module records (utils/profiling.py).
_KERNEL_WAVEFRONT_PASS_A = Site("kernel.wavefront_pass_a")
_KERNEL_CHECK = Site("kernel.check")
_KERNEL_WAVEFRONT_PASS_B = Site("kernel.wavefront_pass_b")
_KERNEL_WAVEFRONT_PASS_C = Site("kernel.wavefront_pass_c")

f32, i32 = torch.float32, torch.int32

# Pass A's block (csrc/wavefront.cu) holds sphere_pt's culled scene
# (sphere_pt.max_spheres); pass B stages no more per sphere (the SoA rows
# it reads and a packed copy of 4 words).
META_PLANES = 3


def ray_planes(cfg) -> int:
    """The survivors' ray planes: cast origin, direction and throughput,
    and under NEE with MIS the pdf of the direction (csrc/wavefront.cuh
    ray_planes; the JAX package's _ray_plane_count)."""
    return 10 if cfg.nee and cfg.mis else 9


class WavefrontLanes(NamedTuple):
    """Pass A's outputs. col and back (3, K, spp * th, tw) float32 by lane:
    the partial radiance, and 0 where the path ended in pass A (pass B
    writes the survivors' lanes; the plain pass A leaves NaN there). rays
    (ray_planes(cfg), n_lanes) float32 and meta (3, n_lanes) int32 by slot:
    the survivors in slots 0 .. n_alive - 1, meta holding pixel index,
    sample index and lane. n_alive (1,) int32, on the device."""
    col: torch.Tensor
    back: torch.Tensor
    rays: torch.Tensor
    meta: torch.Tensor
    n_alive: torch.Tensor


def _lane_shape(cfg, k: int, planes: int) -> tuple[int, int, int, int]:
    return (planes, k, cfg.spp_per_step * cfg.tile_height, cfg.tile_width)


def wavefront_lanes(cfg, k: int, device) -> WavefrontLanes:
    """Uninitialised pass A outputs for K scheduled tiles on `device`: the
    buffers a built step allocates once and passes to every step."""
    n = k * cfg.spp_per_step * cfg.tile_height * cfg.tile_width
    return WavefrontLanes(
        torch.empty(_lane_shape(cfg, k, 3), dtype=f32, device=device),
        torch.empty(_lane_shape(cfg, k, 3), dtype=f32, device=device),
        torch.empty((ray_planes(cfg), n), dtype=f32, device=device),
        torch.empty((META_PLANES, n), dtype=i32, device=device),
        torch.empty((1,), dtype=i32, device=device))


def _scene(cfg, spheres: torch.Tensor):
    cx, cy, cz, r2 = spheres[0], spheres[1], spheres[2], spheres[3]
    return (sphere_intersector(cx, cy, cz, r2, cfg.fast_math),
            sphere_anyhit(cx, cy, cz, r2), spheres[4:].T)


def _light_sampler(cfg, spheres: torch.Tensor):
    """The plain passes' NEE light sampler; None without NEE."""
    return sphere_light_sampler(cfg, spheres) if cfg.nee else None


def _check_spheres(cfg, spheres, device) -> int:
    n = check_spheres(spheres, device)
    if device.type == "cuda" and n > max_spheres(cfg):
        raise ValueError(f"wavefront: {n} spheres exceed the kernels' shared "
                         f"memory ({max_spheres(cfg)} max)")
    return n


def _check_lanes(cfg, k: int, lanes: WavefrontLanes, device) -> None:
    n = k * cfg.spp_per_step * cfg.tile_height * cfg.tile_width
    for name, shape, dtype in (("col", _lane_shape(cfg, k, 3), f32),
                               ("back", _lane_shape(cfg, k, 3), f32),
                               ("rays", (ray_planes(cfg), n), f32),
                               ("meta", (META_PLANES, n), i32),
                               ("n_alive", (1,), i32)):
        check_tensor(name, getattr(lanes, name), dtype, shape, device)


def _sampler_class(cfg):
    """The counter-based sampler of cfg.rng; the stateful modes raise, and
    so does fog, with the config's own error of fog + wavefront: the split
    takes no fog work."""
    if cfg.fog_density > 0.0:
        cfg.replace(wavefront=True).validate()
    if cfg.rng not in COUNTER_SAMPLERS:
        raise ValueError(f"wavefront: rng={cfg.rng!r} is stateful; the "
                         "wavefront passes need a stateless sampler "
                         "(threefry or tpu_hw)")
    return COUNTER_SAMPLERS[cfg.rng]


def _device(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return t.device


def _whole_frame_camera(camera, device: torch.device):
    """common.check_step_camera, and ValueError for a slab's camera
    (module doc)."""
    camera = check_step_camera(camera, device)
    if camera_extras(camera) != (0, 0):
        raise ValueError(f"wavefront: no slab of a sharded frame (row offset "
                         f"and stream {camera_extras(camera)}); a slab "
                         "renders through sphere_pt")
    return camera


# ---------------------------------------------------------------------------
# Pass A
# ---------------------------------------------------------------------------

def wavefront_pass_a(cfg, sched: torch.Tensor, camera, spheres: torch.Tensor,
                     accum: torch.Tensor,
                     lanes: WavefrontLanes | None = None) -> WavefrontLanes:
    """Primary cast, first vertex, b=0 scatter over the scheduled tiles, and
    the survivors' append.

    sched (K, 2) int32; camera the packed (10, 4) host array or a
    common.DeviceCamera (sphere_pt.sphere_pt); spheres (13, n) float32
    (SphereScene.packed()); accum (4, Hp, Wp), read for the sample counts. On the card the
    outputs go to `lanes` (`wavefront_lanes`), or to new buffers; on the
    CPU the plain version returns new ones."""
    with _KERNEL_WAVEFRONT_PASS_A:
        with _KERNEL_CHECK:
            check_supported(cfg)
            _sampler_class(cfg)
            dev = _device(accum, "wavefront_pass_a")
            k = check_schedule(cfg, sched, accum)
            camera = _whole_frame_camera(camera, dev)
            n = _check_spheres(cfg, spheres, dev)
        if dev.type == "cpu":
            return wavefront_pass_a_plain(cfg, sched, camera, spheres, accum)
        if lanes is None:
            lanes = wavefront_lanes(cfg, k, dev)
        with _KERNEL_CHECK:
            _check_lanes(cfg, k, lanes, dev)
        camera = kernel_camera(camera, dev)
        ip, fp = step_params(cfg, k, n, camera)
        launch("wavefront_pass_a", cfg, dev, ip, fp, camera.buffer, sched,
               spheres, accum, *lanes)
        return lanes


def primary_lanes_plain(cfg, sched: torch.Tensor, camera,
                        spheres: torch.Tensor, accum: torch.Tensor):
    """Every lane of pass A in lane order, before the append: (rays
    (ray_planes(cfg), K, spp*th, tw) float32, dead lanes parked at 3e30;
    col (3, ...) float32;
    meta (2, ...) int32, pixel and sample index). Lockstep over the pixels
    of the scheduled tiles, one sample at a time (lanes in the fused plain
    step's order, so every operation sees the same vectors)."""
    dev = accum.device
    sampler_cls = _sampler_class(cfg)
    intersect, _, albedo = _scene(cfg, spheres)
    nee = _light_sampler(cfg, spheres)
    cam = torch.as_tensor(host_camera(_whole_frame_camera(camera, dev)))
    cam = cam.to(dev)
    k, th, tw, spp = (sched.shape[0], cfg.tile_height, cfg.tile_width,
                      cfg.spp_per_step)
    row, col = tile_pixel_coords(cfg, sched)
    flat = (row * cfg.padded_width + col).reshape(-1)  # also the pixel index
    sample_index = accum[3].reshape(-1)[flat].to(i32)
    rowf = row.reshape(-1).to(f32)
    colf = col.reshape(-1).to(f32)
    planes = ray_planes(cfg)
    rays = torch.empty((planes, k, spp, th, tw), dtype=f32, device=dev)
    rgb = torch.empty((3, k, spp, th, tw), dtype=f32, device=dev)
    meta = torch.empty((2, k, spp, th, tw), dtype=i32, device=dev)
    for s in range(spp):
        sampler = sampler_cls(cfg.seed, 0, flat, sample_index + s,
                              config_max_pairs(cfg))
        u1, u2 = sampler.draw2()  # pixel jitter
        out = trace_wavefront_primary(
            cfg, intersect, albedo, sampler,
            *generate_rays(cfg, cam, colf, rowf, u1, u2), nee)
        rgb[:, :, s] = torch.stack(out[:3]).view(3, k, th, tw)
        rays[:, :, s] = torch.stack(out[3:]).view(planes, k, th, tw)
        meta[0, :, s] = flat.to(i32).view(k, th, tw)
        meta[1, :, s] = (sample_index + s).view(k, th, tw)
    return (rays.view(_lane_shape(cfg, k, planes)),
            rgb.view(_lane_shape(cfg, k, 3)), meta.view(_lane_shape(cfg, k, 2)))


def wavefront_pass_a_plain(cfg, sched: torch.Tensor, camera,
                           spheres: torch.Tensor,
                           accum: torch.Tensor) -> WavefrontLanes:
    """The plain torch version of `wavefront_pass_a`: every lane
    (`primary_lanes_plain`), then the stable compaction
    (`compact_survivors`). back is 0 at the dead lanes and NaN at the
    survivors' (pass B writes those); the slots past n_alive hold the dead
    lanes in lane order."""
    rays, col, meta = primary_lanes_plain(cfg, sched, camera, spheres, accum)
    comp, comp_meta, n_alive = compact_survivors(rays, meta)
    back = torch.where(rays[:1] < WAVEFRONT_FAR_THRESHOLD, float("nan"), 0.0)
    return WavefrontLanes(col, back.expand_as(col).contiguous(), comp,
                          comp_meta, n_alive)


def compact_survivors(rays: torch.Tensor, meta: torch.Tensor):
    """Move the alive lanes (cast_ox < 1e30) to a dense prefix, in stable
    lane order: the JAX step's rank permutation (perm: alive lanes to their
    rank, dead lanes after them) and its inverse.

    rays (planes, ...) and meta (2, ...) in lane layout. Returns (comp
    (planes, n_lanes), comp_meta (3, n_lanes) int32, whose third plane is
    each slot's
    lane, n_alive (1,) int32). Every operation stays on the rays' device;
    nothing is read back."""
    planes = rays.shape[0]
    raysf = rays.reshape(planes, -1)
    n = raysf.shape[1]
    alive = raysf[0] < WAVEFRONT_FAR_THRESHOLD
    rank = torch.cumsum(alive, 0, dtype=torch.int64) - 1
    n_alive = rank[-1:] + 1
    iota = torch.arange(n, dtype=torch.int64, device=rays.device)
    perm = torch.where(alive, rank, n_alive + iota - rank - 1)
    inv = torch.empty_like(perm).scatter_(0, perm, iota)
    comp = raysf.index_select(1, inv)
    comp_meta = torch.cat([meta.reshape(2, n).index_select(1, inv),
                           inv[None].to(i32)])
    return comp, comp_meta, n_alive.to(i32)


# ---------------------------------------------------------------------------
# Pass B
# ---------------------------------------------------------------------------

def wavefront_pass_b(cfg, camera, spheres: torch.Tensor, rays: torch.Tensor,
                     meta: torch.Tensor, n_alive: torch.Tensor,
                     back: torch.Tensor, col: torch.Tensor | None = None
                     ) -> None:
    """Finish the survivors' paths and write each contribution to `back` at
    its lane, IN PLACE; under NEE the path goes on from `col` at the lane
    (pass A's radiance, then set to 0 there), so `back` gets its whole sum.

    rays (ray_planes(cfg), n_lanes) float32 and meta (3, n_lanes) int32 hold
    the survivors in their first n_alive slots (a (1,) int32 tensor on the
    same device, read by the kernel, never by the host); back and col (3,
    K, spp*th, tw) float32 by lane, as pass A returns them (col only under
    NEE)."""
    with _KERNEL_WAVEFRONT_PASS_B:
        with _KERNEL_CHECK:
            check_supported(cfg)
            _sampler_class(cfg)
            dev = _device(rays, "wavefront_pass_b")
            camera = _whole_frame_camera(camera, dev)
            n = _check_spheres(cfg, spheres, dev)
            n_lanes = rays.shape[1] if isinstance(rays, torch.Tensor) else -1
            check_tensor("rays", rays, f32, (ray_planes(cfg), n_lanes), dev)
            check_tensor("meta", meta, i32, (META_PLANES, n_lanes), dev)
            check_tensor("n_alive", n_alive, i32, (1,), dev)
            per_tile = cfg.spp_per_step * cfg.tile_height * cfg.tile_width
            if n_lanes < per_tile or n_lanes % per_tile:
                raise ValueError(f"rays: {n_lanes} lanes are not whole tiles "
                                 f"of {per_tile}")
            k = n_lanes // per_tile
            check_tensor("back", back, f32, _lane_shape(cfg, k, 3), dev)
            if cfg.nee:
                check_tensor("col", col, f32, _lane_shape(cfg, k, 3), dev)
        if dev.type == "cpu":
            wavefront_pass_b_plain(cfg, camera, spheres, rays, meta, n_alive,
                                   back, col)
            return
        next_pair, has_spare = wavefront_draw_position(cfg)
        ip, fp = step_params(cfg, k, n, camera)
        launch("wavefront_pass_b", cfg, dev, ip, fp, next_pair, int(has_spare),
               n_alive, spheres, rays, meta, col if cfg.nee else None, back)


def wavefront_pass_b_plain(cfg, camera, spheres: torch.Tensor,
                           rays: torch.Tensor, meta: torch.Tensor,
                           n_alive: torch.Tensor, back: torch.Tensor,
                           col: torch.Tensor | None = None) -> None:
    """The plain torch version of `wavefront_pass_b`: the continuation of
    every slot in lockstep, the slots past n_alive included (as the Pallas
    kernel's blocks compute their padding lanes), then the first n_alive
    written to back at their lanes (`write_back`), so no host read of
    n_alive is needed; under NEE from `col` at those lanes, which then
    hold 0."""
    _whole_frame_camera(camera, meta.device)  # the stream is 0
    intersect, anyhit, albedo = _scene(cfg, spheres)
    nee = _light_sampler(cfg, spheres)
    next_pair, has_spare = wavefront_draw_position(cfg)
    sampler = _sampler_class(cfg).resumed(
        cfg.seed, 0, meta[0], meta[1],
        config_max_pairs(cfg), next_pair, has_spare)
    start = None
    if nee is not None:
        n = meta.shape[1]
        slot = torch.arange(n, device=meta.device)
        lane = torch.where(slot < n_alive, meta[2].to(torch.int64), 0)
        start = col.view(3, -1)[:, lane]
    contrib = torch.stack(trace_wavefront_continue(
        cfg, intersect, anyhit, albedo, sampler, *rays, nee=nee, col=start))
    write_back(back, contrib, meta, n_alive)
    if nee is not None:
        write_back(col, torch.zeros_like(contrib), meta, n_alive)


def write_back(back: torch.Tensor, contrib: torch.Tensor, meta: torch.Tensor,
               n_alive: torch.Tensor) -> None:
    """back[:, meta[2, j]] = contrib[:, j] for the slots j < n_alive, IN
    PLACE. The slots past n_alive go to a spare column, never a lane (their
    lane plane may hold anything), so nothing is read back to the host."""
    n = contrib.shape[1]
    backf = back.view(3, -1)
    slot = torch.arange(n, device=contrib.device)
    lane = torch.where(slot < n_alive, meta[2].to(torch.int64), n)
    padded = torch.cat([backf, backf.new_zeros((3, 1))], 1)
    padded.scatter_(1, lane.expand(3, n), contrib)
    backf.copy_(padded[:, :n])


# ---------------------------------------------------------------------------
# Pass C
# ---------------------------------------------------------------------------

def wavefront_pass_c(cfg, sched: torch.Tensor, col: torch.Tensor,
                     back: torch.Tensor, accum: torch.Tensor,
                     output: torch.Tensor) -> None:
    """Per pixel of the scheduled tiles: per sample sum + colA + back,
    then accum += (sum, spp) and output = gamma(rgb / n), IN PLACE. col and
    back are (3, K, spp*th, tw) float32 lane arrays."""
    with _KERNEL_WAVEFRONT_PASS_C:
        with _KERNEL_CHECK:
            check_supported(cfg)
            dev = _device(accum, "wavefront_pass_c")
            k = check_schedule(cfg, sched, accum, output)
            for name, t in (("col", col), ("back", back)):
                check_tensor(name, t, f32, _lane_shape(cfg, k, 3), dev)
        if dev.type == "cpu":
            wavefront_pass_c_plain(cfg, sched, col, back, accum, output)
            return
        # Pass C reads the tile shape, spp and gamma; no scene, no camera.
        ip, fp = step_params(cfg, k, 0, np.zeros((10, 4), np.float32))
        launch("wavefront_pass_c", cfg, dev, ip, fp, sched, col, back, accum,
               output)


def wavefront_pass_c_plain(cfg, sched: torch.Tensor, col: torch.Tensor,
                           back: torch.Tensor, accum: torch.Tensor,
                           output: torch.Tensor) -> None:
    """The plain torch version of `wavefront_pass_c` (lanes in the fused
    plain step's order)."""
    k, th, tw = sched.shape[0], cfg.tile_height, cfg.tile_width
    row, c = tile_pixel_coords(cfg, sched)
    flat = (row * cfg.padded_width + c).reshape(-1)
    spp = cfg.spp_per_step
    col = col.view(3, k, spp, th, tw)
    back = back.view(3, k, spp, th, tw)
    sums = [torch.zeros(flat.shape, dtype=f32, device=accum.device)
            for _ in range(3)]
    for s in range(spp):
        sums = [sums[ch] + col[ch, :, s].reshape(-1)
                + back[ch, :, s].reshape(-1) for ch in range(3)]
    accumulate_and_tonemap(cfg, accum, output, flat, sums, spp)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _step(passes, cfg, sched, camera, spheres, accum, output,
          rng_state, **lanes) -> None:
    if rng_state is not None:
        raise ValueError("wavefront: the counter-based samplers keep no "
                         "rng_state planes")
    pass_a, pass_b, pass_c = passes
    a = pass_a(cfg, sched, camera, spheres, accum, **lanes)
    pass_b(cfg, camera, spheres, a.rays, a.meta, a.n_alive, a.back, a.col)
    pass_c(cfg, sched, a.col, a.back, accum, output)


def sphere_wavefront_step(cfg, sched: torch.Tensor, camera,
                          spheres: torch.Tensor, accum: torch.Tensor,
                          output: torch.Tensor, rng_state=None,
                          lanes: WavefrontLanes | None = None) -> None:
    """One wavefront render step over the scheduled tiles, updating accum
    and output IN PLACE (the arguments of sphere_pt.sphere_pt): the three
    kernels on CUDA tensors, their plain versions on CPU tensors. `lanes`
    (`wavefront_lanes`) are the kernels' buffers, reused from step to step;
    without them each step allocates its own."""
    _step((wavefront_pass_a, wavefront_pass_b, wavefront_pass_c), cfg, sched,
          camera, spheres, accum, output, rng_state, lanes=lanes)


def sphere_wavefront_step_plain(cfg, sched: torch.Tensor, camera,
                                spheres: torch.Tensor, accum: torch.Tensor,
                                output: torch.Tensor,
                                rng_state=None) -> None:
    """The same step through the three plain versions, on any device."""
    check_supported(cfg)
    camera = host_camera(camera)
    _step((wavefront_pass_a_plain, wavefront_pass_b_plain,
           wavefront_pass_c_plain), cfg, sched, camera, spheres, accum,
          output, rng_state)
