"""The wavefront sphere step: three CUDA kernels, the compaction between
them, and their plain torch versions (counterpart of
l2n_tpu/ops/kernels/wavefront.py).

The fused step (sphere_pt.py) traces every sample's whole path in one
thread. The wavefront step, `RenderConfig(wavefront=True)`, cuts each path
after its first vertex:

  pass A  (`wavefront_pass_a`, csrc/wavefront.cu): per sample of every pixel
          of the scheduled tiles, the jittered primary ray, its first vertex
          and the b=0 scatter + Russian roulette -> continuation planes,
          partial radiance, meta planes (pixel and sample index);
  compact (`compact_survivors`, torch ops on the device): the alive flag
          (cast_ox < 1e30), a cumsum, the stable rank permutation and its
          inverse, one gather of the ray and meta planes into a dense prefix
          of n_alive lanes; n_alive stays on the device (no host sync);
  pass B  (`wavefront_pass_b`): one thread per compacted lane, the bounce
          continuation from the sampler's resume point;
  back    (`scatter_back`): the contributions gathered back to lane order,
          zero where no path went on;
  pass C  (`wavefront_pass_c`): per pixel, sum + colA + contrib per sample,
          then accumulate + tonemap IN PLACE.

Lane arrays have the JAX package's layout (planes, K, spp * tile_height,
tile_width); see csrc/wavefront.cuh. The image equals the fused step's to
the bit: both compose the same path helpers (ops/pathtrace.py, csrc/
pathtrace.cuh) and the counter-based stream (threefry, or Philox for
rng="tpu_hw") resumes in pass B exactly where pass A stopped. The stateful
rng modes cannot resume across the compaction; RenderConfig refuses them
with the wavefront step, and the passes raise for them.

A wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version (`*_plain`) for CPU tensors; `sphere_wavefront_step` chains
the wrappers (`backend="cuda"`), `sphere_wavefront_step_plain` the plain
versions (`backend="torch"`, on any device).
"""

from __future__ import annotations

import numpy as np
import torch

from l2n_tpu_torch.ops.kernels.common import (
    accumulate_and_tonemap,
    check_camera,
    check_schedule,
    check_supported,
    check_tensor,
    launch,
    step_params,
    tile_pixel_coords,
)
from l2n_tpu_torch.ops.pathtrace import (
    WAVEFRONT_FAR_THRESHOLD,
    generate_rays,
    trace_wavefront_continue,
    trace_wavefront_primary,
    wavefront_draw_position,
)
from l2n_tpu_torch.ops.scenes import sphere_anyhit, sphere_intersector
from l2n_tpu_torch.rng.sampler import COUNTER_SAMPLERS, max_pairs_per_sample

f32, i32 = torch.float32, torch.int32

# Passes A and B stage the (7, n) scene into shared memory without opting
# in to more than the default 48 KiB of dynamic shared memory per block.
MAX_SPHERES = (48 * 1024) // (7 * 4)


def _ray_plane_count(cfg) -> int:
    """Cast origin (3) + direction (3) + throughput (3), and the BSDF pdf
    under NEE+MIS (not in the port). The alive flag costs no plane: alive
    <=> cast_ox < WAVEFRONT_FAR_THRESHOLD."""
    return 10 if (cfg.nee and cfg.mis) else 9


def _lane_shape(cfg, k: int, planes: int) -> tuple[int, int, int, int]:
    return (planes, k, cfg.spp_per_step * cfg.tile_height, cfg.tile_width)


def _scene(spheres: torch.Tensor):
    cx, cy, cz, r2 = spheres[0], spheres[1], spheres[2], spheres[3]
    return (sphere_intersector(cx, cy, cz, r2), sphere_anyhit(cx, cy, cz, r2),
            spheres[4:7].T)


def _check_spheres(spheres, device) -> int:
    n = spheres.shape[1] if isinstance(spheres, torch.Tensor) else -1
    check_tensor("spheres", spheres, f32, (7, n), device)
    if device.type == "cuda" and n > MAX_SPHERES:
        raise ValueError(f"wavefront: {n} spheres exceed the kernels' shared "
                         f"memory ({MAX_SPHERES} max)")
    return n


def _sampler_class(cfg):
    """The counter-based sampler of cfg.rng; the stateful modes raise."""
    if cfg.rng not in COUNTER_SAMPLERS:
        raise ValueError(f"wavefront: rng={cfg.rng!r} is stateful; the "
                         "wavefront passes need a stateless sampler "
                         "(threefry or tpu_hw)")
    return COUNTER_SAMPLERS[cfg.rng]


def _device(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return t.device


# ---------------------------------------------------------------------------
# Pass A
# ---------------------------------------------------------------------------

def wavefront_pass_a(cfg, sched: torch.Tensor, camera, spheres: torch.Tensor,
                     accum: torch.Tensor):
    """Primary cast, first vertex, b=0 scatter over the scheduled tiles.

    sched (K, 2) int32; camera the packed (10, 4) host array; spheres (7, n)
    float32; accum (4, Hp, Wp), read for the sample counts. Returns (rays
    (9, K, spp*th, tw) float32, col (3, ...) float32, meta (2, ...) int32).
    """
    check_supported(cfg)
    _sampler_class(cfg)
    dev = _device(accum, "wavefront_pass_a")
    k = check_schedule(cfg, sched, accum)
    camera = check_camera(camera)
    n = _check_spheres(spheres, dev)
    if dev.type == "cpu":
        return wavefront_pass_a_plain(cfg, sched, camera, spheres, accum)
    rays = torch.empty(_lane_shape(cfg, k, _ray_plane_count(cfg)), dtype=f32,
                       device=dev)
    col = torch.empty(_lane_shape(cfg, k, 3), dtype=f32, device=dev)
    meta = torch.empty(_lane_shape(cfg, k, 2), dtype=i32, device=dev)
    ip, fp = step_params(cfg, k, n, camera)
    launch("wavefront_pass_a", cfg, dev, ip, fp, sched, spheres, accum, rays,
           col, meta)
    return rays, col, meta


def wavefront_pass_a_plain(cfg, sched: torch.Tensor, camera,
                           spheres: torch.Tensor, accum: torch.Tensor):
    """The plain torch version of `wavefront_pass_a`, lockstep over the
    pixels of the scheduled tiles, one sample at a time (lanes in the fused
    plain step's order, so every operation sees the same vectors)."""
    dev = accum.device
    sampler_cls = _sampler_class(cfg)
    intersect, _, albedo = _scene(spheres)
    cam = torch.as_tensor(np.asarray(camera, np.float32)).to(dev)
    k, th, tw, spp = (sched.shape[0], cfg.tile_height, cfg.tile_width,
                      cfg.spp_per_step)
    row, col = tile_pixel_coords(cfg, sched)
    flat = (row * cfg.padded_width + col).reshape(-1)  # also the pixel index
    sample_index = accum[3].reshape(-1)[flat].to(i32)
    rowf = row.reshape(-1).to(f32)
    colf = col.reshape(-1).to(f32)
    max_pairs = max_pairs_per_sample(cfg.max_bounces)
    planes = _ray_plane_count(cfg)
    rays = torch.empty((planes, k, spp, th, tw), dtype=f32, device=dev)
    rgb = torch.empty((3, k, spp, th, tw), dtype=f32, device=dev)
    meta = torch.empty((2, k, spp, th, tw), dtype=i32, device=dev)
    for s in range(spp):
        sampler = sampler_cls(cfg.seed, 0, flat, sample_index + s, max_pairs)
        u1, u2 = sampler.draw2()  # pixel jitter
        out = trace_wavefront_primary(
            cfg, intersect, albedo, sampler,
            *generate_rays(cfg, cam, colf, rowf, u1, u2))
        rgb[:, :, s] = torch.stack(out[:3]).view(3, k, th, tw)
        rays[:, :, s] = torch.stack(out[3:]).view(planes, k, th, tw)
        meta[0, :, s] = flat.to(i32).view(k, th, tw)
        meta[1, :, s] = (sample_index + s).view(k, th, tw)
    return (rays.view(_lane_shape(cfg, k, planes)),
            rgb.view(_lane_shape(cfg, k, 3)), meta.view(_lane_shape(cfg, k, 2)))


# ---------------------------------------------------------------------------
# Compaction (torch ops on the device, no host sync)
# ---------------------------------------------------------------------------

def compact_survivors(rays: torch.Tensor, meta: torch.Tensor):
    """Move the alive lanes to a dense prefix, in stable lane order.

    Returns (comp_rays (P, n), comp_meta (2, n), perm (n,) int64, alive (n,)
    bool, n_alive (1,) int32): lane i's destination is perm[i] (the alive
    lanes' rank, dead lanes after them), and comp[:, perm[i]] = rays[:, i].
    Every operation stays on the rays' device; nothing is read back."""
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
    comp_meta = meta.reshape(2, n).index_select(1, inv)
    return comp, comp_meta, perm, alive, n_alive.to(i32)


def scatter_back(contrib: torch.Tensor, perm: torch.Tensor,
                 alive: torch.Tensor) -> torch.Tensor:
    """Lane i's contribution from compacted lane perm[i]; 0 where lane i
    has no continuation. A `where`, never a product with the mask: lanes
    past n_alive hold whatever pass B left there, NaN included."""
    back = contrib.index_select(1, perm)
    return torch.where(alive, back, torch.zeros((), dtype=f32,
                                                device=back.device))


# ---------------------------------------------------------------------------
# Pass B
# ---------------------------------------------------------------------------

def wavefront_pass_b(cfg, camera, spheres: torch.Tensor, rays: torch.Tensor,
                     meta: torch.Tensor, n_alive: torch.Tensor) -> torch.Tensor:
    """Finish the compacted survivors' paths.

    rays (9, n_lanes) float32 and meta (2, n_lanes) int32 hold the alive
    lanes in their first n_alive (a (1,) int32 tensor on the same device,
    read by the kernel, never by the host). Returns contrib (3, n_lanes)
    float32, defined in its first n_alive lanes."""
    check_supported(cfg)
    _sampler_class(cfg)
    dev = _device(rays, "wavefront_pass_b")
    camera = check_camera(camera)
    n = _check_spheres(spheres, dev)
    n_lanes = rays.shape[1] if isinstance(rays, torch.Tensor) else -1
    check_tensor("rays", rays, f32, (_ray_plane_count(cfg), n_lanes), dev)
    check_tensor("meta", meta, i32, (2, n_lanes), dev)
    check_tensor("n_alive", n_alive, i32, (1,), dev)
    per_tile = cfg.spp_per_step * cfg.tile_height * cfg.tile_width
    if n_lanes < per_tile or n_lanes % per_tile:
        raise ValueError(f"rays: {n_lanes} lanes are not whole tiles of "
                         f"{per_tile}")
    if dev.type == "cpu":
        return wavefront_pass_b_plain(cfg, camera, spheres, rays, meta,
                                      n_alive)
    next_pair, has_spare = wavefront_draw_position(cfg)
    contrib = torch.empty((3, n_lanes), dtype=f32, device=dev)
    ip, fp = step_params(cfg, n_lanes // per_tile, n, camera)
    launch("wavefront_pass_b", cfg, dev, ip, fp, next_pair, int(has_spare),
           n_alive, spheres, rays, meta, contrib)
    return contrib


def wavefront_pass_b_plain(cfg, camera, spheres: torch.Tensor,
                           rays: torch.Tensor, meta: torch.Tensor,
                           n_alive: torch.Tensor) -> torch.Tensor:
    """The plain torch version of `wavefront_pass_b`: the continuation of
    every lane in lockstep, the padding past n_alive included (as the
    Pallas kernel's blocks compute their padding lanes), so it needs no
    host read of n_alive."""
    del camera, n_alive  # the port's stream is 0; all lanes are computed
    intersect, anyhit, albedo = _scene(spheres)
    next_pair, has_spare = wavefront_draw_position(cfg)
    sampler = _sampler_class(cfg).resumed(
        cfg.seed, 0, meta[0], meta[1], max_pairs_per_sample(cfg.max_bounces),
        next_pair, has_spare)
    return torch.stack(trace_wavefront_continue(
        cfg, intersect, anyhit, albedo, sampler, *rays[:9]))


# ---------------------------------------------------------------------------
# Pass C
# ---------------------------------------------------------------------------

def wavefront_pass_c(cfg, sched: torch.Tensor, col: torch.Tensor,
                     back: torch.Tensor, accum: torch.Tensor,
                     output: torch.Tensor) -> None:
    """Per pixel of the scheduled tiles: per sample sum + colA + contrib,
    then accum += (sum, spp) and output = gamma(rgb / n), IN PLACE. col and
    back are (3, K, spp*th, tw) float32 lane arrays."""
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
          rng_state) -> None:
    if rng_state is not None:
        raise ValueError("wavefront: the counter-based samplers keep no "
                         "rng_state planes")
    pass_a, pass_b, pass_c = passes
    rays, col, meta = pass_a(cfg, sched, camera, spheres, accum)
    comp, comp_meta, perm, alive, n_alive = compact_survivors(rays, meta)
    contrib = pass_b(cfg, camera, spheres, comp, comp_meta, n_alive)
    back = scatter_back(contrib, perm, alive).view(col.shape)
    pass_c(cfg, sched, col, back, accum, output)


def sphere_wavefront_step(cfg, sched: torch.Tensor, camera,
                          spheres: torch.Tensor, accum: torch.Tensor,
                          output: torch.Tensor, rng_state=None) -> None:
    """One wavefront render step over the scheduled tiles, updating accum
    and output IN PLACE (the arguments of sphere_pt.sphere_pt): the three
    kernels on CUDA tensors, their plain versions on CPU tensors."""
    _step((wavefront_pass_a, wavefront_pass_b, wavefront_pass_c), cfg, sched,
          camera, spheres, accum, output, rng_state)


def sphere_wavefront_step_plain(cfg, sched: torch.Tensor, camera,
                                spheres: torch.Tensor, accum: torch.Tensor,
                                output: torch.Tensor,
                                rng_state=None) -> None:
    """The same step through the three plain versions, on any device."""
    check_supported(cfg)
    camera = check_camera(camera)
    _step((wavefront_pass_a_plain, wavefront_pass_b_plain,
           wavefront_pass_c_plain), cfg, sched, camera, spheres, accum,
          output, rng_state)
