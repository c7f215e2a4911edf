"""The sphere path-tracing step: the CUDA kernel's wrapper and its plain
torch version (counterpart of l2n_tpu/ops/kernels/sphere_pt.py).

`sphere_pt(cfg, sched, camera, spheres, accum, output)` renders the
scheduled tiles and updates `accum` and `output` IN PLACE — the port's
counterpart of the JAX step's donated buffers:
  * on CUDA tensors it launches `csrc/sphere_pt.cu` (one thread per pixel
    of the K scheduled tiles) or raises; nothing falls back;
  * on CPU tensors it runs `sphere_pt_plain`, the same update in lockstep
    torch (ops/pathtrace.shade), which is also `backend="torch"`.

Both read the scene's albedo table, evaluated once on the host (the
albedo hash magnifies one-ulp sin differences), and both use the
kernel-form tonemap. Not in this slice: the cone-cull visibility table
(the kernel sweeps all spheres for primary rays) and the t1-only
`assume_outside` sweep of disjoint scenes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from l2n_tpu_torch.ops.kernels.common import (
    accumulate_and_tonemap,
    check_supported,
    check_tensor,
    launches,
    tile_pixel_coords,
)
from l2n_tpu_torch.ops.pathtrace import generate_rays, shade
from l2n_tpu_torch.ops.scenes import sphere_anyhit, sphere_intersector
from l2n_tpu_torch.rng.sampler import ThreefrySampler, max_pairs_per_sample

# The kernel stages the (7, n) scene into shared memory without opting in
# to more than the default 48 KiB of dynamic shared memory per block.
MAX_SPHERES = (48 * 1024) // (7 * 4)


def _check(cfg, sched, camera, spheres, accum, output):
    check_supported(cfg)
    dev = accum.device
    k = sched.shape[0] if isinstance(sched, torch.Tensor) else -1
    check_tensor("sched", sched, torch.int32, (k, 2), dev)
    if not 1 <= k <= cfg.tile_count:
        raise ValueError(f"sched: {k} tiles, expected 1..{cfg.tile_count}")
    n = spheres.shape[1] if isinstance(spheres, torch.Tensor) else -1
    check_tensor("spheres", spheres, torch.float32, (7, n), dev)
    hp, wp = cfg.padded_height, cfg.padded_width
    check_tensor("accum", accum, torch.float32, (4, hp, wp), dev)
    check_tensor("output", output, torch.float32, (3, hp, wp), dev)
    camera = np.ascontiguousarray(camera, dtype=np.float32)
    if camera.shape != (10, 4):
        raise ValueError(f"camera: shape {camera.shape}, expected (10, 4)")
    return camera


def _params(cfg, k: int, n: int, camera: np.ndarray):
    """The integer and float parameter arrays of csrc/sphere_pt.cuh's
    params_from_arrays, in its order."""
    ip = np.array([cfg.tile_height, cfg.tile_width, cfg.padded_height,
                   cfg.padded_width, k, n, cfg.spp_per_step, cfg.max_bounces,
                   max_pairs_per_sample(cfg.max_bounces), cfg.emissive_every,
                   1 if cfg.env_mode == "mandelbrot" else 0,
                   cfg.seed & 0xFFFFFFFF, 0], dtype=np.int64)
    ip = ip.astype(np.uint32).view(np.int32)
    fp = np.concatenate([np.array(
        [1.0 / (cfg.ndc_width or cfg.width),
         1.0 / (cfg.ndc_height or cfg.height), cfg.rr_ceiling,
         cfg.ray_epsilon, cfg.emission_scale, cfg.env_scale, cfg.gamma],
        dtype=np.float32), camera.reshape(-1)])
    return np.ascontiguousarray(ip), np.ascontiguousarray(fp, np.float32)


def sphere_pt(cfg, sched: torch.Tensor, camera, spheres: torch.Tensor,
              accum: torch.Tensor, output: torch.Tensor) -> None:
    """One render step over the scheduled tiles, in place (see module doc).

    sched (K, 2) int32 (tile_x, tile_y); camera the packed (10, 4) float32
    host array; spheres (7, n) float32 (SphereScene.packed()); accum
    (4, Hp, Wp) and output (3, Hp, Wp) float32, all on one device.
    """
    camera = _check(cfg, sched, camera, spheres, accum, output)
    if accum.device.type == "cpu":
        sphere_pt_plain(cfg, sched, camera, spheres, accum, output)
        return
    if accum.device.type != "cuda":
        raise ValueError(f"sphere_pt: no kernel for device {accum.device}")
    n = spheres.shape[1]
    if n > MAX_SPHERES:
        raise ValueError(f"sphere_pt: {n} spheres exceed the kernel's shared "
                         f"memory ({MAX_SPHERES} max)")
    if cfg.tile_width > 1024:
        raise ValueError("sphere_pt: tile_width must be <= 1024 (one "
                         "thread per column of a tile row)")
    from l2n_tpu_torch.ops.kernels import build
    lib = build.load()
    ip, fp = _params(cfg, sched.shape[0], n, camera)
    ptr = lambda a: ctypes.c_void_p(a.ctypes.data)  # noqa: E731
    dptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(accum.device):
        stream = torch.cuda.current_stream(accum.device).cuda_stream
        rc = lib.l2n_sphere_pt(ptr(ip), ptr(fp), dptr(sched), dptr(spheres),
                               dptr(accum), dptr(output),
                               ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"sphere_pt kernel launch failed: CUDA error {rc}")
    launches["sphere_pt"] += 1


def sphere_pt_plain(cfg, sched: torch.Tensor, camera, spheres: torch.Tensor,
                    accum: torch.Tensor, output: torch.Tensor) -> None:
    """The plain torch version of `sphere_pt`: the same in-place update,
    computed in lockstep over the pixels of the scheduled tiles on
    whatever device the tensors are on."""
    check_supported(cfg)
    dev = accum.device
    cam = torch.as_tensor(np.asarray(camera, np.float32)).to(dev)
    cx, cy, cz, r2 = spheres[0], spheres[1], spheres[2], spheres[3]
    albedo = spheres[4:7].T
    intersect = sphere_intersector(cx, cy, cz, r2)
    anyhit = sphere_anyhit(cx, cy, cz, r2)

    row, col = tile_pixel_coords(cfg, sched)
    flat = (row * cfg.padded_width + col).reshape(-1)  # also the pixel index
    sample_index = accum[3].reshape(-1)[flat].to(torch.int32)
    rowf = row.reshape(-1).to(torch.float32)
    colf = col.reshape(-1).to(torch.float32)
    max_pairs = max_pairs_per_sample(cfg.max_bounces)

    spp = cfg.spp_per_step
    sums = [torch.zeros(flat.shape, dtype=torch.float32, device=dev)
            for _ in range(3)]
    for s in range(spp):
        sampler = ThreefrySampler(cfg.seed, 0, flat, sample_index + s,
                                  max_pairs)
        u1, u2 = sampler.draw2()  # pixel jitter
        rays = generate_rays(cfg, cam, colf, rowf, u1, u2)
        rgb = shade(cfg, intersect, anyhit, albedo, sampler, *rays)
        sums = [a + b for a, b in zip(sums, rgb)]
    accumulate_and_tonemap(cfg, accum, output, flat, sums, spp)
