"""Shared plumbing of the kernel tier: the port's config gate, launch
counters, tensor checks, tile pixel coordinates and the kernel-form
accumulate + tonemap (counterpart of l2n_tpu.ops.kernels.common)."""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from l2n_tpu_torch.ops.kernels import build
from l2n_tpu_torch.ops.pathtrace import generate_rays, shade
from l2n_tpu_torch.rng.sampler import ThreefrySampler, max_pairs_per_sample

# Launches of each hand-written kernel, by kernel name. A wrapper adds one
# right after its kernel launched, and nowhere else: the plain versions a
# wrapper runs for CPU tensors do not count. Read it to show that a run went
# through the kernels; `reset_launches` zeroes it.
launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()


def check_supported(cfg) -> None:
    """Raise NotImplementedError, naming the ROADMAP item that ports it, for
    anything the port does not render. Nothing is silently ignored."""
    cfg.validate()
    triangle = cfg.scene_kind == "triangle"
    unsupported = [
        (cfg.rng != "threefry",
         f"rng={cfg.rng!r}: tinymt/tauslcg are ROADMAP Queue 1 #10, tpu_hw "
         "becomes a Philox option (ROADMAP Queue 2, ported last)"),
        (cfg.nee or cfg.mis, "nee/mis are ROADMAP Queue 1 #9"),
        (cfg.material_mode != "procedural",
         f"material_mode={cfg.material_mode!r} is ROADMAP Queue 1 #9"),
        (cfg.normal_map > 0.0, "normal_map is ROADMAP Queue 1 #9"),
        (cfg.fog_density > 0.0, "fog is ROADMAP Queue 1 #9"),
        (cfg.env_mode == "sun", "env_mode='sun' is ROADMAP Queue 1 #9"),
        (cfg.ray_gen != "fovy",
         f"ray_gen={cfg.ray_gen!r} is ROADMAP Queue 1 #9"),
        (cfg.fast_math, "fast_math is ROADMAP Queue 1 #9"),
        (cfg.wavefront, "wavefront is ROADMAP Queue 1 #13"),
        (cfg.aov in ("tex_coords", "param_uv") and not triangle,
         f"aov={cfg.aov!r} renders mesh texcoords/barycentrics; on the "
         "sphere scene it is ROADMAP Queue 1 #8"),
        (cfg.aov not in ("pathtracing", "tex_coords", "param_uv"),
         f"aov={cfg.aov!r}: the normal, hit and ambient_occlusion AOVs are "
         "ROADMAP Queue 1 #9"),
    ]
    for bad, why in unsupported:
        if bad:
            raise NotImplementedError(why)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Validate what a kernel wrapper is handed before any pointer is
    taken: dtype, shape, device and contiguity."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# The kernels' AOV codes (csrc/pathtrace.cuh kAov*).
AOV_CODES = {"pathtracing": 0, "tex_coords": 1, "param_uv": 2}


def step_params(cfg, k: int, n_scene: int, camera: np.ndarray):
    """The integer and float parameter arrays of csrc/pathtrace.cuh's
    params_from_arrays, in its order, for K scheduled tiles over a scene of
    `n_scene` spheres or meshes."""
    ip = np.array([cfg.tile_height, cfg.tile_width, cfg.padded_height,
                   cfg.padded_width, k, n_scene, cfg.spp_per_step,
                   cfg.max_bounces, max_pairs_per_sample(cfg.max_bounces),
                   cfg.emissive_every,
                   1 if cfg.env_mode == "mandelbrot" else 0,
                   cfg.seed & 0xFFFFFFFF, 0, AOV_CODES[cfg.aov]],
                  dtype=np.int64)
    ip = ip.astype(np.uint32).view(np.int32)
    fp = np.concatenate([np.array(
        [1.0 / (cfg.ndc_width or cfg.width),
         1.0 / (cfg.ndc_height or cfg.height), cfg.rr_ceiling,
         cfg.ray_epsilon, cfg.emission_scale, cfg.env_scale, cfg.gamma],
        dtype=np.float32), camera.reshape(-1)])
    return np.ascontiguousarray(ip), np.ascontiguousarray(fp, np.float32)


def check_camera(camera) -> np.ndarray:
    """The packed (10, 4) float32 camera block as a contiguous host array."""
    camera = np.ascontiguousarray(camera, dtype=np.float32)
    if camera.shape != (10, 4):
        raise ValueError(f"camera: shape {camera.shape}, expected (10, 4)")
    return camera


def check_schedule(cfg, sched, accum, output) -> int:
    """Validate the schedule and the frame planes a step kernel updates in
    place; returns the number of scheduled tiles K."""
    dev = accum.device if isinstance(accum, torch.Tensor) else None
    k = sched.shape[0] if isinstance(sched, torch.Tensor) else -1
    check_tensor("sched", sched, torch.int32, (k, 2), dev)
    if not 1 <= k <= cfg.tile_count:
        raise ValueError(f"sched: {k} tiles, expected 1..{cfg.tile_count}")
    hp, wp = cfg.padded_height, cfg.padded_width
    check_tensor("accum", accum, torch.float32, (4, hp, wp), dev)
    check_tensor("output", output, torch.float32, (3, hp, wp), dev)
    return k


def tile_pixel_coords(cfg, sched: torch.Tensor):
    """(row, col) int64 tensors of shape (K, tile_height, tile_width) for
    the scheduled tiles sched (K, 2) = (tile_x, tile_y)."""
    th, tw = cfg.tile_height, cfg.tile_width
    dev = sched.device
    tx = sched[:, 0].to(torch.int64).view(-1, 1, 1)
    ty = sched[:, 1].to(torch.int64).view(-1, 1, 1)
    row = ty * th + torch.arange(th, device=dev).view(1, th, 1)
    col = tx * tw + torch.arange(tw, device=dev).view(1, 1, tw)
    return row.expand(-1, th, tw), col.expand(-1, th, tw)


def safe_gamma(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """pow(x, gamma) for x >= 0 as exp(gamma * log(max(x, 1e-30))), 0 for
    x <= 0 — the kernels' display form (the XLA oracle uses
    power(max(rgb, 0) / max(n, 1e-20), gamma); the two differ in the last
    ulps, so tests compare `accum` tightly and `output` loosely)."""
    safe = torch.clamp(x, min=1e-30)
    return torch.where(x <= 0.0, torch.zeros_like(x),
                       torch.exp(gamma * torch.log(safe)))


def accumulate_and_tonemap(cfg, accum: torch.Tensor, output: torch.Tensor,
                           flat: torch.Tensor, sums, spp: int) -> None:
    """IN PLACE over the pixels `flat` (indices into the flattened planes):
    accum += (sum_r, sum_g, sum_b, spp); output = gamma(rgb / n)."""
    acc = accum.view(4, -1)
    out = output.view(3, -1)
    a = acc[:, flat]
    n = a[3] + float(spp)
    rgb = [a[c] + sums[c] for c in range(3)]
    acc[:, flat] = torch.stack(rgb + [n])
    inv = 1.0 / n
    out[:, flat] = torch.stack([safe_gamma(c * inv, cfg.gamma) for c in rgb])


def render_tiles_plain(cfg, sched: torch.Tensor, camera, intersect, anyhit,
                       albedo: torch.Tensor, accum: torch.Tensor,
                       output: torch.Tensor) -> None:
    """The plain torch step shared by the kernels' plain versions: for every
    pixel of the scheduled tiles, `spp` samples in lockstep through
    ops/pathtrace.shade with the scene's `intersect`/`anyhit` closures and
    (n, 3) albedo table, then accumulate + tonemap IN PLACE."""
    dev = accum.device
    cam = torch.as_tensor(np.asarray(camera, np.float32)).to(dev)
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


def launch(name: str, cfg, device: torch.device, *args) -> None:
    """Launch the C entry point `l2n_<name>` of the kernel library on the
    current stream of `device` and count it. `args` are host numpy arrays
    (passed by address), device tensors (by data pointer) or Python ints,
    in the entry point's order before its stream. Raises on a refused
    launch; builds the library at its first use."""
    if cfg.tile_width > 1024:
        raise ValueError(f"{name}: tile_width must be <= 1024 (one thread "
                         "per column of a tile row)")
    fn = getattr(build.load(), f"l2n_{name}")

    def arg(a):
        if isinstance(a, np.ndarray):
            return ctypes.c_void_p(a.ctypes.data)
        if isinstance(a, torch.Tensor):
            return ctypes.c_void_p(a.data_ptr())
        return ctypes.c_int(a)

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*map(arg, args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
