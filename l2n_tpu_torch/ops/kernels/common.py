"""Shared plumbing of the kernel tier: the slice's config gate, launch
counters, tensor checks, tile pixel coordinates and the kernel-form
accumulate + tonemap (counterpart of l2n_tpu.ops.kernels.common)."""

from __future__ import annotations

import collections

import torch

# Launches of each hand-written kernel, by kernel name. A wrapper adds one
# right after its kernel launched, and nowhere else: the plain versions a
# wrapper runs for CPU tensors do not count. Read it to show that a run went
# through the kernels; `reset_launches` zeroes it.
launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()


def check_supported(cfg) -> None:
    """Raise NotImplementedError, naming the ROADMAP item that ports it, for
    anything this slice does not render. Nothing is silently ignored."""
    cfg.validate()
    unsupported = [
        (cfg.scene_kind != "sphere",
         f"scene_kind={cfg.scene_kind!r}: the triangle family is ROADMAP "
         "Queue 1 #8"),
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
        (cfg.aov != "pathtracing",
         f"aov={cfg.aov!r}: the debug AOVs are ROADMAP Queue 1 #8/#9"),
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
