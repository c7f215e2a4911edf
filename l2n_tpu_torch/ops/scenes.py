"""Sphere-scene intersect closures producing `Hit` records (counterpart of
the sphere parts of l2n_tpu.ops.scenes)."""

from __future__ import annotations

import torch

from l2n_tpu_torch.ops.intersect import (
    intersect_sphere_scene,
    sphere_scene_anyhit,
)
from l2n_tpu_torch.ops.pathtrace import AnyHitFn, Hit, IntersectFn


def sphere_intersector(cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor,
                       r2: torch.Tensor) -> IntersectFn:
    """Nearest-hit closure over the sphere SoA (n,) tensors."""

    def intersect(ox, oy, oz, dx, dy, dz) -> Hit:
        t, _, _, _, nx, ny, nz, idx, br2 = intersect_sphere_scene(
            ox, oy, oz, dx, dy, dz, cx, cy, cz, r2)
        return Hit(t=t, nx=nx, ny=ny, nz=nz, index=idx, emis_r2=br2)

    return intersect


def sphere_anyhit(cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor,
                  r2: torch.Tensor) -> AnyHitFn:
    """Boolean any-hit closure (the last segment's environment test)."""

    def anyhit(ox, oy, oz, dx, dy, dz):
        return sphere_scene_anyhit(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2)

    return anyhit
