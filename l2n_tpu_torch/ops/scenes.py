"""Scene intersect closures producing `Hit` records (counterpart of
l2n_tpu.ops.scenes)."""

from __future__ import annotations

import torch

from l2n_tpu_torch.ops.intersect import (
    intersect_sphere_scene,
    intersect_triangle_scene,
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


# Cast origins of dead lanes (ops/pathtrace.py parks them at 3e30).
_PARKED = 1.0e30


def triangle_intersector(soup: dict) -> IntersectFn:
    """Nearest-hit closure over a triangle soup of (T,) tensors.

    The winner's attributes are gathered once per ray and interpolated in
    the JAX oracle's three-weight form, attr = u*b + v*c + w*a with
    w = 1-u-v, the normal unnormalized. `index` is the mesh id and
    `emis_r2` the constant 1 of meshes. A miss keeps u = v = 0 and reads
    triangle 0's attributes, as the oracle does.

    Lanes whose cast origin is parked at 3e30 (dead paths) skip the sweep
    and report a miss: only live lanes are intersected.
    """
    def sweep(ox, oy, oz, dx, dy, dz):
        if ox.dim() == 0:
            return intersect_triangle_scene(ox, oy, oz, dx, dy, dz, soup)
        shape = torch.broadcast_shapes(ox.shape, dx.shape)
        o = [torch.broadcast_to(a, shape).reshape(-1) for a in (ox, oy, oz)]
        d = [torch.broadcast_to(a, shape).reshape(-1) for a in (dx, dy, dz)]
        live = torch.nonzero(o[0] < _PARKED).squeeze(1)
        n = o[0].shape[0]
        out = [torch.full((n,), -1.0, dtype=dx.dtype, device=dx.device),
               torch.zeros((n,), dtype=dx.dtype, device=dx.device),
               torch.zeros((n,), dtype=dx.dtype, device=dx.device),
               torch.full((n,), -1, dtype=torch.int64, device=dx.device),
               torch.full((n,), -1, dtype=torch.int64, device=dx.device)]
        if live.numel():
            got = intersect_triangle_scene(*(a[live] for a in o + d), soup)
            for dst, src in zip(out, got):
                dst[live] = src
        return tuple(a.reshape(shape) for a in out)

    def intersect(ox, oy, oz, dx, dy, dz) -> Hit:
        t, u, v, tri, mesh = sweep(ox, oy, oz, dx, dy, dz)
        safe = tri.clamp(min=0)
        w = 1.0 - u - v

        def interp(a, b, c):
            return u * soup[b][safe] + v * soup[c][safe] + w * soup[a][safe]

        return Hit(t=t, nx=interp("nax", "nbx", "ncx"),
                   ny=interp("nay", "nby", "ncy"),
                   nz=interp("naz", "nbz", "ncz"), index=mesh,
                   emis_r2=torch.ones_like(t),
                   tc_u=interp("tau", "tbu", "tcu"),
                   tc_v=interp("tav", "tbv", "tcv"), b_u=u, b_v=v)

    return intersect


def triangle_anyhit(intersect: IntersectFn) -> AnyHitFn:
    """The last segment's test for meshes: exactly the JAX oracle's
    `intersect(...).t >= 0` (its triangle scene has no any-hit sweep)."""

    def anyhit(ox, oy, oz, dx, dy, dz):
        return intersect(ox, oy, oz, dx, dy, dz).t >= 0.0

    return anyhit
