"""Ray/sphere intersection in lane form (counterpart of the sphere parts of
l2n_tpu.ops.intersect).

The JAX package loops over spheres carrying a running nearest hit; here
each ray is tested against all n spheres at once along a trailing axis and
the winner is the FIRST index of the minimum (torch.argmin), which is the
loop's strict `t < best` rule. The per-candidate arithmetic is the JAX
package's half-b form in the same order:

  hb = ro.d,  c = ro.ro - r2,  disc = hb*hb - c,  t1/2 = -hb -/+ sqrt(disc)

A negative discriminant makes sqrt NaN, NaN compares false everywhere, and
the candidate turns into a miss without an explicit test. Keep that form:
the any-hit test below relies on it too.

Miss sentinel: t = -1.0, index = -1.
"""

from __future__ import annotations

import torch

from l2n_tpu_torch.maths.sampling import sqrt

_BIG = 3.0e38


def _candidates(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2):
    """(hb, c) per ray and sphere, shape (..., n)."""
    rox = ox.unsqueeze(-1) - cx
    roy = oy.unsqueeze(-1) - cy
    roz = oz.unsqueeze(-1) - cz
    hb = rox * dx.unsqueeze(-1) + roy * dy.unsqueeze(-1) + roz * dz.unsqueeze(-1)
    c = rox * rox + roy * roy + roz * roz - r2
    return hb, c


def intersect_sphere_scene(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2):
    """Nearest hit of each ray against the spheres (cx, cy, cz, r2: (n,)).

    t = t1 if t1 >= 0 else t2 (a ray starting inside a sphere hits its
    backside); a candidate counts when t >= 0. Returns (t, px, py, pz, nx,
    ny, nz, index, sqr_radius) of the winner; index is int64, -1 on miss,
    where the normal is 0 and sqr_radius 1.
    """
    hb, c = _candidates(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2)
    disc = hb * hb - c
    sq = sqrt(disc)
    nhb = -hb
    t1 = nhb - sq
    t2 = nhb + sq
    t = torch.where(t1 >= 0.0, t1, t2)
    t = torch.where(t >= 0.0, t, torch.full_like(t, _BIG))
    best_i = torch.argmin(t, dim=-1)
    best_t = torch.gather(t, -1, best_i.unsqueeze(-1)).squeeze(-1)

    hit = best_t < _BIG
    best_t = torch.where(hit, best_t, torch.full_like(best_t, -1.0))
    zero = torch.zeros_like(best_t)
    bcx = torch.where(hit, cx[best_i], zero)
    bcy = torch.where(hit, cy[best_i], zero)
    bcz = torch.where(hit, cz[best_i], zero)
    br2 = torch.where(hit, r2[best_i], torch.ones_like(best_t))
    px = ox + best_t * dx
    py = oy + best_t * dy
    pz = oz + best_t * dz
    nx, ny, nz = px - bcx, py - bcy, pz - bcz
    rcp = 1.0 / sqrt(nx * nx + ny * ny + nz * nz)
    rcp = torch.where(hit, rcp, zero)
    index = torch.where(hit, best_i, torch.full_like(best_i, -1))
    return best_t, px, py, pz, nx * rcp, ny * rcp, nz * rcp, index, br2


def sphere_scene_anyhit(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2):
    """Does the ray hit ANY sphere with t >= 0? Exactly
    `intersect_sphere_scene(...)[0] >= 0` without roots: a sphere is hit iff
    the origin is inside it (c < 0) or it lies ahead with a real root
    (hb < 0 and hb*hb >= c)."""
    hb, c = _candidates(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2)
    hit = (c < 0.0) | ((hb < 0.0) & (hb * hb >= c))
    return hit.any(dim=-1)
