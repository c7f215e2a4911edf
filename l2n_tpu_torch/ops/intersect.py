"""Ray/sphere and ray/triangle intersection in lane form (counterpart of
l2n_tpu.ops.intersect).

The JAX package loops over spheres carrying a running nearest hit; here
each ray is tested against all n spheres at once along a trailing axis and
the winner is the FIRST index of the minimum (torch.argmin), which is the
loop's strict `t < best` rule. The per-candidate arithmetic is the JAX
package's half-b form in the same order:

  hb = ro.d,  c = ro.ro - r2,  disc = hb*hb - c,  t1/2 = -hb -/+ sqrt(disc)

A negative discriminant makes sqrt NaN, NaN compares false everywhere, and
the candidate turns into a miss without an explicit test. Keep that form:
the any-hit test below relies on it too. With fast_math the nearest sweep
takes sqrt as disc * rsqrt(disc), which also poisons disc == 0 (a tangent
ray misses), and the hit normal's rsqrt; the any-hit test stays exact.

Triangles: brute-force Möller-Trumbore over the flattened soup
(`intersect_triangle_scene`), in chunks of triangles with a running best.

Miss sentinel: t = -1.0, index = -1.
"""

from __future__ import annotations

import torch

from l2n_tpu_torch.maths.sampling import fast_sqrt, rsqrt, sqrt

_BIG = 3.0e38
MOLLER_TRUMBORE_EPS = 1e-6
# Elements of one (rays x triangles) temporary in the chunked triangle
# sweep: 16 MiB of float32 on the CPU; 128 MiB on a card, where fewer,
# larger chunks save launches.
_TRI_CHUNK_ELEMENTS = {"cpu": 1 << 22, "cuda": 1 << 25}


def _candidates(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2):
    """(hb, c) per ray and sphere, shape (..., n)."""
    rox = ox.unsqueeze(-1) - cx
    roy = oy.unsqueeze(-1) - cy
    roz = oz.unsqueeze(-1) - cz
    hb = rox * dx.unsqueeze(-1) + roy * dy.unsqueeze(-1) + roz * dz.unsqueeze(-1)
    c = rox * rox + roy * roy + roz * roz - r2
    return hb, c


def intersect_sphere_scene(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2,
                           fast_math: bool = False):
    """Nearest hit of each ray against the spheres (cx, cy, cz, r2: (n,)).

    t = t1 if t1 >= 0 else t2 (a ray starting inside a sphere hits its
    backside); a candidate counts when t >= 0. Returns (t, px, py, pz, nx,
    ny, nz, index, sqr_radius) of the winner; index is int64, -1 on miss,
    where the normal is 0 and sqr_radius 1.
    """
    hb, c = _candidates(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2)
    disc = hb * hb - c
    sq = fast_sqrt(disc) if fast_math else sqrt(disc)
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
    nn = nx * nx + ny * ny + nz * nz
    rcp = torch.where(hit, rsqrt(nn) if fast_math else 1.0 / sqrt(nn), zero)
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


def moller_trumbore(ox, oy, oz, dx, dy, dz, tri: dict):
    """Möller-Trumbore of rays against triangles (`tri`: v1{x,y,z},
    e1{x,y,z}, e2{x,y,z} tensors), broadcast, in the JAX package's
    operation order: reject |det| < eps, multiply by rcp_det =
    1/where(det_ok, det, 1), u/v bounds, t >= eps. Returns (t, u, v,
    valid)."""
    one = torch.tensor(1.0, dtype=torch.float32, device=dx.device)
    eps = MOLLER_TRUMBORE_EPS
    e1x, e1y, e1z = tri["e1x"], tri["e1y"], tri["e1z"]
    e2x, e2y, e2z = tri["e2x"], tri["e2y"], tri["e2z"]
    # P = cross(dir, e2); det = dot(e1, P)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = torch.abs(det) >= eps
    rcp_det = one / torch.where(det_ok, det, one)
    tx, ty, tz = ox - tri["v1x"], oy - tri["v1y"], oz - tri["v1z"]
    u = (tx * px + ty * py + tz * pz) * rcp_det
    # Q = cross(T, e1)
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * rcp_det
    t = (e2x * qx + e2y * qy + e2z * qz) * rcp_det
    valid = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t >= eps))
    return t, u, v, valid


def intersect_triangle_scene(ox, oy, oz, dx, dy, dz, soup: dict,
                             chunk: int | None = None):
    """Nearest hit against a flattened triangle soup (`soup`: (T,) tensors
    v1{x,y,z}, e1{x,y,z}, e2{x,y,z}, mesh_id, as TriangleScene.soup()).

    Möller-Trumbore in the JAX package's operation order: reject
    |det| < eps, multiply by rcp_det = 1/where(det_ok, det, 1), u/v bounds,
    t >= eps. Triangles are taken `chunk` at a time (by default as many as
    keep one (rays x chunk) temporary at _TRI_CHUNK_ELEMENTS); inside a chunk the
    winner is torch.argmin's first index of the minimum, across chunks a
    strict `<` keeps the earlier one, so the winner is the first soup index
    of the minimum, the JAX loop's rule. Invalid candidates become inf
    BEFORE the argmin (argmin takes NaN for the minimum, and origins parked
    at 3e30 overflow to NaN).

    Returns (t, u, v, tri_index, mesh_id) of the ray shape: t = -1 on a
    miss, where u = v = 0 and tri_index = mesh_id = -1 (int64).
    """
    shape = torch.broadcast_shapes(ox.shape, oy.shape, oz.shape, dx.shape)
    dev = dx.device
    f32 = torch.float32

    def rays(v):  # (R, 1), or 0-dim when shared by every ray
        return v.reshape(-1, 1) if v.dim() else v

    rox, roy, roz = rays(ox), rays(oy), rays(oz)
    rdx, rdy, rdz = (rays(torch.broadcast_to(d, shape)) for d in (dx, dy, dz))
    r = rdx.shape[0]
    total = soup["v1x"].shape[0]
    if chunk is None:
        budget = _TRI_CHUNK_ELEMENTS.get(dev.type, 1 << 22)
        chunk = max(1, budget // max(r, 1))
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    best_t = torch.full((r,), float("inf"), dtype=f32, device=dev)
    best_u = torch.zeros((r,), dtype=f32, device=dev)
    best_v = torch.zeros((r,), dtype=f32, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    for i0 in range(0, total, chunk):
        c = {k: soup[k][i0:i0 + chunk] for k in (
            "v1x", "v1y", "v1z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")}
        t, u, v, valid = moller_trumbore(rox, roy, roz, rdx, rdy, rdz, c)
        t, u, v = (torch.broadcast_to(a, valid.shape) for a in (t, u, v))
        t = torch.where(valid, t, inf)
        ci = torch.argmin(t, dim=1, keepdim=True)
        ct = torch.gather(t, 1, ci).squeeze(1)
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_u = torch.where(better, torch.gather(u, 1, ci).squeeze(1), best_u)
        best_v = torch.where(better, torch.gather(v, 1, ci).squeeze(1), best_v)
        best_tri = torch.where(better, ci.squeeze(1) + i0, best_tri)

    missed = ~torch.isfinite(best_t)
    best_t = torch.where(missed, torch.full_like(best_t, -1.0), best_t)
    mesh = torch.where(missed, torch.full_like(best_tri, -1),
                       soup["mesh_id"].to(torch.int64)[best_tri.clamp(min=0)])
    return tuple(a.reshape(shape) for a in (best_t, best_u, best_v, best_tri,
                                            mesh))
