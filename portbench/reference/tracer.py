"""The path tracer of the benchmark's configurations in plain torch: the
reference that decides `correct` (frozen copy; PROVENANCE.md).

Settings it covers, and only these: the path-tracing image, procedural
Lambert shading, `max_bounces` segments with Russian roulette, every
`emissive_every`-th object emissive, the Mandelbrot sky, the "fovy" camera,
the Philox sampler (`rng="tpu_hw"`), `fast_math` on and off, two
intersectors: a sweep over every sphere and a brute-force Moller-Trumbore
sweep over every triangle of the soup, which takes no hit that lies off
its triangle's mesh (`_triangle_sweep`), and on meshes next event estimation
(`nee`) by cone sampling of the emissive meshes' bounding spheres, with
(`mis`) or without the balance heuristic of multiple importance sampling.
Other NEE settings raise ValueError (`check_nee`). Every lane runs every
segment's arithmetic in lockstep and masks decide what is kept; the
tri-state distance (t >= 0 hit, -1 miss, -2 terminated) is kept, since the
sky test is `dist == -1`.

Arithmetic runs in the dtype of the scene and camera tensors: float32 for
the reference, a lower precision for the control (`render`'s `dtype`).
The square root is taken in float64 and rounded (a correctly rounded
sqrtf); under fast_math the rsqrt forms are the card's rsqrtf on a CUDA
tensor and the correctly rounded 1/sqrt on the CPU.

`Counts` gathers, per traced lane, the work any implementation of the
step must do (counts/floor.py prices it).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.rng import PhiloxSampler, max_pairs_per_sample
from portbench.reference.scene import Soup, Spheres

PI = 3.14159265358979323846
BIG = 3.0e38
PARKED = 1.0e30
MT_EPS = 1e-6
MANDELBROT_ITERS = 64
_HALF_PI = 1.5707963267948966
_ATAN_C = (0.99997726, -0.33262347, 0.19354346, -0.11643287, 0.05265332,
           -0.01172120)
# Elements of one (rays x triangles) temporary of the triangle sweep.
TRI_CHUNK_ELEMENTS = {"cpu": 1 << 22, "cuda": 1 << 25}
# The off-mesh rule's slack (`_triangle_sweep`): a bound on the rounding
# of a candidate's point o + t d, in units of the dtype's epsilon times
# |o|_1 + |c|_1 + t.
OFF_MESH_ROUNDING = 8.0


# --------------------------------------------------------------------------
# Maths.

def sqrt(x):
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def rsqrt(x):
    if x.device.type == "cuda":
        return torch.rsqrt(x)
    return 1.0 / sqrt(x)


def fast_sqrt(x):
    return x * rsqrt(x)


def _rcp_len(nn, fast: bool):
    return rsqrt(nn) if fast else 1.0 / sqrt(nn)


def normalize3(x, y, z, fast: bool = False):
    rcp = _rcp_len(x * x + y * y + z * z, fast)
    return x * rcp, y * rcp, z * rcp


def luminance(r, g, b):
    return 0.212671 * r + 0.715160 * g + 0.072169 * b


def frame_z(zx, zy, zz, fast: bool = False):
    """(tangent, bitangent) around the z axis; the tangent from the
    smaller of |z.x|, |z.y|."""
    use_y = torch.abs(zy) > torch.abs(zx)
    zero = torch.zeros_like(zx)
    rcp_a = _rcp_len(zx * zx + zy * zy, fast)
    ax, ay, az = zy * rcp_a, -zx * rcp_a, zero
    rcp_b = _rcp_len(zx * zx + zz * zz, fast)
    bx, by, bz = zz * rcp_b, zero, -zx * rcp_b
    tx = torch.where(use_y, ax, bx)
    ty = torch.where(use_y, ay, by)
    tz = torch.where(use_y, az, bz)
    return (tx, ty, tz), (zy * tz - zz * ty, zz * tx - zx * tz,
                          zx * ty - zy * tx)


def local_to_world(lx, ly, lz, tangent, bitangent, zaxis):
    return tuple(t * lx + b * ly + z * lz
                 for t, b, z in zip(tangent, bitangent, zaxis))


def cosine_hemisphere(u1, u2):
    r = sqrt(u1)
    phi = (2.0 * PI) * u2
    cos_theta = sqrt(torch.clamp(1.0 - u1, min=0.0))
    return r * torch.cos(phi), r * torch.sin(phi), cos_theta


def atan2(y, x):
    """The minimax four-quadrant arctangent of the sky (~1e-5 rad)."""
    ax, ay = torch.abs(x), torch.abs(y)
    t = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay), min=1e-37)
    s = t * t
    p = torch.full_like(t, _ATAN_C[5])
    for c in _ATAN_C[4::-1]:
        p = p * s + c
    a = t * p
    a = torch.where(ay > ax, _HALF_PI - a, a)
    a = torch.where(x < 0.0, PI - a, a)
    return torch.where(y < 0.0, -a, a)


def mandelbrot(dx, dy, dz):
    """(radiance, in the direction box, escape iterations run) of the
    Mandelbrot sky: theta = atan2(|d.xy|, d.z), phi = atan2(d.y, d.x),
    p = (8 phi / pi, 4 (2 theta / pi - 1)); the radiance is i / 64 at the
    first |z|^2 > 4, 0 if z stays bounded, 0 outside the box where
    |p| <= 2 can hold."""
    in_box = (dx >= torch.abs(dy)) & (dz * dz <= dx * dx + dy * dy)
    theta = atan2(sqrt(dx * dx + dy * dy), dz)
    phi = atan2(dy, dx)
    px = 8.0 * (phi * (1.0 / PI))
    py = 4.0 * (-1.0 + (2.0 / PI) * theta)
    zx, zy, zx2, zy2 = (torch.zeros_like(px) for _ in range(4))
    still = torch.ones_like(px)
    cnt = torch.zeros_like(px)
    iters = torch.zeros(px.shape, dtype=torch.int32, device=px.device)
    for _ in range(MANDELBROT_ITERS):
        iters = iters + (still > 0).to(torch.int32)
        zy = 2.0 * zx * zy + py
        zx = zx2 - zy2 + px
        zx2 = zx * zx
        zy2 = zy * zy
        still = still * (zx2 + zy2 <= 4.0).to(px.dtype)
        cnt = cnt + still
    le = torch.where(cnt < MANDELBROT_ITERS, cnt * (1.0 / MANDELBROT_ITERS),
                     torch.zeros_like(cnt))
    return torch.where(in_box, le, torch.zeros_like(le)), in_box, iters


# --------------------------------------------------------------------------
# Intersection. A Hit: t (-1 on a miss), the normal, the object index (-1
# on a miss) and the squared radius of the emission formula.

@dataclasses.dataclass
class Hit:
    t: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    index: torch.Tensor
    emis_r2: torch.Tensor


def _sphere_candidates(s: Spheres, ox, oy, oz, dx, dy, dz):
    rox = ox.unsqueeze(-1) - s.cx
    roy = oy.unsqueeze(-1) - s.cy
    roz = oz.unsqueeze(-1) - s.cz
    hb = (rox * dx.unsqueeze(-1) + roy * dy.unsqueeze(-1)
          + roz * dz.unsqueeze(-1))
    c = rox * rox + roy * roy + roz * roz - s.r2
    return hb, c


def sphere_nearest(s: Spheres, fast: bool, ox, oy, oz, dx, dy, dz) -> Hit:
    """Nearest hit over every sphere (t1 if t1 >= 0 else t2; the first
    index of the minimum wins). A negative discriminant makes the root
    NaN, which no compare accepts."""
    hb, c = _sphere_candidates(s, ox, oy, oz, dx, dy, dz)
    disc = hb * hb - c
    sq = fast_sqrt(disc) if fast else sqrt(disc)
    t1 = -hb - sq
    t2 = -hb + sq
    t = torch.where(t1 >= 0.0, t1, t2)
    t = torch.where(t >= 0.0, t, torch.full_like(t, BIG))
    best_i = torch.argmin(t, dim=-1)
    best_t = torch.gather(t, -1, best_i.unsqueeze(-1)).squeeze(-1)
    hit = best_t < BIG
    best_t = torch.where(hit, best_t, torch.full_like(best_t, -1.0))
    zero = torch.zeros_like(best_t)
    bcx = torch.where(hit, s.cx[best_i], zero)
    bcy = torch.where(hit, s.cy[best_i], zero)
    bcz = torch.where(hit, s.cz[best_i], zero)
    br2 = torch.where(hit, s.r2[best_i], torch.ones_like(best_t))
    nx = ox + best_t * dx - bcx
    ny = oy + best_t * dy - bcy
    nz = oz + best_t * dz - bcz
    nn = nx * nx + ny * ny + nz * nz
    rcp = torch.where(hit, rsqrt(nn) if fast else 1.0 / sqrt(nn), zero)
    index = torch.where(hit, best_i, torch.full_like(best_i, -1))
    return Hit(best_t, nx * rcp, ny * rcp, nz * rcp, index, br2)


def sphere_any(s: Spheres, ox, oy, oz, dx, dy, dz):
    """Whether any sphere is hit at t >= 0: the origin inside it, or it
    ahead with a real root."""
    hb, c = _sphere_candidates(s, ox, oy, oz, dx, dy, dz)
    return ((c < 0.0) | ((hb < 0.0) & (hb * hb >= c))).any(dim=-1)


def _moller_trumbore(ox, oy, oz, dx, dy, dz, tri):
    one = torch.ones((), dtype=dx.dtype, device=dx.device)
    e1x, e1y, e1z = tri["e1x"], tri["e1y"], tri["e1z"]
    e2x, e2y, e2z = tri["e2x"], tri["e2y"], tri["e2z"]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = torch.abs(det) >= MT_EPS
    rcp_det = one / torch.where(det_ok, det, one)
    tx, ty, tz = ox - tri["v1x"], oy - tri["v1y"], oz - tri["v1z"]
    u = (tx * px + ty * py + tz * pz) * rcp_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * rcp_det
    t = (e2x * qx + e2y * qy + e2z * qz) * rcp_det
    valid = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t >= MT_EPS))
    return t, u, v, valid


def _triangle_sweep(soup: Soup, ox, oy, oz, dx, dy, dz, tally=None):
    """(t, u, v, triangle) of the nearest triangle of every (R,) ray, by
    testing every triangle in chunks; the first soup index of the minimum
    wins. A miss: t = -1, u = v = 0, triangle -1.

    The off-mesh rule: a candidate whose point o + t d lies farther from
    its mesh's bounding-sphere centre c than that sphere's radius r, plus
    the rounding of the point (OFF_MESH_ROUNDING eps (|o|_1 + |c|_1 + t)
    in the sweep's dtype), is no hit. A genuine hit lies on its triangle,
    so in the convex hull of its corners, so inside the sphere over the
    mesh's corners; Moller-Trumbore on a pole sliver of a lat/long mesh
    (two corners a few ulps apart, |det| just over MT_EPS) reports points
    off the mesh. The rule runs before each chunk's argmin, so a genuine
    hit behind such a point is kept. `tally`, where given, gains the
    candidates the rule rejected and the casts whose nearest hit that
    changed (device tensors)."""
    dev, r = dx.device, dx.shape[0]
    total = soup.count
    chunk = max(1, TRI_CHUNK_ELEMENTS.get(dev.type, 1 << 22) // max(r, 1))
    col = [a.reshape(-1, 1) for a in (ox, oy, oz, dx, dy, dz)]
    inf = torch.tensor(float("inf"), dtype=dx.dtype, device=dev)
    best_t = torch.full((r,), float("inf"), dtype=dx.dtype, device=dev)
    best_u = torch.zeros((r,), dtype=dx.dtype, device=dev)
    best_v = torch.zeros((r,), dtype=dx.dtype, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    off_t = torch.full((r,), float("inf"), dtype=dx.dtype, device=dev)
    rejected = 0
    o_l1 = col[0].abs() + col[1].abs() + col[2].abs()
    slack = OFF_MESH_ROUNDING * torch.finfo(dx.dtype).eps
    for i0 in range(0, total, chunk):
        c = {k: soup.tri[k][i0:i0 + chunk] for k in (
            "v1x", "v1y", "v1z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")}
        t, u, v, valid = _moller_trumbore(*col, c)
        t, u, v = (torch.broadcast_to(a, valid.shape) for a in (t, u, v))
        cx, cy, cz, rad, c_l1 = soup.reach[:, i0:i0 + chunk]
        qx = (col[0] - cx) + t * col[3]
        qy = (col[1] - cy) + t * col[4]
        qz = (col[2] - cz) + t * col[5]
        lim = rad + slack * ((o_l1 + c_l1) + t)
        off = valid & (qx * qx + qy * qy + qz * qz > lim * lim)
        valid = valid & ~off
        rejected = rejected + off.sum()
        off_t = torch.minimum(off_t, torch.where(off, t, inf).amin(dim=1))
        t = torch.where(valid, t, inf)
        ci = torch.argmin(t, dim=1, keepdim=True)
        ct = torch.gather(t, 1, ci).squeeze(1)
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_u = torch.where(better, torch.gather(u, 1, ci).squeeze(1), best_u)
        best_v = torch.where(better, torch.gather(v, 1, ci).squeeze(1), best_v)
        best_tri = torch.where(better, ci.squeeze(1) + i0, best_tri)
    if tally is not None:
        tally["candidates"] = tally["candidates"] + rejected
        tally["casts"] = tally["casts"] + (off_t < best_t).sum()
    missed = ~torch.isfinite(best_t)
    best_t = torch.where(missed, torch.full_like(best_t, -1.0), best_t)
    return best_t, best_u, best_v, best_tri


def triangle_nearest(soup: Soup, ox, oy, oz, dx, dy, dz,
                     tally=None) -> Hit:
    """Nearest triangle hit; the normal interpolated u nb + v nc + w na
    with w = 1 - u - v, not normalized; the index is the mesh id. Lanes
    whose origin is parked at 3e30 (dead paths) report a miss untested.
    `tally`: the sweep's off-mesh tally (`_triangle_sweep`)."""
    shape = dx.shape
    o = [torch.broadcast_to(a, shape).reshape(-1) for a in (ox, oy, oz)]
    d = [a.reshape(-1) for a in (dx, dy, dz)]
    n = d[0].shape[0]
    live = torch.nonzero(o[0] < PARKED).squeeze(1)
    t = torch.full((n,), -1.0, dtype=dx.dtype, device=dx.device)
    u = torch.zeros((n,), dtype=dx.dtype, device=dx.device)
    v = torch.zeros((n,), dtype=dx.dtype, device=dx.device)
    tri = torch.full((n,), -1, dtype=torch.int64, device=dx.device)
    if live.numel():
        got = _triangle_sweep(soup, *(a[live] for a in o + d), tally)
        for dst, src in zip((t, u, v, tri), got):
            dst[live] = src
    safe = tri.clamp(min=0)
    w = 1.0 - u - v
    s = soup.tri

    def interp(a, b, c):
        return u * s[b][safe] + v * s[c][safe] + w * s[a][safe]

    mesh = torch.where(tri < 0, torch.full_like(tri, -1),
                       s["mesh_id"][safe])
    return Hit(t.reshape(shape), interp("nax", "nbx", "ncx").reshape(shape),
               interp("nay", "nby", "ncy").reshape(shape),
               interp("naz", "nbz", "ncz").reshape(shape),
               mesh.reshape(shape), torch.ones_like(t).reshape(shape))


class Scene:
    """The nearest and any-hit casts of a sphere set or a triangle soup,
    its per-object albedo table, and what a hit on it costs to test (for
    the work counts)."""

    def __init__(self, geometry, fast_math: bool):
        self.geometry = geometry
        self.fast = fast_math
        self.albedo = geometry.albedo
        self.kind = "sphere" if isinstance(geometry, Spheres) else "triangle"
        self.off_mesh = {"candidates": 0, "casts": 0}

    def take_off_mesh(self) -> dict:
        """The triangle sweep's off-mesh tally since the last take, as
        ints: candidates the rule rejected, casts whose nearest hit it
        changed. No work count (`Counts`): no implementation has to do it."""
        got = {k: int(v) for k, v in self.off_mesh.items()}
        self.off_mesh = {"candidates": 0, "casts": 0}
        return got

    def nearest(self, ox, oy, oz, dx, dy, dz) -> Hit:
        if self.kind == "sphere":
            return sphere_nearest(self.geometry, self.fast, ox, oy, oz,
                                  dx, dy, dz)
        return triangle_nearest(self.geometry, ox, oy, oz, dx, dy, dz,
                                self.off_mesh)

    def any(self, ox, oy, oz, dx, dy, dz):
        if self.kind == "sphere":
            return sphere_any(self.geometry, ox, oy, oz, dx, dy, dz)
        return self.nearest(ox, oy, oz, dx, dy, dz).t >= 0.0


# --------------------------------------------------------------------------
# The path.

class Counts:
    """Work of the traced lanes, summed on the device: pixel touches,
    samples, the draw pairs their paths need (the lockstep tracer draws
    more),
    nearest-hit segments that hit (`hits`), any-hit segments that hit
    (`any_hits`), scatters, emissive hits whose emission is kept, sky
    evaluations, those inside the Mandelbrot box and their escape
    iterations; under NEE the vertices that sample a light (`nee`), those
    whose sample takes the balance weight (`nee_mis`), the shadow casts
    that must be made (a weight not 0) and hit a primitive
    (`shadow_hits`), and the balance weights of emission that BSDF rays
    found (`mis_emission`)."""

    KEYS = ("touches", "samples", "pairs", "hits", "any_hits", "scatters",
            "emissive", "sky", "sky_in", "sky_iters", "nee", "nee_mis",
            "shadow_hits", "mis_emission")

    def __init__(self):
        self.c = {k: 0 for k in self.KEYS}

    def add(self, key, mask_or_n):
        self.c[key] = self.c[key] + (mask_or_n.sum() if isinstance(
            mask_or_n, torch.Tensor) else mask_or_n)

    def totals(self) -> dict:
        return {k: int(v) for k, v in self.c.items()}


# --------------------------------------------------------------------------
# Next event estimation by cone sampling, and the balance heuristic.

class ConeLights:
    """The E lights of a mesh scene: columns e * emissive_every of the
    meshes' bounding spheres (M, 4) [cx, cy, cz, r^2]."""

    def __init__(self, bounds: torch.Tensor, emissive_every: int):
        meshes = bounds.shape[0]
        self.n_lights = (meshes + emissive_every - 1) // emissive_every
        self.index = torch.arange(self.n_lights,
                                  device=bounds.device) * emissive_every
        self.rows = bounds.T[:4, self.index]
        self.bound_r2 = bounds[:, 3]

    def pick(self, u_pick):
        """(cx, cy, cz, r2, index) of light min(int(u_pick E), E - 1)."""
        sel = torch.clamp((u_pick * float(self.n_lights)).to(torch.int32),
                          max=self.n_lights - 1).long()
        cx, cy, cz, r2 = (self.rows[i][sel] for i in range(4))
        return cx, cy, cz, r2, self.index[sel]


def cone_solid_angle(d2, r2):
    """(Omega, cos_max) = (2 pi (1 - cos_max), cos_max) of a sphere of
    squared radius r2 seen from squared distance d2; the whole sphere of
    directions (cos_max = -1, 4 pi) from inside it."""
    inside = d2 <= r2
    cos_max = sqrt(torch.clamp(1.0 - r2 / torch.clamp(d2, min=1e-20),
                               min=0.0))
    cos_max = torch.where(inside, torch.full_like(cos_max, -1.0), cos_max)
    return (2.0 * PI) * (1.0 - cos_max), cos_max


def _balance(w, p_nee, p_bsdf):
    return w * p_nee / torch.clamp(p_nee + p_bsdf, min=1e-20)


def nee_cone(cfg, scene: Scene, lights: ConeLights, u_pick, u1, u2, h, n,
             kd, tp, mis: bool, surface, counts):
    """Direct light at the vertices h (3-tuple) with shading normals n
    (normalized here), Lambert albedo kd and throughput tp before the
    scatter: a direction uniform in the cone of the picked light's
    bounding sphere, cast through the scene's nearest-hit sweep, counted
    iff it hits that mesh, with Le = scale / (4 pi) and the estimator's
    weight E Omega, or with `mis` the balance weight against the BSDF's
    pdf cos / pi. Returns (r, g, b); `surface` the lanes that take it."""
    hx, hy, hz = h
    cx, cy, cz, r2, light_idx = lights.pick(u_pick)
    wx, wy, wz = cx - hx, cy - hy, cz - hz
    d2 = wx * wx + wy * wy + wz * wz
    omega, cos_max = cone_solid_angle(d2, r2)
    a = normalize3(wx, wy, wz)
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * PI) * u2
    tangent, bitangent = frame_z(*a)
    lx, ly, lz = local_to_world(sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                                cos_t, tangent, bitangent, a)
    eps = cfg["ray_epsilon"]
    # Lanes that take no NEE cast from far away: the sweep skips them.
    far = torch.full_like(hx, 3.0e30)
    so = tuple(torch.where(surface, o + eps * dc, far)
               for o, dc in zip(h, (lx, ly, lz)))
    sh = scene.nearest(*so, lx, ly, lz)
    lit = (sh.t >= 0.0) & (sh.index == light_idx)
    nh = normalize3(*n)
    cos_s = torch.clamp(nh[0] * lx + nh[1] * ly + nh[2] * lz, min=0.0)
    f = tuple(k * (1.0 / PI) for k in kd)
    p_bsdf = cos_s * (1.0 / PI)
    le = cfg["emission_scale"] / (4.0 * PI)
    w = cos_s * le * float(lights.n_lights) * omega
    if mis:
        p_nee = 1.0 / torch.clamp(float(lights.n_lights) * omega, min=1e-20)
        w = _balance(w, p_nee, p_bsdf)
    if counts is not None:
        counts.add("nee", surface)
        if mis:
            counts.add("nee_mis", surface)
        counts.add("shadow_hits", surface & (w != 0.0) & (sh.t >= 0.0))
    w = torch.where(lit, w, torch.zeros_like(w))
    return tuple(t * fc * w for t, fc in zip(tp, f))


def mis_emission_weight(lights: ConeLights, prev_pdf, bd, cur_t, n, index):
    """Balance weight prev_pdf / (prev_pdf + p_nee) of emission that a BSDF
    ray (direction bd, pdf prev_pdf) found at distance cur_t on mesh
    `index` with hit normal n: p_nee = 1 / (E Omega), the pdf of cone NEE
    over the mesh's bound seen from the previous vertex, whose centre is
    rebuilt as the hit minus n r."""
    bdx, bdy, bdz = bd
    nx, ny, nz = n
    bound_r2 = lights.bound_r2[index.clamp(min=0)]
    r = sqrt(torch.clamp(bound_r2, min=1e-20))
    vx = cur_t * bdx - nx * r
    vy = cur_t * bdy - ny * r
    vz = cur_t * bdz - nz * r
    d2 = vx * vx + vy * vy + vz * vz
    omega, _ = cone_solid_angle(d2, bound_r2)
    p_nee = 1.0 / torch.clamp(float(lights.n_lights) * omega, min=1e-20)
    return prev_pdf / torch.clamp(prev_pdf + p_nee, min=1e-20)


def check_nee(cfg, scene: Scene):
    """The cone lights of `cfg`'s NEE, or None without NEE; ValueError,
    naming the setting, for NEE settings the reference does not render.
    (Explicit lights are program buffers, not configuration fields: the
    harness builds none.)"""
    if not cfg.get("nee", False):
        return None
    if scene.kind != "triangle":
        raise ValueError("the reference renders NEE by cone sampling on "
                         "meshes; area NEE on spheres (nee with scene_kind "
                         "'sphere') is not covered")
    for key, plain in (("fog_density", 0.0), ("material_mode", "procedural"),
                       ("normal_map", 0.0)):
        if cfg.get(key, plain) != plain:
            raise ValueError(f"the reference renders NEE with {key} "
                             f"{plain!r}, not {cfg[key]!r}")
    return ConeLights(scene.geometry.bounds, cfg["emissive_every"])


def _emit_term(cfg, emis_r2):
    den = (4.0 * PI) * torch.clamp(emis_r2, min=1e-20)
    return torch.full_like(den, cfg["emission_scale"]) / den


def _scatter(cfg, scene: Scene, sampler, bo, bd, cur_t, n, index, diffuse,
             tp, col, counts, b: int, lights=None, prev_pdf=None,
             emission_ok=None):
    """Lambert scatter at the vertex bo + cur_t bd of bounce b, NEE there
    (`lights`), Russian roulette, and the continuation origin (parked far
    away for dead lanes). A diffuse lane draws a hemisphere pair, under
    NEE a light pick word and a direction pair, and a roulette word: the
    spare of the pick's pair; without NEE at the first vertex a fresh
    pair's first word, later that pair's second. Under NEE with MIS,
    prev_pdf becomes the sampled direction's pdf (cos / pi); without MIS,
    emission_ok becomes 0 where NEE was taken. NEE takes its balance
    weight but at the last bounce, whose BSDF ray collects no emission.
    Returns (bo, bd, tp, col, survive, cast_o, prev_pdf, emission_ok)."""
    box, boy, boz = bo
    bdx, bdy, bdz = bd
    hx = box + cur_t * bdx
    hy = boy + cur_t * bdy
    hz = boz + cur_t * bdz
    row = scene.albedo[index.clamp(min=0)]
    kd = (row[..., 0], row[..., 1], row[..., 2])
    fast = cfg["fast_math"]
    (tx, ty, tz), (bx, by, bz) = frame_z(*n, fast=fast)
    u1, u2 = sampler.draw2()
    lx, ly, lz = cosine_hemisphere(u1, u2)
    zx, zy, zz = n
    wd = normalize3(tx * lx + bx * ly + zx * lz, ty * lx + by * ly + zy * lz,
                    tz * lx + bz * ly + zz * lz, fast=fast)
    if lights is not None:
        if cfg["mis"]:
            prev_pdf = torch.where(diffuse, lz * (1.0 / PI), prev_pdf)
        u_pick = sampler.draw1()
        ul1, ul2 = sampler.draw2()
        mis_here = cfg["mis"] and b + 1 < cfg["max_bounces"]
        d = nee_cone(cfg, scene, lights, u_pick, ul1, ul2, (hx, hy, hz), n,
                     kd, tp, mis_here, diffuse, counts)
        col = tuple(torch.where(diffuse, c + dc, c) for c, dc in zip(col, d))
        if not cfg["mis"]:
            emission_ok = torch.where(diffuse, torch.zeros_like(emission_ok),
                                      emission_ok)
    bo = (torch.where(diffuse, hx, box), torch.where(diffuse, hy, boy),
          torch.where(diffuse, hz, boz))
    bd = tuple(torch.where(diffuse, wc, bc) for wc, bc in zip(wd, bd))
    tp = tuple(torch.where(diffuse, t * wc, t) for t, wc in zip(tp, kd))
    rr = sampler.draw1()
    rr_prob = torch.clamp(luminance(*tp), max=cfg["rr_ceiling"])
    survive = diffuse & (rr < rr_prob)
    rcp_p = 1.0 / torch.clamp(rr_prob, min=1e-20)
    tp = tuple(torch.where(survive, t * rcp_p, t) for t in tp)
    far = torch.full_like(bo[0], 3.0e30)
    cast_o = tuple(torch.where(survive, o + cfg["ray_epsilon"] * dc, far)
                   for o, dc in zip(bo, bd))
    if counts is not None:
        counts.add("scatters", diffuse)
        counts.add("pairs", diffuse)
        if lights is not None:  # the pick's pair and the direction pair
            counts.add("pairs", 2 * diffuse.sum())
        elif b == 0:
            counts.add("pairs", diffuse)
    return bo, bd, tp, col, survive, cast_o, prev_pdf, emission_ok


def trace(cfg, scene: Scene, sampler, ox, oy, oz, dx, dy, dz,
          counts: Counts | None = None, lights: ConeLights | None = None):
    """(r, g, b) of one sample per lane; `lights` the cone lights of NEE,
    or None. Under NEE, emission that a BSDF ray finds after a diffuse
    vertex (which took NEE) takes the balance weight with MIS and is
    dropped without it; camera-direct emission is kept whole."""
    shape = dx.shape
    hit = scene.nearest(ox, oy, oz, dx, dy, dz)
    o = tuple(torch.broadcast_to(v, shape) for v in (ox, oy, oz))
    p_active = hit.t >= 0.0
    p_miss = hit.t == -1.0
    p_emissive = p_active & (hit.index % cfg["emissive_every"] == 0)
    p_diffuse = p_active & ~p_emissive
    zero = torch.zeros(shape, dtype=dx.dtype, device=dx.device)
    base = torch.where(p_emissive, _emit_term(cfg, hit.emis_r2), zero)
    col = (base, base, base)
    dist = torch.where(p_emissive, torch.full_like(zero, -2.0), hit.t)
    ones = torch.ones_like(zero)
    if counts is not None:
        counts.add("hits", p_active)
        counts.add("emissive", p_emissive)
    prev_pdf = emission_ok = None
    if lights is not None:  # primaries are not sampled
        prev_pdf = torch.ones_like(zero)
        emission_ok = torch.ones(shape, dtype=torch.int32, device=dx.device)
    bo, bd, tp, col, survive, cast_o, prev_pdf, emission_ok = _scatter(
        cfg, scene, sampler, o, (dx, dy, dz), hit.t,
        (hit.nx, hit.ny, hit.nz), hit.index, p_diffuse, (ones, ones, ones),
        col, counts, 0, lights, prev_pdf, emission_ok)
    dist = torch.where(p_diffuse & ~survive, torch.full_like(dist, -2.0),
                       dist)
    entered = p_diffuse | p_miss

    def final_dist(dist, survive, cast_o, bd):
        hit_any = scene.any(*cast_o, *bd)
        if counts is not None:
            counts.add("any_hits", survive & hit_any)
        return torch.where(survive, torch.where(
            hit_any, torch.ones_like(dist), torch.full_like(dist, -1.0)),
            dist)

    if cfg["max_bounces"] <= 1:
        dist = final_dist(dist, survive, cast_o, bd)
    else:
        new = scene.nearest(*cast_o, *bd)
        if counts is not None:
            counts.add("hits", survive & (new.t >= 0.0))
        dist = torch.where(survive, new.t, dist)
        cur_t = new.t
        bo = cast_o
        for b in range(1, cfg["max_bounces"]):
            active = dist >= 0.0
            emissive = active & (new.index % cfg["emissive_every"] == 0)
            diffuse = active & ~emissive
            emit = _emit_term(cfg, new.emis_r2)
            add = emissive
            if lights is not None and cfg["mis"]:
                emit = emit * mis_emission_weight(
                    lights, prev_pdf, bd, new.t, (new.nx, new.ny, new.nz),
                    new.index)
                if counts is not None:
                    counts.add("mis_emission", emissive)
            elif lights is not None:
                add = emissive & (emission_ok == 1)
            col = tuple(torch.where(add, c + t * emit, c)
                        for c, t in zip(col, tp))
            dist = torch.where(emissive, torch.full_like(dist, -2.0), dist)
            if counts is not None:
                counts.add("emissive", add)
            bo, bd, tp, col, survive, cast_o, prev_pdf, emission_ok = \
                _scatter(cfg, scene, sampler, bo, bd, cur_t,
                         (new.nx, new.ny, new.nz), new.index, diffuse, tp,
                         col, counts, b, lights, prev_pdf, emission_ok)
            dist = torch.where(diffuse & ~survive,
                               torch.full_like(dist, -2.0), dist)
            if b + 1 == cfg["max_bounces"]:
                dist = final_dist(dist, survive, cast_o, bd)
            else:
                new = scene.nearest(*cast_o, *bd)
                if counts is not None:
                    counts.add("hits", survive & (new.t >= 0.0))
                cur_t = new.t
                dist = torch.where(survive, new.t, dist)
    env_ok = entered & (dist == -1.0)
    le, in_box, iters = mandelbrot(*bd)
    le = le * cfg["env_scale"]
    if counts is not None:
        counts.add("sky", env_ok)
        counts.add("sky_in", env_ok & in_box)
        counts.add("sky_iters", torch.where(env_ok & in_box, iters,
                                            torch.zeros_like(iters)))
    return tuple(torch.where(env_ok, c + t * le, c) for c, t in zip(col, tp))


def primary_rays(cfg, cam: torch.Tensor, px, py, u1, u2):
    """The jittered "fovy" ray of pixel (px, py): NDC scaled by (aspect
    tan(fovy/2), tan(fovy/2), -1), through the inverse view; the
    direction normalized (rsqrt under fast_math)."""
    if cfg["ray_gen"] != "fovy":
        raise ValueError(f"the reference renders ray_gen 'fovy', not "
                         f"{cfg['ray_gen']!r}")
    sx = (px + u1) * (1.0 / cfg["width"])
    sy = (py + u2) * (1.0 / cfg["height"])
    ndx = -1.0 + 2.0 * sx
    ndy = -1.0 + 2.0 * sy
    vx = ndx * cam[9, 0] * cam[9, 1]
    vy = ndy * cam[9, 1]
    vz = -1.0

    def row(i):
        return cam[i, 0] * vx + cam[i, 1] * vy + cam[i, 2] * vz + cam[i, 3]

    dx, dy, dz = normalize3(row(0) - cam[8, 0], row(1) - cam[8, 1],
                            row(2) - cam[8, 2], fast=cfg["fast_math"])
    return cam[8, 0], cam[8, 1], cam[8, 2], dx, dy, dz


def safe_gamma(x, gamma: float):
    safe = torch.clamp(x, min=1e-30)
    return torch.where(x <= 0.0, torch.zeros_like(x),
                       torch.exp(gamma * torch.log(safe)))


def render(cfg, scene: Scene, camera: np.ndarray, pixels: torch.Tensor,
           count_before: torch.Tensor, touches: torch.Tensor,
           rgb_before: torch.Tensor | None = None, dtype=torch.float32,
           counts: Counts | None = None, lane_chunk: int = 1 << 18):
    """The accumulation and display planes of the pixels `pixels` (flat
    indices into the padded frame) after a call that touches pixel i
    touches[i] times, `spp_per_step` samples each, from the sample count
    count_before[i] and the radiance sums rgb_before (3, P) (zero where
    None). Sample j of a pixel draws from Philox(key (seed, 0), counter
    (pixel, count + j, pair >> 1, 0)). Returns (accum (4, P), output
    (3, P)) in float32: per touch the samples' sum in sample order is
    added to the sums, then the display is pow(sums / count, gamma).
    `dtype`: the tracing precision (float32; lower for the control). The
    samples are traced `lane_chunk` lanes at a time (per-lane arithmetic
    does not depend on it)."""
    dev = pixels.device
    spp = cfg["spp_per_step"]
    wp = cfg["padded_width"]
    p = pixels.shape[0]
    rgb = (torch.zeros((3, p), dtype=torch.float32, device=dev)
           if rgb_before is None else rgb_before.clone())
    n = count_before.to(torch.float32).clone()
    cam = torch.as_tensor(np.asarray(camera, np.float32)).to(dev, dtype)
    lights = check_nee(cfg, scene)
    pairs = max_pairs_per_sample(cfg["max_bounces"], lights is not None)
    # One lane per sample of the call: touch j's pixels `sel`, each with
    # its spp samples; traced together, summed per touch below.
    touched, lane_pix, lane_sample = [], [], []
    for j in range(int(touches.max()) if p else 0):
        sel = torch.nonzero(touches > j).squeeze(1)
        first = count_before[sel].to(torch.int64) + spp * j
        touched.append(sel)
        lane_pix.append(pixels[sel].repeat_interleave(spp))
        lane_sample.append((first[:, None] + torch.arange(
            spp, device=dev)).reshape(-1))
    pix = torch.cat(lane_pix) if touched else pixels[:0]
    sample = torch.cat(lane_sample) if touched else pixels[:0]
    col = torch.empty((3, pix.numel()), dtype=dtype, device=dev)
    for c0 in range(0, pix.numel(), lane_chunk):
        pc, sc = pix[c0:c0 + lane_chunk], sample[c0:c0 + lane_chunk]
        sampler = PhiloxSampler(cfg["seed"], 0, pc, sc, pairs, dtype)
        u1, u2 = sampler.draw2()
        rays = primary_rays(cfg, cam, (pc % wp).to(dtype),
                            (pc // wp).to(dtype), u1, u2)
        c = trace(cfg, scene, sampler, *rays, counts=counts, lights=lights)
        for k in range(3):
            col[k, c0:c0 + pc.numel()] = c[k]
    if counts is not None:  # the jitter pair
        counts.add("samples", pix.numel())
        counts.add("pairs", pix.numel())
    off = 0
    for sel in touched:
        block = col[:, off:off + sel.numel() * spp].reshape(3, -1, spp)
        off += sel.numel() * spp
        sums = [torch.zeros(sel.shape, dtype=dtype, device=dev)
                for _ in range(3)]
        for s in range(spp):
            sums = [a + block[k, :, s] for k, a in enumerate(sums)]
        for k in range(3):
            rgb[k, sel] = rgb[k, sel] + sums[k].to(torch.float32)
        if counts is not None:
            counts.add("touches", sel.numel())
        n[sel] = n[sel] + float(spp)
    inv = 1.0 / n
    out = torch.stack([safe_gamma(rgb[k] * inv, cfg["gamma"])
                       for k in range(3)])
    return torch.cat([rgb, n[None]]), out


def make_scene(cfg: dict, device, dtype=torch.float32) -> Scene:
    from portbench.reference.scene import make_soup, make_spheres
    geometry = (make_spheres(cfg, device, dtype) if cfg["scene_kind"] ==
                "sphere" else make_soup(cfg, device, dtype))
    return Scene(geometry, cfg["fast_math"])
