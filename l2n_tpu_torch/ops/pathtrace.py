"""The path tracer in lane-lockstep torch: ray generation, the masked
bounce loop and the triangle AOVs (counterpart of l2n_tpu.ops.pathtrace
for the port's configs: pathtracing, tex_coords and param_uv AOVs,
procedural Lambert, no NEE/MIS/fog/lights).

This is the plain version the CPU tests and `backend="torch"` run. It is a
mask translation of the JAX package's `trace_path` / `_scatter_and_roulette`
/ `_finish_path`, kept op for op so the two agree to the last ulp of
sin/cos: every lane runs every bounce's arithmetic and masks decide what is
kept. The tri-state `dist` sentinel is preserved exactly (t >= 0 hit, -1
miss -> environment, -2 terminated), because the environment test is
literally `dist == -1`. The CUDA kernel computes the same per pixel with
divergent control flow (csrc/pathtrace.cuh).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from l2n_tpu_torch.camera.camera import ROW_POSITION, ROW_PROJ, ROW_RCP_VIEW
from l2n_tpu_torch.maths.sampling import (
    PI,
    cosine_sample_hemisphere,
    frame_z,
    local_to_world,
    luminance,
    normalize3,
)
from l2n_tpu_torch.ops.envlight import env_radiance


@dataclasses.dataclass
class Hit:
    """Resolved hit record (lane tensors). `index` is the sphere or mesh
    index (-1 on miss), which keys the albedo table and the emissive rule;
    `emis_r2` the squared radius in the emission formula (1 for meshes).
    `tc_u/tc_v` (texcoords) and `b_u/b_v` (barycentrics) are None for
    scenes without them."""

    t: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    index: torch.Tensor
    emis_r2: torch.Tensor
    tc_u: torch.Tensor | None = None
    tc_v: torch.Tensor | None = None
    b_u: torch.Tensor | None = None
    b_v: torch.Tensor | None = None


IntersectFn = Callable[..., Hit]  # (ox, oy, oz, dx, dy, dz) -> Hit
AnyHitFn = Callable[..., torch.Tensor]  # (ox, oy, oz, dx, dy, dz) -> bool


def generate_rays(cfg, cam: torch.Tensor, px, py, u1, u2):
    """Jittered primary rays for float pixel coords (px, py), the "fovy"
    form: NDC scaled by (ratio*tanHalfFovy, tanHalfFovy, -1), then the
    inverse view. `cam` is the packed (10, 4) camera block as a tensor.
    Returns (ox, oy, oz, dx, dy, dz); the origin stays 0-dim (all primary
    rays share the camera position)."""
    if cfg.ray_gen != "fovy":
        raise NotImplementedError(
            f"ray_gen={cfg.ray_gen!r} is ROADMAP Queue 1 #9")
    sx = (px + u1) * (1.0 / (cfg.ndc_width or cfg.width))
    sy = (py + u2) * (1.0 / (cfg.ndc_height or cfg.height))
    ndx = -1.0 + 2.0 * sx
    ndy = -1.0 + 2.0 * sy
    pos_x, pos_y, pos_z = (cam[ROW_POSITION, 0], cam[ROW_POSITION, 1],
                           cam[ROW_POSITION, 2])
    ratio = cam[ROW_PROJ, 0]
    tan_half = cam[ROW_PROJ, 1]
    vx = ndx * ratio * tan_half
    vy = ndy * tan_half
    vz = -1.0
    r = ROW_RCP_VIEW
    wx = cam[r + 0, 0] * vx + cam[r + 0, 1] * vy + cam[r + 0, 2] * vz + cam[r + 0, 3]
    wy = cam[r + 1, 0] * vx + cam[r + 1, 1] * vy + cam[r + 1, 2] * vz + cam[r + 1, 3]
    wz = cam[r + 2, 0] * vx + cam[r + 2, 1] * vy + cam[r + 2, 2] * vz + cam[r + 2, 3]
    dx, dy, dz = normalize3(wx - pos_x, wy - pos_y, wz - pos_z)
    return pos_x, pos_y, pos_z, dx, dy, dz


def _env_term(cfg, edx, edy, edz):
    return env_radiance(cfg.env_mode, edx, edy, edz) * cfg.env_scale


def _emit_term(cfg, emis_r2):
    """scale / (4 pi r^2), guarded where r2 is meaningless."""
    # A tensor numerator: torch computes `scalar / tensor` as a reciprocal
    # times the scalar, two roundings where JAX rounds once.
    den = (4.0 * PI) * torch.clamp(emis_r2, min=1e-20)
    return torch.full_like(den, cfg.emission_scale) / den


def _resolve_vertex(cfg, dist, index, emis_r2, tp, col):
    """Emissive lanes add their weighted radiance and terminate."""
    active = dist >= 0.0
    emissive = active & (index % cfg.emissive_every == 0)
    diffuse = active & ~emissive
    emit = _emit_term(cfg, emis_r2)
    col = tuple(torch.where(emissive, c + t * emit, c) for c, t in zip(col, tp))
    dist = torch.where(emissive, torch.full_like(dist, -2.0), dist)
    return dist, diffuse, col


def _scatter_and_roulette(cfg, albedo, sampler, bo, bd, cur_t, n, index,
                          diffuse, tp):
    """Procedural-Lambert bounce at the vertex bo + cur_t*bd: cosine sample,
    throughput update, Russian roulette, continuation origin (far-parked for
    dead lanes). Returns (bo, bd, tp, survive, cast_o)."""
    box, boy, boz = bo
    bdx, bdy, bdz = bd
    hx = box + cur_t * bdx
    hy = boy + cur_t * bdy
    hz = boz + cur_t * bdz
    kd = albedo[index.clamp(min=0)]  # miss lanes read row 0, never kept
    tangent, bitangent = frame_z(*n)
    u1, u2 = sampler.draw2()
    (lx, ly, lz), _ = cosine_sample_hemisphere(u1, u2)
    wd = normalize3(*local_to_world(lx, ly, lz, tangent, bitangent, n))

    bo = (torch.where(diffuse, hx, box), torch.where(diffuse, hy, boy),
          torch.where(diffuse, hz, boz))
    bd = tuple(torch.where(diffuse, w, b) for w, b in zip(wd, bd))
    tp = tuple(torch.where(diffuse, t * kd[..., i], t) for i, t in enumerate(tp))

    rr = sampler.draw1()
    rr_prob = torch.clamp(luminance(*tp), max=cfg.rr_ceiling)
    survive = diffuse & (rr < rr_prob)
    rcp_p = 1.0 / torch.clamp(rr_prob, min=1e-20)
    tp = tuple(torch.where(survive, t * rcp_p, t) for t in tp)
    far = torch.full_like(bo[0], 3.0e30)
    cast_o = tuple(torch.where(survive, o + cfg.ray_epsilon * d, far)
                   for o, d in zip(bo, bd))
    return bo, bd, tp, survive, cast_o


def _finish_path(cfg, intersect, anyhit, albedo, sampler, entered, pending,
                 dist, cast_o, bd, tp, col):
    """Intersect the pending cast of iteration 0, run iterations
    1..max_bounces-1, resolve the last segment with the any-hit test and add
    the sky where a path that entered the scene (or missed it from the
    camera) ends on a miss."""

    def env_add(col, dist, bd, tp):
        if cfg.env_mode == "none":
            return col
        env_ok = entered & (dist == -1.0)
        le = _env_term(cfg, *bd)
        return tuple(torch.where(env_ok, c + t * le, c) for c, t in zip(col, tp))

    def final_dist(dist, survive, cast_o, bd):
        hit_any = anyhit(*cast_o, *bd)
        return torch.where(survive, torch.where(hit_any, torch.ones_like(dist),
                                      torch.full_like(dist, -1.0)), dist)

    if cfg.max_bounces <= 1:
        return env_add(col, final_dist(dist, pending, cast_o, bd), bd, tp)

    new = intersect(*cast_o, *bd)
    bo = cast_o
    cur_t, n, index, emis_r2 = new.t, (new.nx, new.ny, new.nz), new.index, new.emis_r2
    dist = torch.where(pending, new.t, dist)
    for b in range(1, cfg.max_bounces):
        dist, diffuse, col = _resolve_vertex(cfg, dist, index, emis_r2, tp, col)
        bo, bd, tp, survive, cast_o = _scatter_and_roulette(
            cfg, albedo, sampler, bo, bd, cur_t, n, index, diffuse, tp)
        dist = torch.where(diffuse & ~survive, torch.full_like(dist, -2.0), dist)
        if b + 1 == cfg.max_bounces:
            dist = final_dist(dist, survive, cast_o, bd)
        else:
            new = intersect(*cast_o, *bd)
            cur_t, n = new.t, (new.nx, new.ny, new.nz)
            index, emis_r2 = new.index, new.emis_r2
            dist = torch.where(survive, new.t, dist)
            # As in the JAX package, the next vertex is placed from `bo`
            # (this vertex, returned by the scatter), not from the cast
            # origin; only iteration 1 measures from the cast origin.
    return env_add(col, dist, bd, tp)


def trace_path(cfg, intersect: IntersectFn, anyhit: AnyHitFn,
               albedo: torch.Tensor, sampler, ox, oy, oz, dx, dy, dz):
    """Trace one sample per lane; returns (r, g, b).

    Radiance is added when a lane resolves: emissive hits when they
    terminate, the sky at the single environment site in _finish_path,
    which covers primary misses too (their direction and throughput never
    change). `albedo` is the scene's (n, 3) table.
    """
    hit = intersect(ox, oy, oz, dx, dy, dz)
    shape = dx.shape
    o = tuple(torch.broadcast_to(v, shape) for v in (ox, oy, oz))
    p_active = hit.t >= 0.0
    p_emissive = p_active & (hit.index % cfg.emissive_every == 0)
    p_diffuse = p_active & ~p_emissive
    p_miss = hit.t == -1.0
    zero = torch.zeros(shape, dtype=dx.dtype, device=dx.device)
    base = torch.where(p_emissive, _emit_term(cfg, hit.emis_r2), zero)
    col = (base, base, base)
    dist = torch.where(p_emissive, torch.full_like(zero, -2.0), hit.t)
    ones = torch.ones_like(zero)
    _, bd, tp, survive, cast_o = _scatter_and_roulette(
        cfg, albedo, sampler, o, (dx, dy, dz), hit.t,
        (hit.nx, hit.ny, hit.nz), hit.index, p_diffuse, (ones, ones, ones))
    dist = torch.where(p_diffuse & ~survive, torch.full_like(dist, -2.0), dist)
    return _finish_path(cfg, intersect, anyhit, albedo, sampler,
                        p_diffuse | p_miss, survive, dist, cast_o, bd, tp,
                        col)


def _magenta_on_miss(h: Hit, r, g):
    """(r, g, 0) where the primary ray hits, magenta (1, 0, 1) on a miss."""
    m = h.t >= 0.0
    zero = torch.zeros_like(h.t)
    one = torch.ones_like(h.t)
    return torch.where(m, r, one), torch.where(m, g, zero), torch.where(m, zero, one)


def aov_tex_coords(intersect: IntersectFn, ox, oy, oz, dx, dy, dz):
    """Interpolated texcoords of the primary hit; magenta on a miss."""
    h = intersect(ox, oy, oz, dx, dy, dz)
    return _magenta_on_miss(h, h.tc_u, h.tc_v)


def aov_param_uv(intersect: IntersectFn, ox, oy, oz, dx, dy, dz):
    """Barycentric (u, v) of the primary hit; magenta on a miss."""
    h = intersect(ox, oy, oz, dx, dy, dz)
    return _magenta_on_miss(h, h.b_u, h.b_v)


def shade(cfg, intersect: IntersectFn, anyhit: AnyHitFn, albedo, sampler,
          ox, oy, oz, dx, dy, dz):
    """Dispatch on cfg.aov: the path tracer, or a primary-only AOV."""
    if cfg.aov == "pathtracing":
        return trace_path(cfg, intersect, anyhit, albedo, sampler,
                          ox, oy, oz, dx, dy, dz)
    if cfg.aov == "tex_coords":
        return aov_tex_coords(intersect, ox, oy, oz, dx, dy, dz)
    if cfg.aov == "param_uv":
        return aov_param_uv(intersect, ox, oy, oz, dx, dy, dz)
    raise NotImplementedError(
        f"aov={cfg.aov!r}: the normal, hit and ambient_occlusion AOVs are "
        "ROADMAP Queue 1 #9")
