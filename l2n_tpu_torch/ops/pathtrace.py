"""The path tracer in lane-lockstep torch: ray generation, the masked
bounce loop and the primary-only AOVs (counterpart of l2n_tpu.ops.pathtrace
for the port's configs: the pathtracing, normal, hit, ambient_occlusion,
tex_coords and param_uv AOVs, the fovy and viewproj cameras, fast_math,
procedural Lambert or the microfacet / Disney materials, normal mapping,
the explicit point and directional lights, next event estimation and MIS
(ops/nee.py), and homogeneous fog: collision sampling per path segment,
isotropic scattering at a collision, Beer-Lambert transmittance of the
shadow and light rays).

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

import contextlib
import dataclasses
import functools
from typing import Callable

import torch

from l2n_tpu_torch.camera.camera import (
    ROW_POSITION,
    ROW_PROJ,
    ROW_RCP_VIEW,
    ROW_RCP_VIEW_PROJ,
)
from l2n_tpu_torch.maths.brdf import (
    eval_brdf,
    eval_disney,
    sample_brdf,
    sample_disney,
)
from l2n_tpu_torch.maths.bump import perturb_normal
from l2n_tpu_torch.maths.sampling import (
    PI,
    cosine_sample_hemisphere,
    frame_z,
    local_to_world,
    luminance,
    normalize3,
    sqrt,
)
from l2n_tpu_torch.ops.envlight import env_radiance
from l2n_tpu_torch.ops.fog import fog_inv_sigma, fog_sky
from l2n_tpu_torch.ops.lights import explicit_light_contribution
from l2n_tpu_torch.ops.nee import (
    mis_emission_weight,
    nee_cone_contribution,
    nee_contribution,
)


@dataclasses.dataclass
class Hit:
    """Resolved hit record (lane tensors). `index` is the sphere or mesh
    index (-1 on miss), which keys the albedo table and the emissive rule;
    `emis_r2` the squared radius in the emission formula (1 for meshes).
    `tc_u/tc_v` (texcoords) and `b_u/b_v` (barycentrics) are None for
    scenes without them; `bound_r2`, the squared radius of the winner
    mesh's bounding sphere (cone NEE's MIS weight), None for spheres;
    `tri`, the winner's soup triangle index (-1 on miss), None for
    spheres."""

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
    bound_r2: torch.Tensor | None = None
    tri: torch.Tensor | None = None


IntersectFn = Callable[..., Hit]  # (ox, oy, oz, dx, dy, dz) -> Hit
AnyHitFn = Callable[..., torch.Tensor]  # (ox, oy, oz, dx, dy, dz) -> bool


def generate_rays(cfg, cam: torch.Tensor, px, py, u1, u2):
    """Jittered primary rays for float pixel coords (px, py). `cam` is the
    packed (10, 4) camera block as a tensor. Two forms:
      * "fovy": NDC scaled by (ratio*tanHalfFovy, tanHalfFovy, -1), then the
        inverse view;
      * "viewproj": NDC on the far plane (z = 1) through the inverse
        view-projection, then the perspective divide (1 / w and a multiply).
    The direction is normalized (by rsqrt under fast_math). Returns (ox, oy,
    oz, dx, dy, dz); the origin stays 0-dim (all primary rays share the
    camera position)."""
    sx = (px + u1) * (1.0 / (cfg.ndc_width or cfg.width))
    sy = (py + u2) * (1.0 / (cfg.ndc_height or cfg.height))
    ndx = -1.0 + 2.0 * sx
    ndy = -1.0 + 2.0 * sy
    pos_x, pos_y, pos_z = (cam[ROW_POSITION, 0], cam[ROW_POSITION, 1],
                           cam[ROW_POSITION, 2])
    if cfg.ray_gen == "fovy":
        ratio = cam[ROW_PROJ, 0]
        tan_half = cam[ROW_PROJ, 1]
        vx = ndx * ratio * tan_half
        vy = ndy * tan_half
        vz = -1.0
        r = ROW_RCP_VIEW
    elif cfg.ray_gen == "viewproj":
        vx, vy, vz = ndx, ndy, 1.0
        r = ROW_RCP_VIEW_PROJ
    else:
        raise ValueError(f"unknown ray_gen {cfg.ray_gen!r}")

    def row(i):
        return (cam[r + i, 0] * vx + cam[r + i, 1] * vy + cam[r + i, 2] * vz
                + cam[r + i, 3])

    wx, wy, wz = row(0), row(1), row(2)
    if cfg.ray_gen == "viewproj":
        rcp_w = 1.0 / row(3)
        wx, wy, wz = wx * rcp_w, wy * rcp_w, wz * rcp_w
    dx, dy, dz = normalize3(wx - pos_x, wy - pos_y, wz - pos_z,
                            fast=cfg.fast_math)
    return pos_x, pos_y, pos_z, dx, dy, dz


def _env_term(cfg, edx, edy, edz):
    return env_radiance(cfg.env_mode, edx, edy, edz) * cfg.env_scale


def _emit_term(cfg, emis_r2):
    """scale / (4 pi r^2), guarded where r2 is meaningless."""
    # A tensor numerator: torch computes `scalar / tensor` as a reciprocal
    # times the scalar, two roundings where JAX rounds once.
    den = (4.0 * PI) * torch.clamp(emis_r2, min=1e-20)
    return torch.full_like(den, cfg.emission_scale) / den


def _hit_bound_r2(h: Hit) -> torch.Tensor:
    return h.bound_r2 if h.bound_r2 is not None else h.emis_r2


# ---------------------------------------------------------------------------
# Homogeneous fog (cfg.fog_density > 0). Every path segment draws a
# collision distance t_fog ~ Exp(sigma); a collision before the segment's
# surface (or, on a miss, before the sky shell) is a vertex of its own: it
# scatters isotropically with the weight fog_albedo, takes no NEE and no
# explicit light, and is never emissive. Its host constants are in
# ops/fog.py.
# ---------------------------------------------------------------------------

# The plain path's fog collisions while `count_fog_collisions` is active
# (trace_path adds to it after each sample; "lanes", the current sample's
# collided lanes, is its scratch).
_FOG_COUNTS: dict | None = None


@contextlib.contextmanager
def count_fog_collisions():
    """Count the plain path's fog collisions inside the block into the dict
    it yields: "samples" traced, "collided" samples (at least one collision
    along the path) and "collisions" (every collision of a live segment).
    A host sync per sample: for checks, not for timing."""
    global _FOG_COUNTS
    prev = _FOG_COUNTS
    _FOG_COUNTS = {"samples": 0, "collided": 0, "collisions": 0}
    try:
        yield _FOG_COUNTS
    finally:
        _FOG_COUNTS = prev


def _fog_collision(cfg, sampler, mask, hit_t):
    """Collision sampling: t_fog = -log(u) / sigma from one draw1 (every
    lane draws, so the counter layout is static), against the segment's
    hit distance, or the sky shell's on a miss (hit_t < 0). Returns (medium,
    t_fog): `mask` lanes whose collision comes first."""
    u = sampler.draw1(mask=mask)
    t_fog = -torch.log(u) * fog_inv_sigma(cfg)
    t_lim = torch.where(hit_t >= 0.0, hit_t,
                        torch.full_like(hit_t, fog_sky(cfg)))
    medium = mask & (t_fog < t_lim)
    if _FOG_COUNTS is not None:
        _FOG_COUNTS["lanes"] = _FOG_COUNTS.get("lanes", False) | medium
        _FOG_COUNTS["collisions"] += int(medium.sum())
    return medium, t_fog


def _resolve_vertex(cfg, dist, bd, h: Hit, tp, col, nee=None, prev_pdf=None,
                    emission_ok=None, medium=None):
    """At a bounce vertex (b >= 1), the emissive lanes of the hit h (found
    along bd) add their radiance and terminate. Under NEE (`nee`, the
    scene's ops/nee.LightSampler) with MIS the emission is weighted against
    NEE's pdf of the same direction (mis_emission_weight, prev_pdf the
    pdf of the BSDF sample that found it); without MIS only lanes whose
    `emission_ok` is 1 keep it. Under fog the `medium` lanes (a collision)
    are never emissive, and with MIS emission_ok 2 (the ray left a fog
    vertex, which took no NEE) keeps the emission's full weight."""
    active = dist >= 0.0
    emissive = active & (h.index % cfg.emissive_every == 0)
    if medium is not None:
        emissive = emissive & ~medium
    diffuse = active & ~emissive
    emit = _emit_term(cfg, h.emis_r2)
    add = emissive
    if nee is not None and cfg.mis:
        w = mis_emission_weight(
            cfg, nee, prev_pdf, bd, h.t, (h.nx, h.ny, h.nz), h.emis_r2,
            _hit_bound_r2(h))
        if medium is not None:
            w = torch.where(emission_ok == 2, torch.ones_like(w), w)
        emit = emit * w
    elif nee is not None:
        add = emissive & (emission_ok == 1)
    col = tuple(torch.where(add, c + t * emit, c) for c, t in zip(col, tp))
    dist = torch.where(emissive, torch.full_like(dist, -2.0), dist)
    return dist, diffuse, col


def _scatter_and_roulette(cfg, table, sampler, bo, bd, cur_t, n, index,
                          diffuse, tp, col, intersect=None, lights=None, b=0,
                          nee=None, prev_pdf=None, emission_ok=None,
                          medium=None):
    """The bounce b at the vertex bo + cur_t*bd: the bump (normal_map), the
    BSDF sample (procedural Lambert, or the microfacet / Disney mixture),
    next event estimation (`nee`, the scene's ops/nee.LightSampler), the
    explicit lights' direct term, the throughput update, Russian roulette
    and the continuation origin (far-parked for dead lanes).

    `table` is the scene's (n, 3 + 6) per-object table: albedo, then
    scene/materials.MATERIAL_CHANNELS (an (n, 3) albedo table does for
    the procedural mode without bump). NEE's shadow ray and the lights'
    are cast through `intersect`. Draws, at diffuse lanes: the hemisphere
    pair; in the material modes one more draw1 for the lobe; with NEE a
    draw1 for the light pick and a pair for the point (or the cone's
    direction); then the RR draw1, which takes the spare word of the last
    draw1 where one is pending.

    Under NEE, `prev_pdf` becomes the sampled direction's pdf (the local
    cosine / pi for Lambert, the mixture's pdf in the material modes) for
    the next vertex's MIS weight, and without MIS `emission_ok` becomes 0
    at the lanes that did NEE. NEE takes its MIS weight but at the last
    bounce (b + 1 == max_bounces), whose BSDF ray never collects emission.

    Under fog the `medium` lanes (a collision at cur_t) consume the same
    draws, then scatter isotropically from (u1, u2) with the weight
    fog_albedo; they add no NEE and no explicit light, and their rays keep
    emission: emission_ok 1 without MIS, 2 (full weight) with it, where a
    surface vertex sets 0, or 1 under MIS.

    Returns (bo, bd, tp, col, survive, cast_o, prev_pdf, emission_ok)."""
    box, boy, boz = bo
    bdx, bdy, bdz = bd
    hx = box + cur_t * bdx
    hy = boy + cur_t * bdy
    hz = boz + cur_t * bdz
    row = table[index.clamp(min=0)]  # miss lanes read row 0, never kept
    kd = (row[..., 0], row[..., 1], row[..., 2])
    if cfg.normal_map > 0.0:
        n = perturb_normal(cfg, row[..., 8], (hx, hy, hz), n)
    brdf_eval = None
    if cfg.material_mode in ("microfacet", "disney"):
        nh = normalize3(*n)
        frame = frame_z(*nh)
        rough = row[..., 3]
        wo = (-bdx, -bdy, -bdz)
        u1, u2 = sampler.draw2(mask=diffuse)
        u_lobe = sampler.draw1(mask=diffuse)
        if cfg.material_mode == "disney":
            params = (row[..., 4], row[..., 5], row[..., 6], row[..., 7])
            wd, w, pdf = sample_disney(u_lobe, u1, u2, nh, frame, wo, kd,
                                       rough, *params)

            def brdf_eval(wi):
                return eval_disney(nh, wo, wi, kd, rough, *params)
        else:
            wd, w, pdf = sample_brdf(u_lobe, u1, u2, nh, frame, wo, kd,
                                     rough)

            def brdf_eval(wi):
                return eval_brdf(nh, wo, wi, kd, rough)
    else:
        tangent, bitangent = frame_z(*n, fast=cfg.fast_math)
        # Only diffuse lanes consume draws (the stateful samplers step no
        # other lane; the counter-based ones ignore the mask).
        u1, u2 = sampler.draw2(mask=diffuse)
        (lx, ly, lz), _ = cosine_sample_hemisphere(u1, u2)
        wd = normalize3(*local_to_world(lx, ly, lz, tangent, bitangent, n),
                        fast=cfg.fast_math)
        w = kd
        pdf = lz * (1.0 / PI)
    surface = diffuse
    if medium is not None:
        # The isotropic phase function: z uniform in (-1, 1), azimuth 2 pi
        # u2; the collision estimator's weight is the albedo.
        mz = 1.0 - 2.0 * u1
        ms = sqrt(torch.clamp(1.0 - mz * mz, min=0.0))
        mphi = (2.0 * PI) * u2
        wd = tuple(torch.where(medium, m, c) for m, c in zip(
            (ms * torch.cos(mphi), ms * torch.sin(mphi), mz), wd))
        alb = torch.full_like(mz, cfg.fog_albedo)
        w = tuple(torch.where(medium, alb, c) for c in w)
        surface = diffuse & ~medium
    if nee is not None:
        if cfg.mis:
            prev_pdf = torch.where(diffuse, pdf, prev_pdf)
        u_pick = sampler.draw1(mask=diffuse)
        ul1, ul2 = sampler.draw2(mask=diffuse)
        mis_here = cfg.mis and b + 1 < cfg.max_bounces
        h = (hx, hy, hz)
        if nee.kind == "area":
            d = nee_contribution(cfg, nee.n_lights, intersect,
                                 nee.sample(u_pick, ul1, ul2), h, n, kd, tp,
                                 mis_here, brdf_eval)
        else:
            d = nee_cone_contribution(cfg, nee, intersect, u_pick, ul1, ul2,
                                      h, n, kd, tp, mis_here, brdf_eval)
        col = tuple(torch.where(surface, c + dc, c) for c, dc in zip(col, d))
        if not cfg.mis:
            emission_ok = torch.where(surface, torch.zeros_like(emission_ok),
                                      emission_ok)
            if medium is not None:
                emission_ok = torch.where(diffuse & medium,
                                          torch.ones_like(emission_ok),
                                          emission_ok)
        elif medium is not None:
            emission_ok = torch.where(
                diffuse, torch.where(medium, torch.full_like(emission_ok, 2),
                                     torch.ones_like(emission_ok)),
                emission_ok)
    if lights is not None and lights.has_lights:
        e = explicit_light_contribution(cfg, lights, intersect, (hx, hy, hz),
                                        n, kd, tp, brdf_eval)
        col = tuple(torch.where(surface, c + ec, c) for c, ec in zip(col, e))

    bo = (torch.where(diffuse, hx, box), torch.where(diffuse, hy, boy),
          torch.where(diffuse, hz, boz))
    bd = tuple(torch.where(diffuse, wc, bc) for wc, bc in zip(wd, bd))
    tp = tuple(torch.where(diffuse, t * wc, t) for t, wc in zip(tp, w))

    rr = sampler.draw1(mask=diffuse)
    rr_prob = torch.clamp(luminance(*tp), max=cfg.rr_ceiling)
    survive = diffuse & (rr < rr_prob)
    rcp_p = 1.0 / torch.clamp(rr_prob, min=1e-20)
    tp = tuple(torch.where(survive, t * rcp_p, t) for t in tp)
    far = torch.full_like(bo[0], 3.0e30)
    cast_o = tuple(torch.where(survive, o + cfg.ray_epsilon * dc, far)
                   for o, dc in zip(bo, bd))
    return bo, bd, tp, col, survive, cast_o, prev_pdf, emission_ok


def _finish_path(cfg, intersect, anyhit, table, sampler, entered, pending,
                 dist, cast_o, bd, tp, col, lights=None, nee=None,
                 prev_pdf=None, emission_ok=None):
    """Intersect the pending cast of iteration 0, run iterations
    1..max_bounces-1, resolve the last segment with the any-hit test and add
    the sky where a path that entered the scene (or missed it from the
    camera) ends on a miss. `nee`, `prev_pdf` and `emission_ok`: the NEE
    state (_scatter_and_roulette). Under fog each segment draws its
    collision right after its cast; on the last segment a collision ends
    the path as a hit does, so the sky needs a miss and no collision before
    the sky shell."""
    fog = cfg.fog_density > 0.0

    def env_add(col, dist, bd, tp):
        if cfg.env_mode == "none":
            return col
        env_ok = entered & (dist == -1.0)
        le = _env_term(cfg, *bd)
        return tuple(torch.where(env_ok, c + t * le, c) for c, t in zip(col, tp))

    def final_dist(dist, survive, cast_o, bd):
        hit_any = anyhit(*cast_o, *bd)
        if fog:
            fmed, _ = _fog_collision(
                cfg, sampler, survive,
                torch.where(hit_any, torch.zeros_like(dist),
                            torch.full_like(dist, -1.0)))
            hit_any = hit_any | fmed
        return torch.where(survive, torch.where(hit_any, torch.ones_like(dist),
                                      torch.full_like(dist, -1.0)), dist)

    def cast(live, dist, cast_o, bd):
        """The next vertex's hit, its distance (t_fog at a collision) and
        the collision lanes (None without fog); dist merged at `live`."""
        new = intersect(*cast_o, *bd)
        if not fog:
            return new, new.t, None, torch.where(live, new.t, dist)
        medium, t_fog = _fog_collision(cfg, sampler, live, new.t)
        cur_t = torch.where(medium, t_fog, new.t)
        return new, cur_t, medium, torch.where(live, cur_t, dist)

    if cfg.max_bounces <= 1:
        return env_add(col, final_dist(dist, pending, cast_o, bd), bd, tp)

    new, cur_t, medium, dist = cast(pending, dist, cast_o, bd)
    bo = cast_o
    for b in range(1, cfg.max_bounces):
        dist, diffuse, col = _resolve_vertex(cfg, dist, bd, new, tp, col, nee,
                                             prev_pdf, emission_ok, medium)
        bo, bd, tp, col, survive, cast_o, prev_pdf, emission_ok = \
            _scatter_and_roulette(
                cfg, table, sampler, bo, bd, cur_t, (new.nx, new.ny, new.nz),
                new.index, diffuse, tp, col, intersect, lights, b, nee,
                prev_pdf, emission_ok, medium)
        dist = torch.where(diffuse & ~survive, torch.full_like(dist, -2.0), dist)
        if b + 1 == cfg.max_bounces:
            dist = final_dist(dist, survive, cast_o, bd)
        else:
            new, cur_t, medium, dist = cast(survive, dist, cast_o, bd)
            # As in the JAX package, the next vertex is placed from `bo`
            # (this vertex, returned by the scatter), not from the cast
            # origin; only iteration 1 measures from the cast origin.
    return env_add(col, dist, bd, tp)


def _nee_state(shape, dtype, device):
    """The NEE planes of a path's start: prev_pdf 1 (primaries are not
    sampled) and emission_ok 1."""
    return (torch.ones(shape, dtype=dtype, device=device),
            torch.ones(shape, dtype=torch.int32, device=device))


def trace_path(cfg, intersect: IntersectFn, anyhit: AnyHitFn,
               table: torch.Tensor, sampler, ox, oy, oz, dx, dy, dz,
               lights=None, nee=None):
    """Trace one sample per lane; returns (r, g, b).

    Radiance is added when a lane resolves: emissive hits when they
    terminate, NEE and the explicit lights at diffuse vertices, the sky at
    the single environment site in _finish_path, which covers primary
    misses too (their direction and throughput never change). `table` is
    the scene's per-object table (_scatter_and_roulette); `nee` the
    scene's ops/nee.LightSampler with cfg.nee, else None. Under fog the
    draws of a sample go: the jitter (the caller's), then per segment its
    collision draw1 right after its cast, before the vertex's own draws.
    """
    hit = intersect(ox, oy, oz, dx, dy, dz)
    shape = dx.shape
    o = tuple(torch.broadcast_to(v, shape) for v in (ox, oy, oz))
    cur_t, medium = hit.t, None
    p_active = hit.t >= 0.0
    p_miss = hit.t == -1.0
    if cfg.fog_density > 0.0:
        # Every lane draws its primary collision, a primary miss too; a
        # collision makes the vertex a fog vertex, and a miss keeps its sky
        # only without one.
        if _FOG_COUNTS is not None:
            _FOG_COUNTS["lanes"] = torch.zeros(shape, dtype=torch.bool,
                                               device=dx.device)
        everyone = torch.ones(shape, dtype=torch.bool, device=dx.device)
        medium, t_fog = _fog_collision(cfg, sampler, everyone, hit.t)
        cur_t = torch.where(medium, t_fog, hit.t)
        p_active = p_active & ~medium
        p_miss = p_miss & ~medium
    p_emissive = p_active & (hit.index % cfg.emissive_every == 0)
    p_diffuse = p_active & ~p_emissive
    if medium is not None:
        p_diffuse = p_diffuse | medium
    zero = torch.zeros(shape, dtype=dx.dtype, device=dx.device)
    base = torch.where(p_emissive, _emit_term(cfg, hit.emis_r2), zero)
    col = (base, base, base)
    dist = torch.where(p_emissive, torch.full_like(zero, -2.0), hit.t)
    ones = torch.ones_like(zero)
    _, bd, tp, col, survive, cast_o, prev_pdf, emission_ok = \
        _scatter_and_roulette(
            cfg, table, sampler, o, (dx, dy, dz), cur_t,
            (hit.nx, hit.ny, hit.nz), hit.index, p_diffuse,
            (ones, ones, ones), col, intersect, lights, 0, nee,
            *_nee_state(shape, dx.dtype, dx.device), medium)
    dist = torch.where(p_diffuse & ~survive, torch.full_like(dist, -2.0), dist)
    col = _finish_path(cfg, intersect, anyhit, table, sampler,
                       p_diffuse | p_miss, survive, dist, cast_o, bd, tp,
                       col, lights, nee, prev_pdf, emission_ok)
    if medium is not None and _FOG_COUNTS is not None:
        _FOG_COUNTS["samples"] += medium.numel()
        _FOG_COUNTS["collided"] += int(_FOG_COUNTS.pop("lanes").sum())
    return col


# The wavefront split (ops/kernels/wavefront.py): the same path integral as
# trace_path, cut after the first vertex. Pass A runs trace_wavefront_primary
# over every lane, pass B trace_wavefront_continue over the compacted
# survivors. Both are built from the helpers trace_path uses, and pass B's
# sampler resumes where pass A's stopped, so the image is trace_path's.

# Lanes without a continuation ray have their cast origin parked at 3e30
# (_scatter_and_roulette); a lane is alive iff cast_ox < this threshold.
WAVEFRONT_FAR_THRESHOLD = 1.0e30


def trace_wavefront_primary(cfg, intersect: IntersectFn, table, sampler,
                            ox, oy, oz, dx, dy, dz, nee=None):
    """Pass A: primary cast, first-vertex resolve (emissive hit, primary
    miss sky), b=0 scatter with its NEE (`nee`, the scene's ops/nee.
    LightSampler with cfg.nee) and Russian roulette.

    Returns (col_r, col_g, col_b, cast_ox, cast_oy, cast_oz, bdx, bdy, bdz,
    tp_r, tp_g, tp_b), and prev_pdf last under NEE with MIS: the partial
    radiance and the continuation ray, whose sampled direction's pdf MIS
    weighs at the next vertex. The split takes no explicit lights, as in
    the JAX package."""
    hit = intersect(ox, oy, oz, dx, dy, dz)
    shape = dx.shape
    o = tuple(torch.broadcast_to(v, shape) for v in (ox, oy, oz))
    p_active = hit.t >= 0.0
    p_emissive = p_active & (hit.index % cfg.emissive_every == 0)
    p_diffuse = p_active & ~p_emissive
    zero = torch.zeros(shape, dtype=dx.dtype, device=dx.device)
    base = torch.where(p_emissive, _emit_term(cfg, hit.emis_r2), zero)
    if cfg.env_mode != "none":
        base = base + torch.where(hit.t == -1.0, _env_term(cfg, dx, dy, dz),
                                  zero)
    ones = torch.ones_like(zero)
    _, bd, tp, col, _, cast_o, prev_pdf, _ = _scatter_and_roulette(
        cfg, table, sampler, o, (dx, dy, dz), hit.t,
        (hit.nx, hit.ny, hit.nz), hit.index, p_diffuse, (ones, ones, ones),
        (base, base, base), intersect, None, 0, nee,
        *_nee_state(shape, dx.dtype, dx.device))
    pdf = (prev_pdf,) if nee is not None and cfg.mis else ()
    return (*col, *cast_o, *bd, *tp, *pdf)


def trace_wavefront_continue(cfg, intersect: IntersectFn, anyhit: AnyHitFn,
                             table, sampler, cast_ox, cast_oy, cast_oz,
                             bdx, bdy, bdz, tp_r, tp_g, tp_b, prev_pdf=None,
                             nee=None, col=None):
    """Pass B: finish the paths of compacted survivors from their pending
    cast (and, under NEE with MIS, the pdf `prev_pdf` of its direction).
    Every lane is taken as alive (padding lanes compute values the caller
    masks out). Under NEE without MIS every lane left a vertex that did
    NEE, so the emission its BSDF rays find is dropped. Returns the
    radiance (r, g, b) the paths add to `col` (3 lane tensors; zeros by
    default: the bounce contribution alone, which the caller adds to pass
    A's partial radiance)."""
    zeros = torch.zeros_like(bdx)
    everyone = torch.ones(bdx.shape, dtype=torch.bool, device=bdx.device)
    if prev_pdf is None:
        prev_pdf = torch.ones_like(bdx)
    emission_ok = torch.full(bdx.shape, 0 if nee is not None and not cfg.mis
                             else 1, dtype=torch.int32, device=bdx.device)
    return _finish_path(cfg, intersect, anyhit, table, sampler, everyone,
                        everyone, zeros, (cast_ox, cast_oy, cast_oz),
                        (bdx, bdy, bdz), (tp_r, tp_g, tp_b),
                        (zeros, zeros, zeros) if col is None else tuple(col),
                        None, nee, prev_pdf, emission_ok)


@functools.cache
def wavefront_draw_position(cfg) -> tuple[int, bool]:
    """(next_pair, has_spare) of the counter-based stream (threefry or
    Philox, which address pairs alike) after pass A: the resume point of
    pass B (`resumed`). Read off a sampler with the config's draw budget
    that ran pass A, NEE included, on a one-lane dummy after the pixel
    jitter; the lockstep draw pattern depends on the material mode and
    NEE, not on the scene or the data (the jitter is pair 0, the
    hemisphere pair 1):
      * procedural: the RR draw1 takes pair 2's first word and leaves its
        second: (3, True); with NEE the light pick takes pair 2's first
        word, the point pair 3 and the RR draw pair 2's second: (4, False);
      * microfacet and disney: the lobe takes pair 2's first word, the RR
        draw its second: (3, False); with NEE the lobe and the light pick
        take pair 2, the point pair 3, and the RR draw pair 4's first
        word, leaving its second pending across the split: (5, True)."""
    from l2n_tpu_torch.ops.nee import LightSampler
    from l2n_tpu_torch.rng.sampler import ThreefrySampler, config_max_pairs

    # Philox (rng="tpu_hw") has the same pair addressing and resume point.

    one = torch.ones((1,), dtype=torch.float32)
    idx = torch.zeros((1,), dtype=torch.int64)

    def miss(ox, oy, oz, dx, dy, dz) -> Hit:
        return Hit(t=-one, nx=one, ny=one, nz=one, index=idx - 1, emis_r2=one)

    sampler = ThreefrySampler(0, 0, idx, idx, config_max_pairs(cfg))
    sampler.draw2()  # the pixel jitter, drawn by the caller
    nee = (LightSampler("area", torch.ones((4, 1)), cfg.emissive_every)
           if cfg.nee else None)
    trace_wavefront_primary(cfg, miss, torch.ones((1, 9)), sampler,
                            one, one, one, one, one, one, nee)
    return sampler.draw_position


def _magenta_on_miss(h: Hit, r, g):
    """(r, g, 0) where the primary ray hits, magenta (1, 0, 1) on a miss;
    None channels (spheres carry no texcoords or barycentrics) read 0."""
    m = h.t >= 0.0
    zero = torch.zeros_like(h.t)
    one = torch.ones_like(h.t)
    r = zero if r is None else r
    g = zero if g is None else g
    return torch.where(m, r, one), torch.where(m, g, zero), torch.where(m, zero, one)


def aov_normal(cfg, intersect: IntersectFn, table, ox, oy, oz, dx, dy, dz,
               miss=(0.0, 0.0, 0.0)):
    """Shading normal of the primary hit, or the scene family's miss colour
    (spheres black, meshes magenta: ops/scenes.py). With normal_map > 0 the
    bumped normal at o + t d (the table's bump channel)."""
    h = intersect(ox, oy, oz, dx, dy, dz)
    m = h.t >= 0.0
    n = (h.nx, h.ny, h.nz)
    if cfg.normal_map > 0.0:
        p = tuple(o + h.t * d for o, d in zip((ox, oy, oz), (dx, dy, dz)))
        n = perturb_normal(cfg, table[h.index.clamp(min=0), 8], p, n)
    return tuple(torch.where(m, nc, torch.full_like(nc, c))
                 for nc, c in zip(n, miss))


def aov_hit(intersect: IntersectFn, ox, oy, oz, dx, dy, dz):
    """1 where the primary ray hits, else 0."""
    h = intersect(ox, oy, oz, dx, dy, dz)
    v = (h.t >= 0.0).to(h.t.dtype)
    return v, v, v


def aov_ambient_occlusion(cfg, intersect: IntersectFn, sampler, ox, oy, oz,
                          dx, dy, dz):
    """One-bounce white-sky AO: a cosine sample of the hemisphere around the
    primary hit's normal (the exact frame, fast_math or not), cast from the
    hit plus ray_epsilon along it with the nearest-hit sweep; white where
    that cast misses. Only hit lanes draw."""
    h = intersect(ox, oy, oz, dx, dy, dz)
    active = h.t >= 0.0
    n = (h.nx, h.ny, h.nz)
    tangent, bitangent = frame_z(*n)
    u1, u2 = sampler.draw2(mask=active)
    (lx, ly, lz), _ = cosine_sample_hemisphere(u1, u2)
    w = local_to_world(lx, ly, lz, tangent, bitangent, n)
    s = tuple(o + h.t * d + cfg.ray_epsilon * wi
              for o, d, wi in zip((ox, oy, oz), (dx, dy, dz), w))
    h2 = intersect(*s, *w)
    v = (active & (h2.t < 0.0)).to(h.t.dtype)
    return v, v, v


def aov_tex_coords(intersect: IntersectFn, ox, oy, oz, dx, dy, dz):
    """Interpolated texcoords of the primary hit; magenta on a miss."""
    h = intersect(ox, oy, oz, dx, dy, dz)
    return _magenta_on_miss(h, h.tc_u, h.tc_v)


def aov_param_uv(intersect: IntersectFn, ox, oy, oz, dx, dy, dz):
    """Barycentric (u, v) of the primary hit; magenta on a miss."""
    h = intersect(ox, oy, oz, dx, dy, dz)
    return _magenta_on_miss(h, h.b_u, h.b_v)


def shade(cfg, intersect: IntersectFn, anyhit: AnyHitFn, table, sampler,
          ox, oy, oz, dx, dy, dz, miss_color=(0.0, 0.0, 0.0), lights=None,
          nee=None):
    """Dispatch on cfg.aov: the path tracer, or a primary-only AOV;
    `miss_color` is the normal AOV's colour of a miss, `lights` the
    path tracer's explicit lights (ops/lights.ExplicitLights, or None),
    `nee` its light sampler (ops/nee.LightSampler, or None)."""
    if cfg.aov == "pathtracing":
        return trace_path(cfg, intersect, anyhit, table, sampler,
                          ox, oy, oz, dx, dy, dz, lights, nee)
    if cfg.aov == "normal":
        return aov_normal(cfg, intersect, table, ox, oy, oz, dx, dy, dz,
                          miss_color)
    if cfg.aov == "hit":
        return aov_hit(intersect, ox, oy, oz, dx, dy, dz)
    if cfg.aov == "ambient_occlusion":
        return aov_ambient_occlusion(cfg, intersect, sampler,
                                     ox, oy, oz, dx, dy, dz)
    if cfg.aov == "tex_coords":
        return aov_tex_coords(intersect, ox, oy, oz, dx, dy, dz)
    if cfg.aov == "param_uv":
        return aov_param_uv(intersect, ox, oy, oz, dx, dy, dz)
    raise ValueError(f"unknown aov {cfg.aov!r}")
