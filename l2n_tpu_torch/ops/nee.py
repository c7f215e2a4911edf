"""Next event estimation (direct light sampling) and balance-heuristic MIS
in structure-of-arrays torch (counterpart of l2n_tpu.ops.nee).

The emissive objects (every `emissive_every`-th index) are tiny, so BSDF
sampling almost never finds them. With `RenderConfig(nee=True)` every
diffuse vertex picks one light uniformly and casts one nearest-hit shadow
ray toward it:

* AREA sampling (spheres): a uniform point on the picked sphere,
    direct = tp f scale E cos cos_L / d^2
  (its area cancels against its radiance scale / (4 pi r^2)); visible iff
  the shadow ray's nearest hit is that sphere.
* CONE sampling (meshes): a direction uniform in the cone of the picked
  mesh's bounding sphere, traced with the full nearest-hit sweep,
    direct = tp f Le cos E Omega,  Le = scale / (4 pi),  Omega = 2 pi (1 -
  cos_max); counted iff the ray hits that mesh.

Without MIS the emission a BSDF ray finds after a vertex that did NEE is
dropped (camera-direct emission is kept). With `mis=True` both strategies
keep their samples, weighted by the balance heuristic p_a / (p_a + p_b)
(`mis_emission_weight` for the BSDF side; the NEE side inside the
contribution functions).

Plain functions on lane tensors, with the JAX package's float32 operations
in its order. The JAX package picks a light with a select-sweep over the E
lights; here the picked light's row is gathered by index, the same floats.
Under fog (fog_density > 0) both contributions take the shadow segment's
Beer-Lambert factor; the fog vertices themselves take no NEE
(ops/pathtrace.py). The kernels' twin is the NEE body and the fog body in
csrc/pathtrace.cuh.
"""

from __future__ import annotations

import dataclasses

import torch

from l2n_tpu_torch.maths.sampling import (
    PI,
    frame_z,
    local_to_world,
    normalize3,
    sqrt,
)


@dataclasses.dataclass
class LightSample:
    px: torch.Tensor  # the sampled point on the light's surface
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor  # the light's surface normal there
    ny: torch.Tensor
    nz: torch.Tensor
    index: torch.Tensor  # scene index of the picked light
    r2: torch.Tensor     # squared radius of the picked light


def emissive_count(count: int, emissive_every: int) -> int:
    """E: the emissive objects among `count` (indices 0, every, 2 every...)."""
    return (count + emissive_every - 1) // emissive_every


class LightSampler:
    """The E lights of a scene: rows (4, count) cx, cy, cz, r^2 of every
    sphere (kind "area") or of every mesh's bounding sphere (kind "cone"),
    of which columns e * emissive_every are the lights."""

    def __init__(self, kind: str, rows: torch.Tensor, emissive_every: int):
        if kind not in ("area", "cone"):
            raise ValueError(f"unknown light sampler kind {kind!r}")
        self.kind = kind
        self.n_lights = emissive_count(rows.shape[1], emissive_every)
        self.index = torch.arange(self.n_lights, device=rows.device) \
            * emissive_every
        self.rows = rows[:4, self.index]

    def pick(self, u_pick):
        """(cx, cy, cz, r2, index) of the light min(int(u_pick E), E - 1)."""
        sel = torch.clamp((u_pick * float(self.n_lights)).to(torch.int32),
                          max=self.n_lights - 1).long()
        cx, cy, cz, r2 = (self.rows[i][sel] for i in range(4))
        return cx, cy, cz, r2, self.index[sel]

    def sample(self, u_pick, u1, u2) -> LightSample:
        """AREA: a uniform point on the picked sphere from (u1, u2)."""
        cx, cy, cz, sr2, idx = self.pick(u_pick)
        r = sqrt(sr2)
        z = 1.0 - 2.0 * u1
        s = sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = (2.0 * PI) * u2
        wx = s * torch.cos(phi)
        wy = s * torch.sin(phi)
        return LightSample(px=cx + r * wx, py=cy + r * wy, pz=cz + r * z,
                           nx=wx, ny=wy, nz=z, index=idx, r2=r * r)


def sphere_light_sampler(cfg, spheres: torch.Tensor) -> LightSampler:
    """AREA sampling over the emissive spheres of the packed (13, n) sphere
    buffer (SphereScene.packed()): centre and r^2 are its first four rows."""
    return LightSampler("area", spheres[:4], cfg.emissive_every)


def mesh_light_sampler(cfg, mesh_bounds: torch.Tensor) -> LightSampler:
    """CONE sampling over the emissive meshes' bounding spheres, the (M, 4)
    packed mesh bounds the triangle kernel walks (TriangleBuffers.
    mesh_bounds, ops/kernels/triangle_pack.py), as the JAX package takes
    pack_mesh_blocks(scene)[1]."""
    return LightSampler("cone", mesh_bounds.T, cfg.emissive_every)


def cone_solid_angle(d2, r2):
    """(Omega, cos_max) = (2 pi (1 - cos_max), cos_max) of a sphere of
    squared radius r2 seen from squared distance d2; the full sphere (cos_max
    = -1, 4 pi) from inside it."""
    inside = d2 <= r2
    cos_max = sqrt(torch.clamp(1.0 - r2 / torch.clamp(d2, min=1e-20),
                               min=0.0))
    cos_max = torch.where(inside, torch.full_like(cos_max, -1.0), cos_max)
    return (2.0 * PI) * (1.0 - cos_max), cos_max


def _bsdf(kd, cos_s, wi, brdf_eval):
    """(f, p_bsdf) for the light direction wi: Lambert's kd / pi and
    cos / pi, or the material mode's eval."""
    if brdf_eval is None:
        return tuple(k * (1.0 / PI) for k in kd), cos_s * (1.0 / PI)
    f_r, f_g, f_b, pdf = brdf_eval(wi)
    return (f_r, f_g, f_b), pdf


def _balance(w, p_nee, p_bsdf):
    return w * p_nee / torch.clamp(p_nee + p_bsdf, min=1e-20)


def nee_cone_contribution(cfg, sampler: LightSampler, intersect, u_pick, u1,
                          u2, h, n, kd, tp, mis: bool = False,
                          brdf_eval=None):
    """Direct light by cone sampling at the vertices h (3-tuple) with
    shading normals n (normalized here), albedo kd and throughput tp before
    the scatter: the drawn direction is cast through `intersect`, the
    scene's full nearest-hit sweep, and counts iff it hits the picked
    mesh. Returns (r, g, b)."""
    hx, hy, hz = h
    cx, cy, cz, r2, light_idx = sampler.pick(u_pick)
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
    eps = cfg.ray_epsilon
    sh = intersect(hx + eps * lx, hy + eps * ly, hz + eps * lz, lx, ly, lz)
    lit = (sh.t >= 0.0) & (sh.index == light_idx)
    nh = normalize3(*n)
    cos_s = torch.clamp(nh[0] * lx + nh[1] * ly + nh[2] * lz, min=0.0)
    f, p_bsdf = _bsdf(kd, cos_s, (lx, ly, lz), brdf_eval)
    # Meshes emit scale / (4 pi), with r^2 = 1 (ops/pathtrace._emit_term).
    le = cfg.emission_scale / (4.0 * PI)
    w = cos_s * le * float(sampler.n_lights) * omega
    if mis:
        p_nee = 1.0 / torch.clamp(float(sampler.n_lights) * omega, min=1e-20)
        w = _balance(w, p_nee, p_bsdf)
    if cfg.fog_density > 0.0:
        # Homogeneous fog: the shadow segment's Beer-Lambert transmittance
        # over the traced distance (shadow rays sample no collisions).
        w = w * torch.exp(-cfg.fog_density * torch.clamp(sh.t, min=0.0))
    w = torch.where(lit, w, torch.zeros_like(w))
    return tuple(t * fc * w for t, fc in zip(tp, f))


def mis_emission_weight(cfg, sampler: LightSampler, prev_pdf, bd, cur_t, n,
                        emis_r2, bound_r2):
    """Balance weight prev_pdf / (prev_pdf + p_nee) of emission that a BSDF
    ray (direction bd, pdf prev_pdf) found at distance cur_t, hit normal n:
    p_nee is the pdf with which NEE would have drawn that direction from the
    previous vertex, over the light's surface (area: d^2 / (4 pi r^2 cos_L
    E)) or over its bound's cone (cone: 1 / (E Omega), the bound's centre
    rebuilt as the hit minus n r)."""
    bdx, bdy, bdz = bd
    nx, ny, nz = n
    e = float(sampler.n_lights)
    if sampler.kind == "area":
        nhx, nhy, nhz = normalize3(nx, ny, nz)
        cos_l = torch.clamp(-(nhx * bdx + nhy * bdy + nhz * bdz), min=0.0)
        d2 = cur_t * cur_t
        area = (4.0 * PI) * torch.clamp(emis_r2, min=1e-20)
        p_nee = d2 / torch.clamp(area * cos_l * e, min=1e-20)
    else:
        r = sqrt(torch.clamp(bound_r2, min=1e-20))
        vx = cur_t * bdx - nx * r
        vy = cur_t * bdy - ny * r
        vz = cur_t * bdz - nz * r
        d2 = vx * vx + vy * vy + vz * vz
        omega, _ = cone_solid_angle(d2, bound_r2)
        p_nee = 1.0 / torch.clamp(e * omega, min=1e-20)
    return prev_pdf / torch.clamp(prev_pdf + p_nee, min=1e-20)


def nee_contribution(cfg, n_lights: int, intersect, light: LightSample, h, n,
                     kd, tp, mis: bool = False, brdf_eval=None):
    """Direct light by area sampling at the vertices h with shading normals
    n (taken as given), albedo kd and throughput tp before the scatter: one
    nearest-hit shadow ray toward the sampled point, visible iff the picked
    light is the first thing hit. Returns (r, g, b)."""
    hx, hy, hz = h
    nx, ny, nz = n
    lx = light.px - hx
    ly = light.py - hy
    lz = light.pz - hz
    d2 = lx * lx + ly * ly + lz * lz
    dist = sqrt(torch.clamp(d2, min=1e-20))
    rcp = 1.0 / dist
    lx, ly, lz = lx * rcp, ly * rcp, lz * rcp
    cos_s = torch.clamp(nx * lx + ny * ly + nz * lz, min=0.0)
    cos_l = torch.clamp(-(light.nx * lx + light.ny * ly + light.nz * lz),
                        min=0.0)
    eps = cfg.ray_epsilon
    sh = intersect(hx + eps * lx, hy + eps * ly, hz + eps * lz, lx, ly, lz)
    visible = sh.index == light.index
    f, p_bsdf = _bsdf(kd, cos_s, (lx, ly, lz), brdf_eval)
    # Le cos cos_L E A / (d^2 A): the light's area cancels (Le = scale / A).
    scale = ((cfg.emission_scale * n_lights) * cos_s * cos_l
             / torch.clamp(d2, min=1e-20))
    if mis:
        area = (4.0 * PI) * torch.clamp(light.r2, min=1e-20)
        p_nee = d2 / torch.clamp(area * cos_l * float(n_lights), min=1e-20)
        scale = _balance(scale, p_nee, p_bsdf)
    if cfg.fog_density > 0.0:
        # Homogeneous fog: Beer-Lambert over the vertex-to-light distance.
        scale = scale * torch.exp(-cfg.fog_density * dist)
    w = torch.where(visible, scale, torch.zeros_like(scale))
    return tuple(t * fc * w for t, fc in zip(tp, f))
