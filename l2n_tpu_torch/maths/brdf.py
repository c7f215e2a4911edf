"""The material modes' BSDFs in structure-of-arrays torch (counterpart of
l2n_tpu.maths.brdf).

"microfacet": a Smith-GGX specular lobe with Schlick Fresnel (F0 = 0.04)
over a Lambertian base, sampled as an equal-weight cosine/GGX mixture.
"disney": the Disney-lite BSDF, Burley diffuse with a subsurface blend,
sheen and a GGX lobe with coloured Fresnel (F0 = lerp(0.08 specular,
base, metallic)), sampled as a metallic-weighted cosine/GGX mixture. Both
return w = f cos / pdf for the throughput and the mixture pdf.

Every function performs the JAX package's float32 operations in its
order: square roots through maths.sampling.sqrt (correctly rounded, as
XLA's and the card's), divisions by tensors (torch rounds `scalar /
tensor` twice), normalizes exact (the material modes never take the
fast-math forms). The kernels' twin is csrc/brdf.cuh.

The per-object parameters come from the reference's fract(sin) hash
family. The hash magnifies sin's last ulp, so the renderer evaluates the
`procedural_*` functions once per scene into a table
(scene/materials.py::material_table) and the kernels and the plain path
read that table; nothing here is evaluated per lane.
"""

from __future__ import annotations

import torch

from l2n_tpu_torch.maths.sampling import (
    PI,
    cosine_sample_hemisphere,
    dot3,
    local_to_world,
    normalize3,
    sqrt,
)

F0_DIELECTRIC = 0.04


def _hash(index: torch.Tensor, k: float) -> torch.Tensor:
    """fract(sin((index + 1) * k) * 43758.5453) in float32."""
    v = torch.sin((index + 1).to(torch.float32) * k) * 43758.5453
    return v - torch.floor(v)


def procedural_roughness(index: torch.Tensor) -> torch.Tensor:
    """Per-object roughness in [0.08, 1.0]."""
    return 0.08 + 0.92 * _hash(index, 39.425)


def procedural_disney_params(index: torch.Tensor):
    """Per-object (metallic, specular, sheen, subsurface): metallic is
    min((raw - 0.75) * 8, 1) above raw = 0.75, else 0; subsurface
    max((raw - 0.5) * 2, 0)."""
    raw_metal = _hash(index, 57.731)
    metallic = torch.where(raw_metal > 0.75,
                           torch.clamp((raw_metal - 0.75) * 8.0, max=1.0),
                           torch.zeros_like(raw_metal))
    specular = _hash(index, 23.147)
    sheen = _hash(index, 11.519)
    subsurface = torch.clamp((_hash(index, 31.337) - 0.5) * 2.0, min=0.0)
    return metallic, specular, sheen, subsurface


def _d_ggx(n_h, alpha2):
    d = n_h * n_h * (alpha2 - 1.0) + 1.0
    return alpha2 / torch.clamp(PI * d * d, min=1e-12)


def _g_smith(n_v, n_l, alpha2):
    """Smith height-correlated visibility, the G / (4 n.v n.l) form."""
    gv = n_l * sqrt(n_v * n_v * (1.0 - alpha2) + alpha2)
    gl = n_v * sqrt(n_l * n_l * (1.0 - alpha2) + alpha2)
    s = torch.clamp(gv + gl, min=1e-12)
    return torch.full_like(s, 0.5) / s


def _schlick5(x):
    one_m = torch.clamp(1.0 - x, min=0.0)
    m2 = one_m * one_m
    return m2 * m2 * one_m


def _fresnel(v_h):
    return F0_DIELECTRIC + (1.0 - F0_DIELECTRIC) * _schlick5(v_h)


def _half_terms(n, wo, wi):
    """(n_v, n_l, n_h, v_h) of the half vector normalize(wo + wi)."""
    n_v = torch.clamp(dot3(*n, *wo), min=1e-6)
    n_l = torch.clamp(dot3(*n, *wi), min=0.0)
    h = normalize3(wo[0] + wi[0], wo[1] + wi[1], wo[2] + wi[2])
    n_h = torch.clamp(dot3(*n, *h), min=0.0)
    v_h = torch.clamp(dot3(*wo, *h), min=1e-6)
    return n_v, n_l, n_h, v_h


def _above(n_l, f, pdf):
    """Below-horizon directions carry nothing."""
    ok = n_l > 0.0
    zero = torch.zeros_like(n_l)
    return (*(torch.where(ok, c, zero) for c in f), torch.where(ok, pdf, zero))


def eval_brdf(n, wo, wi, kd, roughness):
    """(f_r, f_g, f_b, pdf) of the microfacet mixture; n unit, wo toward
    the viewer, wi toward the light, each a 3-tuple of components."""
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    n_v, n_l, n_h, v_h = _half_terms(n, wo, wi)
    d = _d_ggx(n_h, alpha2)
    vis = _g_smith(n_v, n_l, alpha2)
    fr = _fresnel(v_h)
    spec = d * vis * fr
    kdiff = (1.0 / PI) * (1.0 - fr)
    f = tuple(k * kdiff + spec for k in kd)
    pdf_cos = n_l * (1.0 / PI)
    pdf_ggx = d * n_h / torch.clamp(4.0 * v_h, min=1e-6)
    return _above(n_l, f, 0.5 * (pdf_cos + pdf_ggx))


def eval_disney(n, wo, wi, base, roughness, metallic, specular, sheen,
                subsurface):
    """(f_r, f_g, f_b, pdf) of the Disney-lite BSDF; the pdf is the
    metallic-weighted mixture's."""
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    n_v, n_l, n_h, v_h = _half_terms(n, wo, wi)
    d = _d_ggx(n_h, alpha2)
    vis = _g_smith(n_v, n_l, alpha2)
    s5 = _schlick5(v_h)
    f0_d = 0.08 * specular
    dv = d * vis
    spec = tuple(dv * (f0 + (1.0 - f0) * s5)
                 for f0 in (f0_d + (b - f0_d) * metallic for b in base))

    sl = _schlick5(n_l)
    sv = _schlick5(n_v)
    fd90 = 0.5 + 2.0 * roughness * v_h * v_h
    fd = (1.0 + (fd90 - 1.0) * sl) * (1.0 + (fd90 - 1.0) * sv)
    fss90 = roughness * v_h * v_h
    fss = (1.0 + (fss90 - 1.0) * sl) * (1.0 + (fss90 - 1.0) * sv)
    ss = 1.25 * (fss * (1.0 / torch.clamp(n_l + n_v, min=1e-6) - 0.5) + 0.5)
    kdiff = (1.0 / PI) * (fd + (ss - fd) * subsurface) * (1.0 - metallic)
    fsheen = sheen * _schlick5(v_h) * (1.0 - metallic)
    f = tuple(b * kdiff + fsheen + s for b, s in zip(base, spec))

    p_spec = 0.25 + 0.5 * metallic
    pdf_cos = n_l * (1.0 / PI)
    pdf_ggx = d * n_h / torch.clamp(4.0 * v_h, min=1e-6)
    return _above(n_l, f, p_spec * pdf_ggx + (1.0 - p_spec) * pdf_cos)


def _mixture_directions(u1, u2, n, frame, wo, alpha2):
    """The cosine lobe's direction and the GGX lobe's reflection of wo
    about its half vector, both unnormalized, from the same (u1, u2)."""
    tangent, bitangent = frame
    (cx, cy, cz), _ = cosine_sample_hemisphere(u1, u2)
    a = local_to_world(cx, cy, cz, tangent, bitangent, n)
    cos_h = sqrt(torch.clamp(
        (1.0 - u1) / torch.clamp(1.0 + (alpha2 - 1.0) * u1, min=1e-12),
        min=0.0))
    sin_h = sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    phi = (2.0 * PI) * u2
    h = local_to_world(sin_h * torch.cos(phi), sin_h * torch.sin(phi), cos_h,
                       tangent, bitangent, n)
    v_h = dot3(*wo, *h)
    b = tuple(2.0 * v_h * hc - w for hc, w in zip(h, wo))
    return a, b


def _weight(n, wi, f, pdf):
    """w = f * n_l / pdf, 0 where pdf is 0."""
    n_l = torch.clamp(dot3(*n, *wi), min=0.0)
    scale = n_l / torch.clamp(pdf, min=1e-12)
    ok = pdf > 0.0
    zero = torch.zeros_like(pdf)
    return tuple(torch.where(ok, c * scale, zero) for c in f)


def sample_brdf(u_lobe, u1, u2, n, frame, wo, kd, roughness):
    """One direction of the 50/50 cosine/GGX mixture: (wi, w, pdf), wi and
    w 3-tuples. `frame` is frame_z(n)'s (tangent, bitangent), exact."""
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    a, b = _mixture_directions(u1, u2, n, frame, wo, alpha2)
    pick = u_lobe < 0.5
    wi = normalize3(*(torch.where(pick, bc, ac) for ac, bc in zip(a, b)))
    *f, pdf = eval_brdf(n, wo, wi, kd, roughness)
    return wi, _weight(n, wi, f, pdf), pdf


def sample_disney(u_lobe, u1, u2, n, frame, wo, base, roughness, metallic,
                  specular, sheen, subsurface):
    """One direction of the metallic-weighted mixture (the GGX lobe with
    probability 0.25 + 0.5 metallic): (wi, w, pdf)."""
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    a, b = _mixture_directions(u1, u2, n, frame, wo, alpha2)
    pick = u_lobe < 0.25 + 0.5 * metallic
    wi = normalize3(*(torch.where(pick, bc, ac) for ac, bc in zip(a, b)))
    *f, pdf = eval_disney(n, wo, wi, base, roughness, metallic, specular,
                          sheen, subsurface)
    return wi, _weight(n, wi, f, pdf), pdf
