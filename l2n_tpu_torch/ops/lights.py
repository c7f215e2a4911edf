"""Explicit point / directional lights and the Phong albedo override
(counterpart of l2n_tpu.ops.lights).

The lights are Dirac: BSDF sampling never finds them, so they need no MIS
weight and take no sampler draws. At every diffuse surface vertex each
light casts one nearest-hit shadow ray and adds

    point:        f(wi) I cos / d^2        (I the radiant intensity)
    directional:  f(wi) E cos              (wi = -incidentDirection)

times the vertex's throughput before the scatter, f the active BSDF
(kd / pi, or the material mode's eval). A point light is visible when
the shadow ray hits nothing or hits at t >= dist - 2 ray_epsilon; a
directional light when it hits nothing. Under fog (fog_density sigma > 0)
a point light's term takes the Beer-Lambert factor exp(-sigma dist) and a
directional light's exp(-sigma sky) (ops/fog.py
fog_directional_transmittance, computed once on the host).

`PhongMaterials` diffuse rows replace the albedo of objects with index
< count. The JAX package selects them per lane inside the scatter; the
port writes them into the scene's albedo table once on the host
(`ExplicitLights.override_albedo`), the same floats.

`ExplicitLights` keeps host numpy arrays byte-equal to the JAX package's
(the directional rows hold wi = -d / max(|d|, 1e-20), computed as it
computes them); `buffer(device)` is the kernels' copy, the point rows
then the directional rows, six floats each.
"""

from __future__ import annotations

import numpy as np
import torch

from l2n_tpu_torch.maths.sampling import PI, normalize3, sqrt
from l2n_tpu_torch.ops.fog import fog_directional_transmittance


class ExplicitLights:
    """The live material and light data of a program."""

    def __init__(self, materials=None, point_lights=None,
                 directional_lights=None):
        def host(container, names):
            if container is None or container.count == 0:
                return np.zeros((0, len(names)), np.float32)
            return np.stack([np.asarray(getattr(container, n).cpu(),
                                        np.float32) for n in names], axis=1)

        self.albedo = host(materials, ("diffuse_r", "diffuse_g", "diffuse_b"))
        self.point = host(point_lights, ("x", "y", "z", "intensity_r",
                                         "intensity_g", "intensity_b"))
        dl = host(directional_lights, ("dir_x", "dir_y", "dir_z",
                                       "radiance_r", "radiance_g",
                                       "radiance_b"))
        if dl.shape[0]:
            n = np.linalg.norm(dl[:, :3], axis=1, keepdims=True)
            dl = dl.copy()
            dl[:, :3] = -dl[:, :3] / np.maximum(n, 1e-20)
        self.directional = dl
        self._buffers = {}

    @property
    def enabled(self) -> bool:
        """True when anything changes the render."""
        return bool(self.point.shape[0] or self.directional.shape[0]
                    or self.albedo.shape[0])

    @property
    def has_lights(self) -> bool:
        return bool(self.point.shape[0] or self.directional.shape[0])

    def override_albedo(self, albedo: torch.Tensor) -> torch.Tensor:
        """A copy of the (n, 3) albedo table with rows i < count replaced
        by the materials' diffuse rgb (rows past n are ignored)."""
        out = albedo.clone()
        m = min(self.albedo.shape[0], out.shape[0])
        out[:m] = torch.from_numpy(self.albedo[:m]).to(out.device)
        return out

    def buffer(self, device) -> torch.Tensor:
        """(n_point + n_directional, 6) float32 on `device`, made once per
        device: the kernels' light rows."""
        device = torch.device(device)
        if device not in self._buffers:
            rows = np.concatenate([self.point, self.directional]).reshape(
                -1, 6)
            self._buffers[device] = torch.from_numpy(
                np.ascontiguousarray(rows, np.float32)).to(device)
        return self._buffers[device]


def explicit_light_contribution(cfg, lights: ExplicitLights, intersect, h,
                                n, kd, tp, brdf_eval=None):
    """Direct radiance (r, g, b) from every explicit light at the vertices
    h (3-tuple) of shading normals n (normalized here again, as the JAX
    package does), throughput tp before the scatter. `brdf_eval(wi) ->
    (f_r, f_g, f_b, pdf)` replaces Lambert's kd / pi in the material
    modes. Deterministic: no draws."""
    nh = normalize3(*n)
    eps = cfg.ray_epsilon
    zero = torch.zeros_like(torch.broadcast_tensors(h[0], nh[0])[0])
    out = [zero, zero, zero]

    def eval_f(wi):
        if brdf_eval is None:
            return tuple(k * (1.0 / PI) for k in kd)
        return brdf_eval(wi)[:3]

    for px, py, pz, ir, ig, ib in lights.point.tolist():
        lx, ly, lz = (c - hc for c, hc in zip((px, py, pz), h))
        d2 = lx * lx + ly * ly + lz * lz
        dist = sqrt(torch.clamp(d2, min=1e-20))
        rcp = 1.0 / dist
        wi = (lx * rcp, ly * rcp, lz * rcp)
        cos_s = torch.clamp(nh[0] * wi[0] + nh[1] * wi[1] + nh[2] * wi[2],
                            min=0.0)
        sh = intersect(*(hc + eps * w for hc, w in zip(h, wi)), *wi)
        visible = (sh.t < 0.0) | (sh.t >= dist - 2.0 * eps)
        w = cos_s / torch.clamp(d2, min=1e-20)
        if cfg.fog_density > 0.0:
            w = w * torch.exp(-cfg.fog_density * dist)
        w = torch.where(visible, w, zero)
        f = eval_f(wi)
        out = [o + fc * i * w for o, fc, i in zip(out, f, (ir, ig, ib))]

    transmit = fog_directional_transmittance(cfg)
    for wx, wy, wz, er, eg, eb in lights.directional.tolist():
        cos_s = torch.clamp(nh[0] * wx + nh[1] * wy + nh[2] * wz, min=0.0)
        wi = tuple(torch.full_like(zero, c) for c in (wx, wy, wz))
        sh = intersect(*(hc + eps * c for hc, c in zip(h, wi)), *wi)
        if cfg.fog_density > 0.0:
            cos_s = cos_s * transmit
        w = torch.where(sh.t < 0.0, cos_s, zero)
        f = eval_f(wi)
        out = [o + fc * e * w for o, fc, e in zip(out, f, (er, eg, eb))]

    return tuple(t * o for t, o in zip(tp, out))
