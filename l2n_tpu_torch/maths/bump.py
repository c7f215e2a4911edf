"""Procedural normal mapping in torch (counterpart of l2n_tpu.maths.bump).

A world-space sine height field h(p) = (A / f) (sin f px + sin f py +
sin f pz), whose gradient A (cos f px, cos f py, cos f pz) perturbs the
shading normal in its tangent plane: n' = normalize(n - (g - (g.n) n)).
One formula covers spheres and meshes with no UV parametrization. The
per-object amplitude comes from the fract(sin) hash family and, like the
other material channels, is evaluated once per scene into the material
table (scene/materials.py); `perturb_normal` takes it per lane. The
kernels' twin is csrc/brdf.cuh.
"""

from __future__ import annotations

import torch

from l2n_tpu_torch.maths.sampling import dot3, normalize3


def procedural_bump_amplitude(index: torch.Tensor) -> torch.Tensor:
    """Per-object bump amplitude in [0.25, 1.0]."""
    v = torch.sin((index + 1).to(torch.float32) * 91.173) * 43758.5453
    return 0.25 + 0.75 * (v - torch.floor(v))


def perturb_normal(cfg, amplitude, p, n):
    """The unit shading normal at the points p (3-tuple) of the normals n
    (3-tuple, of any length: the sphere path's are not unit), perturbed by
    the bump field of per-lane `amplitude` (the table's bump channel).
    Both normalizes are exact."""
    nx, ny, nz = normalize3(*n)
    amp = cfg.normal_map * amplitude
    freq = cfg.normal_map_freq
    gx, gy, gz = (amp * torch.cos(freq * c) for c in p)
    g_n = dot3(gx, gy, gz, nx, ny, nz)
    return normalize3(nx - (gx - g_n * nx), ny - (gy - g_n * ny),
                      nz - (gz - g_n * nz))
