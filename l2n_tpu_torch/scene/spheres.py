"""Procedural analytic-sphere scene (counterpart of l2n_tpu.scene.spheres).

128 spheres with centers uniform in the ±worldSize/2 cube and radii up to
5% of worldSize, drawn with the same explicit numpy PCG64 generator as the
JAX package, so both packages build byte-equal scenes. The scene is a
structure of arrays — (cx, cy, cz, sqr_radius) component vectors — plus the
per-sphere albedo and material tables the kernel and the plain path share.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from l2n_tpu_torch.maths.sampling import procedural_color
from l2n_tpu_torch.scene.materials import material_table


@dataclasses.dataclass(frozen=True)
class SphereScene:
    """SoA sphere scene on one device. center_*/sqr_radius: (n,) float32;
    albedo: (n, 3) float32, the procedural albedo of each sphere index, and
    material: (n, 6) float32, its scene/materials.MATERIAL_CHANNELS, both
    evaluated once on the host (see maths.sampling.procedural_color)."""

    center_x: torch.Tensor
    center_y: torch.Tensor
    center_z: torch.Tensor
    sqr_radius: torch.Tensor
    albedo: torch.Tensor
    material: torch.Tensor

    @property
    def count(self) -> int:
        return self.center_x.shape[0]

    @classmethod
    def from_numpy(cls, cx, cy, cz, r2, device="cpu") -> "SphereScene":
        """Build from host arrays (e.g. the JAX package's scene fields)."""
        cols = [torch.as_tensor(np.asarray(a, np.float32).copy())
                for a in (cx, cy, cz, r2)]
        n = cols[0].shape[0]
        albedo = torch.stack(procedural_color(torch.arange(n)), dim=1)
        return cls(*(c.to(device) for c in cols), albedo=albedo.to(device),
                   material=material_table(n).to(device))

    def with_tables(self, albedo=None, material=None) -> "SphereScene":
        """The scene with another (n, 3) albedo or (n, 6) material table
        (host arrays or tensors; e.g. the JAX package's hash values, or an
        albedo with the Phong override applied)."""
        def table(new, old):
            if new is None:
                return old
            new = torch.as_tensor(new, dtype=torch.float32)
            if new.shape != old.shape:
                raise ValueError(f"table shape {tuple(new.shape)}, expected "
                                 f"{tuple(old.shape)}")
            return new.to(old.device)

        return dataclasses.replace(
            self, albedo=table(albedo, self.albedo),
            material=table(material, self.material))

    def packed(self) -> torch.Tensor:
        """(13, n) float32 rows [cx, cy, cz, r2, albedo r, g, b, roughness,
        metallic, specular, sheen, subsurface, bump] — the one buffer the
        sphere kernels stage into shared memory (the rows they read)."""
        return torch.cat([torch.stack([self.center_x, self.center_y,
                                       self.center_z, self.sqr_radius]),
                          self.albedo.T, self.material.T]).contiguous()

    def as_numpy(self) -> np.ndarray:
        """(N, 4) float32 [cx, cy, cz, sqrRadius]."""
        return torch.stack([self.center_x, self.center_y, self.center_z,
                            self.sqr_radius], dim=1).cpu().numpy()


def spheres_disjoint(scene: SphereScene, margin: float = 0.0) -> bool:
    """True iff no two spheres overlap (pairwise center distance exceeds the
    radius sum by at least `margin`). The reference's default scene does not
    qualify (7 overlapping pairs at seed 0)."""
    soa = scene.as_numpy().astype(np.float64)
    c, r = soa[:, :3], np.sqrt(soa[:, 3])
    d = np.sqrt(((c[:, None, :] - c[None, :, :]) ** 2).sum(-1))
    lim = r[:, None] + r[None, :] + margin
    np.fill_diagonal(d, np.inf)
    return bool((d > lim).all())


def compute_spheres(sphere_count: int = 128, world_size: float = 1024.0,
                    seed: int = 0, device="cpu") -> SphereScene:
    """The procedural scene: center ~ U(-worldSize/2, worldSize/2)^3,
    radius ~ U(0, 0.05 * worldSize), drawn per sphere in the order
    (cx, cy, cz, radius)."""
    gen = np.random.Generator(np.random.PCG64(seed))
    u = gen.random((sphere_count, 4), dtype=np.float32)
    centers = (-0.5 * world_size + world_size * u[:, :3]).astype(np.float32)
    radii = (0.05 * world_size * u[:, 3]).astype(np.float32)
    return SphereScene.from_numpy(centers[:, 0], centers[:, 1],
                                  centers[:, 2], radii * radii, device=device)
