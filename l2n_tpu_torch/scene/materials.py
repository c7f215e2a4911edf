"""Materials and explicit lights as structure-of-arrays containers, and the
per-object material table (counterpart of l2n_tpu.scene.materials).

The reference declares Phong materials, point lights and directional
lights and binds buffers for them that its shading never reads. As in the
JAX package they are live here (ops/lights.py): point and directional
lights add deterministic direct lighting at every diffuse surface vertex,
and `PhongMaterials` diffuse rows override the procedural albedo of the
objects with index < count; the other Phong channels are carried, unread.
Empty containers are the default and render today's image.

The containers are frozen dataclasses of float32 tensors. `carry_across`
turns any object with the JAX containers' field names (their arrays read
as numpy) into the port's.

`material_table` evaluates the procedural material channels of n objects
once on the host (maths/brdf.py, maths/bump.py): the fract(sin) hash
magnifies sin's last ulp, so kernels and plain path read one table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from l2n_tpu_torch.maths.brdf import (
    procedural_disney_params,
    procedural_roughness,
)
from l2n_tpu_torch.maths.bump import procedural_bump_amplitude

# Columns of the material table, after the three albedo columns.
MATERIAL_CHANNELS = ("roughness", "metallic", "specular", "sheen",
                     "subsurface", "bump")


def material_table(n: int) -> torch.Tensor:
    """(n, 6) float32: the procedural MATERIAL_CHANNELS of objects 0..n-1."""
    idx = torch.arange(n)
    metal, spec, sheen, subsurf = procedural_disney_params(idx)
    return torch.stack([procedural_roughness(idx), metal, spec, sheen,
                        subsurf, procedural_bump_amplitude(idx)], dim=1)


def _soa(arr, n_components):
    a = np.asarray(arr, np.float32).reshape(-1, n_components)
    return tuple(torch.from_numpy(a[:, i].copy()) for i in range(n_components))


class _Container:
    """carry_across and count, shared by the three containers."""

    @classmethod
    def carry_across(cls, other):
        """The port's container of the same fields as `other`, a JAX
        package container (or anything with those attributes)."""
        return cls(*(torch.from_numpy(
            np.asarray(getattr(other, f.name), np.float32).reshape(-1).copy())
            for f in dataclasses.fields(cls)))

    @property
    def count(self) -> int:
        return getattr(self, dataclasses.fields(self)[0].name).shape[0]


@dataclasses.dataclass(frozen=True)
class PhongMaterials(_Container):
    """PhongMaterial { vec4 diffuse; vec3 glossy; float shininess; }, SoA."""

    diffuse_r: torch.Tensor
    diffuse_g: torch.Tensor
    diffuse_b: torch.Tensor
    diffuse_a: torch.Tensor
    glossy_r: torch.Tensor
    glossy_g: torch.Tensor
    glossy_b: torch.Tensor
    shininess: torch.Tensor

    @classmethod
    def from_arrays(cls, diffuse, glossy, shininess) -> "PhongMaterials":
        s = torch.from_numpy(np.asarray(shininess, np.float32).reshape(-1)
                             .copy())
        return cls(*_soa(diffuse, 4), *_soa(glossy, 3), s)


@dataclasses.dataclass(frozen=True)
class PointLights(_Container):
    """PointLight { vec3 position; vec3 radiantIntensity; }, SoA."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    intensity_r: torch.Tensor
    intensity_g: torch.Tensor
    intensity_b: torch.Tensor

    @classmethod
    def from_arrays(cls, positions, intensities) -> "PointLights":
        return cls(*_soa(positions, 3), *_soa(intensities, 3))


@dataclasses.dataclass(frozen=True)
class DirectionalLights(_Container):
    """DirectionalLight { vec3 incidentDirection; vec3 emittedRadiance; },
    SoA."""

    dir_x: torch.Tensor
    dir_y: torch.Tensor
    dir_z: torch.Tensor
    radiance_r: torch.Tensor
    radiance_g: torch.Tensor
    radiance_b: torch.Tensor

    @classmethod
    def from_arrays(cls, directions, radiances) -> "DirectionalLights":
        return cls(*_soa(directions, 3), *_soa(radiances, 3))


def empty_lights() -> tuple[PhongMaterials, PointLights, DirectionalLights]:
    """Zero-count containers: the reference's default state."""
    z3 = np.zeros((0, 3), np.float32)
    return (PhongMaterials.from_arrays(np.zeros((0, 4), np.float32), z3,
                                       np.zeros(0, np.float32)),
            PointLights.from_arrays(z3, z3),
            DirectionalLights.from_arrays(z3, z3))
