"""The reference renderer's scenes, regenerated from a configuration in
plain numpy and torch (frozen copy; PROVENANCE.md).

Spheres: `sphere_count` centres uniform in the +-world_size/2 cube and radii
up to 5% of world_size, drawn with numpy's PCG64 from `scene_seed` in the
order (cx, cy, cz, radius). Meshes: each sphere tessellated into disc_lat x
disc_long quads of two triangles (`tessellate_sphere`), flattened into a
triangle soup that the brute-force sweep tests one by one, and each
mesh's bounding sphere (cone NEE's lights; the sweep's off-mesh rule). The
albedo of object i is fract(sin((i + 1) k) * 43758.5453), evaluated once
on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def procedural_albedo(n: int) -> torch.Tensor:
    """(n, 3) float32 albedo rows of objects 0..n-1, computed on the CPU
    (the hash magnifies one-ulp differences of sin between devices)."""
    f = (torch.arange(n) + 1).to(torch.float32)

    def chan(k):
        v = torch.sin(f * k) * 43758.5453
        return v - torch.floor(v)

    return torch.stack([chan(12.9898), chan(78.233), chan(56.128)], dim=1)


def sphere_arrays(sphere_count: int, world_size: float, seed: int):
    """(centres (n, 3), squared radii (n,)) float32 host arrays."""
    gen = np.random.Generator(np.random.PCG64(seed))
    u = gen.random((sphere_count, 4), dtype=np.float32)
    centres = (-0.5 * world_size + world_size * u[:, :3]).astype(np.float32)
    radii = (0.05 * world_size * u[:, 3]).astype(np.float32)
    return centres, (radii * radii).astype(np.float32)


def tessellate_sphere(center, radius, disc_lat: int, disc_long: int):
    """(positions (V, 3), normals (V, 3), indices (I,)) of one lat/long
    sphere: theta in [-pi/2, pi/2] over disc_long bands, phi in [0, 2 pi]
    over disc_lat slices, n = (sin(i dphi) cos theta, sin theta,
    cos(i dphi) cos theta), two triangles per quad."""
    rcp_lat, rcp_long = 1.0 / disc_lat, 1.0 / disc_long
    d_phi, d_theta = 2.0 * np.pi * rcp_lat, np.pi * rcp_long
    j = np.arange(disc_long + 1, dtype=np.float32)
    i = np.arange(disc_lat + 1, dtype=np.float32)
    cos_theta = np.cos(-np.pi * 0.5 + j * d_theta, dtype=np.float32)
    sin_theta = np.sin(-np.pi * 0.5 + j * d_theta, dtype=np.float32)
    nx = np.sin(i[None, :] * d_phi, dtype=np.float32) * cos_theta[:, None]
    ny = np.broadcast_to(sin_theta[:, None], nx.shape)
    nz = np.cos(i[None, :] * d_phi, dtype=np.float32) * cos_theta[:, None]
    normals = np.stack([nx, ny, nz], axis=-1).reshape(-1, 3).astype(np.float32)
    positions = (np.asarray(center, np.float32)[None, :]
                 + np.float32(radius) * normals)
    jj = np.arange(disc_long, dtype=np.int32)
    ii = np.arange(disc_lat, dtype=np.int32)
    offset = (jj[:, None] * (disc_lat + 1) + ii[None, :]).reshape(-1)
    row = disc_lat + 1
    quads = np.stack([offset, offset + 1, offset + row + 1, offset,
                      offset + row + 1, offset + row], axis=1)
    return positions, normals, quads.reshape(-1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class Spheres:
    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    r2: torch.Tensor
    albedo: torch.Tensor  # (n, 3)


@dataclasses.dataclass(frozen=True)
class Soup:
    """(T,) tensors: v1, e1 = v2 - v1, e2 = v3 - v1, the corner normals
    na, nb, nc, and mesh_id (int64); albedo (M, 3) per mesh; bounds (M, 4)
    each mesh's bounding sphere [cx, cy, cz, r^2] (`mesh_bounds`); reach
    (5, T) per triangle its mesh's bound [cx, cy, cz, r, |c|_1]: no hit on
    the triangle lies farther from that centre than r (the sweep's
    off-mesh rule, `tracer._triangle_sweep`, which scales its rounding
    slack by |c|_1)."""

    tri: dict
    albedo: torch.Tensor
    bounds: torch.Tensor
    reach: torch.Tensor

    @property
    def count(self) -> int:
        return self.tri["v1x"].shape[0]


def make_spheres(cfg: dict, device, dtype=torch.float32) -> Spheres:
    centres, r2 = sphere_arrays(cfg["sphere_count"], cfg["world_size"],
                                cfg["scene_seed"])

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, dtype)

    return Spheres(dev(centres[:, 0]), dev(centres[:, 1]), dev(centres[:, 2]),
                   dev(r2), procedural_albedo(len(r2)).to(device, dtype))


def bounding_sphere(pts: np.ndarray) -> tuple[np.ndarray, float]:
    """The bounding sphere of float32 points (N, 3): the centre of their
    box, and the largest squared distance from it grown by 1e-5."""
    center = 0.5 * (pts.min(0) + pts.max(0))
    r2 = float(((pts - center) ** 2).sum(1).max()) * (1.0 + 1e-5)
    return center, r2


def mesh_bounds(arrays: dict, meshes: int) -> np.ndarray:
    """(M, 4) float32 [cx, cy, cz, r^2] of each mesh's bounding sphere over
    its triangles' corners v1, v1 + e1 and v1 + e2 (float32 soup arrays),
    as the port's packer bounds a mesh."""
    bounds = np.zeros((meshes, 4), np.float32)
    for m in range(meshes):
        sel = np.flatnonzero(arrays["mesh_id"] == m)
        if not len(sel):
            continue
        v1 = np.stack([arrays[f"v1{a}"][sel] for a in "xyz"], 1)
        v2 = v1 + np.stack([arrays[f"e1{a}"][sel] for a in "xyz"], 1)
        v3 = v1 + np.stack([arrays[f"e2{a}"][sel] for a in "xyz"], 1)
        center, r2 = bounding_sphere(np.stack([v1, v2, v3], 1).reshape(-1, 3))
        bounds[m] = [*center, r2]
    return bounds


def soup_of(arrays: dict, meshes: int, device, dtype=torch.float32) -> Soup:
    """The Soup of float32 soup arrays (v1, e1, e2 and na, nb, nc by axis,
    `mesh_id`) over `meshes` meshes, with their bounds and reach."""
    out = {}
    for k, v in arrays.items():
        t = torch.as_tensor(np.ascontiguousarray(v)).to(device)
        out[k] = t.to(torch.int64) if k == "mesh_id" else t.to(dtype)
    bounds = torch.as_tensor(mesh_bounds(arrays, meshes)).to(device, dtype)
    per_tri = bounds[out["mesh_id"]].T
    reach = torch.cat([per_tri[:3], per_tri[3:].sqrt(),
                       per_tri[:3].abs().sum(0, keepdim=True)]).contiguous()
    return Soup(out, procedural_albedo(meshes).to(device, dtype), bounds,
                reach)


def make_soup(cfg: dict, device, dtype=torch.float32) -> Soup:
    """The spheres of `cfg` tessellated at (disc_lat, disc_long); radii are
    the float32 sqrt of the float32 squared radii."""
    centres, r2 = sphere_arrays(cfg["sphere_count"], cfg["world_size"],
                                cfg["scene_seed"])
    radii = np.sqrt(r2)
    pos, nrm, idx = [], [], []
    base = 0
    for m in range(len(r2)):
        p, n, i = tessellate_sphere(centres[m], radii[m], cfg["disc_lat"],
                                    cfg["disc_long"])
        pos.append(p)
        nrm.append(n)
        idx.append(i + base)
        base += p.shape[0]
    vertices = np.concatenate(pos)
    normals = np.concatenate(nrm)
    tri = np.concatenate(idx).reshape(-1, 3)
    v1, v2, v3 = (vertices[tri[:, k]] for k in range(3))
    per_mesh = tri.shape[0] // len(r2)
    arrays = {"mesh_id": np.repeat(np.arange(len(r2)), per_mesh)}
    for name, arr in (("v1", v1), ("e1", v2 - v1), ("e2", v3 - v1),
                      ("na", normals[tri[:, 0]]), ("nb", normals[tri[:, 1]]),
                      ("nc", normals[tri[:, 2]])):
        for k, ax in enumerate("xyz"):
            arrays[f"{name}{ax}"] = arr[:, k]
    return soup_of(arrays, len(r2), device, dtype)
