"""Lat/long sphere tessellation and the indexed triangle scene (counterpart
of l2n_tpu.scene.tessellate).

The indexed scene is the user-facing form: vertices, vertex attributes
(normal + texcoords), indices, per-mesh triangle counts and index offsets,
all host numpy as in the JAX package. Consumers read the flattened SoA
triangle soup (`TriangleScene.soup`), which pre-gathers every corner so the
intersection loop does no index chasing. Every function here performs the
JAX package's numpy operations in the same order, so both packages build
byte-equal scenes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def tessellate_sphere_info(disc_lat: int, disc_long: int) -> tuple[int, int]:
    """(vertex_count, index_count) per sphere: (discLong+1)*(discLat+1)
    vertices, discLong*discLat*6 indices."""
    return (disc_long + 1) * (disc_lat + 1), disc_long * disc_lat * 6


def tessellate_sphere(
    center: np.ndarray, radius: float, disc_lat: int, disc_long: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tessellate one sphere.

    theta in [-pi/2, pi/2] over `disc_long` bands, phi in [0, 2pi] over
    `disc_lat` slices; vertex normal n = (sin(i*dPhi)*cosTheta, sinTheta,
    cos(i*dPhi)*cosTheta); position = center + r*n; texcoords =
    (i/discLat, 1 - j/discLong); two triangles per quad.

    Returns (positions (V,3), normals (V,3), texcoords (V,2), indices (I,)).
    """
    rcp_lat, rcp_long = 1.0 / disc_lat, 1.0 / disc_long
    d_phi, d_theta = 2.0 * np.pi * rcp_lat, np.pi * rcp_long

    j = np.arange(disc_long + 1, dtype=np.float32)
    i = np.arange(disc_lat + 1, dtype=np.float32)
    cos_theta = np.cos(-np.pi * 0.5 + j * d_theta, dtype=np.float32)
    sin_theta = np.sin(-np.pi * 0.5 + j * d_theta, dtype=np.float32)
    # Vertex order: j outer, i inner.
    nx = np.sin(i[None, :] * d_phi, dtype=np.float32) * cos_theta[:, None]
    ny = np.broadcast_to(sin_theta[:, None], nx.shape)
    nz = np.cos(i[None, :] * d_phi, dtype=np.float32) * cos_theta[:, None]
    normals = np.stack([nx, ny, nz], axis=-1).reshape(-1, 3).astype(np.float32)
    positions = np.asarray(center, np.float32)[None, :] + np.float32(radius) * normals
    tex = np.stack(
        np.broadcast_arrays(i[None, :] * rcp_lat, 1.0 - j[:, None] * rcp_long),
        axis=-1,
    ).reshape(-1, 2).astype(np.float32)

    # Per quad (i, j): (i, i+1, i+discLat+2), (i, i+discLat+2, i+discLat+1)
    # offset by j*(discLat+1).
    jj = np.arange(disc_long, dtype=np.int32)
    ii = np.arange(disc_lat, dtype=np.int32)
    offset = (jj[:, None] * (disc_lat + 1) + ii[None, :]).reshape(-1)
    row = disc_lat + 1
    quads = np.stack(
        [offset, offset + 1, offset + row + 1, offset, offset + row + 1, offset + row],
        axis=1,
    )
    return positions, normals, tex, quads.reshape(-1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class TriangleScene:
    """Indexed triangle scene, host numpy SoA per buffer. V vertices, I
    indices, M meshes. Built from any six array-likes (e.g. the JAX
    package's TriangleScene fields, which are numpy), coerced to numpy."""

    vertices: np.ndarray        # (V, 3) f32
    normals: np.ndarray         # (V, 3) f32
    tex_coords: np.ndarray      # (V, 2) f32
    indices: np.ndarray         # (I,)   i32, 3 consecutive per triangle
    triangle_count: np.ndarray  # (M,)   i32, per-mesh triangle counts
    index_offset: np.ndarray    # (M,)   i32, per-mesh offset into `indices`

    def __post_init__(self):
        for field, dtype in (("vertices", np.float32), ("normals", np.float32),
                             ("tex_coords", np.float32), ("indices", np.int32),
                             ("triangle_count", np.int32),
                             ("index_offset", np.int32)):
            object.__setattr__(self, field,
                               np.asarray(getattr(self, field), dtype))

    @property
    def mesh_count(self) -> int:
        return self.triangle_count.shape[0]

    @property
    def total_triangles(self) -> int:
        return self.indices.shape[0] // 3

    def soup(self) -> dict[str, np.ndarray]:
        """The flattened SoA triangle soup: Möller-Trumbore edges e1 = v2-v1,
        e2 = v3-v1 and per-corner attributes gathered per triangle. Keys:
        v1{x,y,z}, e1{x,y,z}, e2{x,y,z}, n{a,b,c}{x,y,z}, t{a,b,c}{u,v},
        mesh_id; each a (T,) array."""
        tri = self.indices.reshape(-1, 3)
        v1 = self.vertices[tri[:, 0]]
        v2 = self.vertices[tri[:, 1]]
        v3 = self.vertices[tri[:, 2]]
        e1, e2 = v2 - v1, v3 - v1
        na, nb, nc = (self.normals[tri[:, k]] for k in range(3))
        ta, tb, tc = (self.tex_coords[tri[:, k]] for k in range(3))
        counts = self.triangle_count
        mesh_id = np.repeat(np.arange(counts.shape[0], dtype=np.int32), counts)
        out = {"mesh_id": mesh_id}
        for name, arr in (("v1", v1), ("e1", e1), ("e2", e2),
                          ("na", na), ("nb", nb), ("nc", nc)):
            for k, ax in enumerate("xyz"):
                out[f"{name}{ax}"] = arr[:, k]
        for name, arr in (("ta", ta), ("tb", tb), ("tc", tc)):
            for k, ax in enumerate("uv"):
                out[f"{name}{ax}"] = arr[:, k]
        return out


def build_triangle_scene(spheres, disc_lat: int = 16,
                         disc_long: int = 8) -> TriangleScene:
    """Tessellate every sphere of `spheres` (a SphereScene of torch tensors)
    into one shared buffer set: per-mesh index offsets are mesh_index *
    index_count, vertex indices are globally offset. Radii are the float32
    sqrt of the float32 squared radii, as in the JAX package."""
    v_count, i_count = tessellate_sphere_info(disc_lat, disc_long)
    host = [t.detach().cpu().numpy() for t in (
        spheres.center_x, spheres.center_y, spheres.center_z,
        spheres.sqr_radius)]
    centers = np.stack(host[:3], axis=1)
    radii = np.sqrt(host[3])
    n = centers.shape[0]

    positions = np.empty((n * v_count, 3), np.float32)
    normals = np.empty((n * v_count, 3), np.float32)
    tex = np.empty((n * v_count, 2), np.float32)
    indices = np.empty(n * i_count, np.int32)
    for m in range(n):
        p, nrm, t, idx = tessellate_sphere(centers[m], radii[m], disc_lat, disc_long)
        positions[m * v_count:(m + 1) * v_count] = p
        normals[m * v_count:(m + 1) * v_count] = nrm
        tex[m * v_count:(m + 1) * v_count] = t
        indices[m * i_count:(m + 1) * i_count] = idx + m * v_count

    return TriangleScene(
        vertices=positions,
        normals=normals,
        tex_coords=tex,
        indices=indices,
        triangle_count=np.full((n,), i_count // 3, np.int32),
        index_offset=np.arange(n, dtype=np.int32) * np.int32(i_count),
    )
