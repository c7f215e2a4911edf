"""Host packing of a triangle scene into the bound hierarchy the triangle
kernel walks (counterpart of the packing half of
l2n_tpu/ops/kernels/triangle_pt.py: `_spatial_order`, `_bsphere`,
`pack_mesh_blocks`, `pack_slab_groups`).

Triangles are spatially sorted per mesh (recursive median split) and cut
into fixed 128-triangle SLABS, each split into 8 SUB-clusters of 16; every
mesh, slab and sub-cluster gets a bounding sphere. The arrays are
byte-equal to the JAX package's (same numpy operations in the same order).
The JAX packer also builds certain-hit data for its TPU walk (`inner_gap`,
interior balls, watertightness, sphere-normal detection); the Hopper
kernel does not use those shortcuts, and ROADMAP lists them as still to
port. The packer's disk cache is not ported either: packing the default
32,768-triangle scene takes well under a second here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SLAB = 128   # triangles per slab
SUBS = 8     # sub-clusters per slab
SUBSIZE = SLAB // SUBS
N_ROWS = 24  # rows of a mesh block (see pack_mesh_blocks)

# Block rows, per triangle slot: geometry, then the normals and texcoords
# in the JAX package's affine form (base + per-barycentric deltas).
ROWS = (
    "v1x", "v1y", "v1z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z",
    "nax", "nay", "naz", "dnbx", "dnby", "dnbz", "dncx", "dncy", "dncz",
    "tau", "tav", "dtbu", "dtbv", "dtcu", "dtcv",
)


def _spatial_order(cents: np.ndarray) -> np.ndarray:
    """Spatial sort of triangle centroids: recursive median split along
    the longest axis, split points snapped to slab (then sub-cluster)
    multiples so fixed-size consecutive runs stay spatially compact."""
    def rec(order):
        n = len(order)
        if n <= SUBSIZE:
            return [order]
        axis = int(np.argmax(cents[order].max(0) - cents[order].min(0)))
        srt = order[np.argsort(cents[order][:, axis], kind="stable")]
        q = SLAB if n > 2 * SLAB else SUBSIZE
        half = min(max(q, ((n // 2 + q // 2) // q) * q), n - 1)
        return rec(srt[:half]) + rec(srt[half:])
    if len(cents) == 0:
        return np.arange(0)
    return np.concatenate(rec(np.arange(len(cents))))


def _bsphere(pts: np.ndarray) -> tuple[np.ndarray, float]:
    """Bounding sphere (AABB center, max squared distance grown by 1e-5)."""
    center = 0.5 * (pts.min(0) + pts.max(0))
    r2 = float(((pts - center) ** 2).sum(1).max()) * (1.0 + 1e-5)
    return center, r2


@dataclasses.dataclass(frozen=True)
class MeshBlocks:
    """The packed scene (M meshes, S = tpad // SLAB slabs per mesh).

    blocks       (M, 24, tpad) f32: ROWS per triangle slot, padding zeros
                 (degenerate, so Möller-Trumbore rejects them);
    bounds       (M, 4) f32 [cx cy cz r^2] per mesh;
    slab_bounds  (M, S, 5) f32 [cx cy cz r^2 r]; empty slabs r^2 = -1e30;
    sub_bounds   (M, S, SUBS, 5) f32, the same per sub-cluster;
    slab_count   (M,) i32 live slabs per mesh;
    slot_index   (M, tpad) i32: the soup index of the triangle in each slot
                 (the `rows_sel` permutation), -1 for padding.
    """

    blocks: np.ndarray
    bounds: np.ndarray
    slab_bounds: np.ndarray
    sub_bounds: np.ndarray
    slab_count: np.ndarray
    slot_index: np.ndarray

    @property
    def tpad(self) -> int:
        return self.blocks.shape[2]


def pack_mesh_blocks(scene) -> MeshBlocks:
    """Pack `scene`'s soup (a TriangleScene) into per-mesh slab blocks and
    bounding spheres; the fields of the JAX package's pack_mesh_blocks
    that the Hopper kernel reads, plus each slot's soup index."""
    soup = scene.soup()
    mesh_id = soup["mesh_id"]
    m_count = int(scene.mesh_count)
    counts = np.bincount(mesh_id, minlength=m_count)
    tpad = max(SLAB, int(-(-counts.max() // SLAB) * SLAB))

    for a in "xyz":
        soup[f"dnb{a}"] = soup[f"nb{a}"] - soup[f"na{a}"]
        soup[f"dnc{a}"] = soup[f"nc{a}"] - soup[f"na{a}"]
    for a in "uv":
        soup[f"dtb{a}"] = soup[f"tb{a}"] - soup[f"ta{a}"]
        soup[f"dtc{a}"] = soup[f"tc{a}"] - soup[f"ta{a}"]
    blocks = np.zeros((m_count, N_ROWS, tpad), np.float32)
    bounds = np.zeros((m_count, 4), np.float32)
    n_slabs = tpad // SLAB
    slab_bounds = np.zeros((m_count, n_slabs, 5), np.float32)
    slab_bounds[:, :, 3] = -1e30
    sub_bounds = np.zeros((m_count, n_slabs, SUBS, 5), np.float32)
    sub_bounds[:, :, :, 3] = -1e30
    slab_count = np.zeros((m_count,), np.int32)
    slot_index = np.full((m_count, tpad), -1, np.int32)

    for m in range(m_count):
        sel = np.flatnonzero(mesh_id == m)
        n = len(sel)
        v1 = np.stack([soup[f"v1{a}"][sel] for a in "xyz"], 1)
        v2 = v1 + np.stack([soup[f"e1{a}"][sel] for a in "xyz"], 1)
        v3 = v1 + np.stack([soup[f"e2{a}"][sel] for a in "xyz"], 1)
        cents = (v1 + v2 + v3) / 3.0
        order = _spatial_order(cents)
        rows_sel = sel[order]
        slot_index[m, :n] = rows_sel
        for r, key in enumerate(ROWS):
            blocks[m, r, :n] = soup[key][rows_sel]
        tri_pts = np.stack([v1[order], v2[order], v3[order]], 1)  # (n, 3, 3)
        slab_count[m] = -(-n // SLAB)
        for s in range(int(slab_count[m])):
            g = tri_pts[s * SLAB:(s + 1) * SLAB]
            center, r2 = _bsphere(g.reshape(-1, 3))
            slab_bounds[m, s] = [*center, r2, float(np.sqrt(r2))]
            for c in range(SUBS):
                gg = g[c * SUBSIZE:(c + 1) * SUBSIZE]
                if len(gg) == 0:
                    continue
                center, r2 = _bsphere(gg.reshape(-1, 3))
                sub_bounds[m, s, c] = [*center, r2, float(np.sqrt(r2))]
        if n:
            center, r2 = _bsphere(tri_pts.reshape(-1, 3))
            bounds[m] = [*center, r2]
    return MeshBlocks(blocks, bounds, slab_bounds, sub_bounds, slab_count,
                      slot_index)


def pack_slab_groups(slab_np: np.ndarray, scount_np: np.ndarray,
                     gsub: int) -> tuple[np.ndarray, np.ndarray]:
    """Bounding spheres over runs of `gsub` consecutive slabs (a second
    bound level for huge meshes). Returns (group_bounds (M, G, 5)
    [cx cy cz r^2 r], group_count (M,) i32); empty groups get r^2 = -1e30.
    Conservative: group radius = max over member slabs of
    |slab_center - group_center| + slab_radius, grown by 1e-5. The Hopper
    kernel does not walk this level yet (ROADMAP Queue 1 #8)."""
    m_count, n_slabs, _ = slab_np.shape
    g_max = max(1, -(-n_slabs // gsub))
    out = np.zeros((m_count, g_max, 5), np.float32)
    out[:, :, 3] = -1e30
    gcnt = np.zeros((m_count,), np.int32)
    for m in range(m_count):
        sc = int(scount_np[m])
        gcnt[m] = -(-sc // gsub) if sc else 0
        for g in range(int(gcnt[m])):
            sl = slab_np[m, g * gsub:min((g + 1) * gsub, sc)]
            live = sl[:, 3] > 0.0
            if not live.any():
                continue
            c, r = sl[live, :3], sl[live, 4]
            lo = (c - r[:, None]).min(0)
            hi = (c + r[:, None]).max(0)
            gc = 0.5 * (lo + hi)
            gr = float((np.sqrt(((c - gc) ** 2).sum(1)) + r).max())
            gr *= 1.0 + 1e-5
            out[m, g] = [*gc, gr * gr, gr]
    return out, gcnt
