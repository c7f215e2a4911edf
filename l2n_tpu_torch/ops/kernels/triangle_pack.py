"""Host packing of a triangle scene into the bound hierarchy the triangle
kernel walks (counterpart of the packing half of
l2n_tpu/ops/kernels/triangle_pt.py: `_spatial_order`, `_bsphere`,
`pack_mesh_blocks`, `pack_slab_groups`).

Triangles are spatially sorted per mesh (recursive median split) and cut
into fixed 128-triangle SLABS, each split into 8 SUB-clusters of 16; every
mesh, slab and sub-cluster gets a bounding sphere. Meshes of more than 8
slabs get a third bound level, a sphere per GROUP of 8 consecutive slabs
(`pack_slab_groups`). Watertight meshes (`_mesh_watertight` on
position-canonicalized vertex ids) get certain-hit data: the inscribed
sphere about the bound centre (`inner_gap`) and up to 8 interior balls
(`_interior_balls`), spheres that a ray from outside cannot cross without
hitting the surface first; the kernel seeds each cast's walk with the
nearest such crossing. Every array is byte-equal to the JAX package's
(same numpy operations in the same order). Not ported: the JAX packer's
sphere-normal detection (its `_sweep_mesh_fast`; the Hopper kernel
interpolates the winner's attributes once per ray instead) and its disk
cache (packing the default 32,768-triangle scene takes about a second,
the 70,144-triangle trefoil about 20 s).
"""

from __future__ import annotations

import dataclasses

import numpy as np

SLAB = 128   # triangles per slab
SUBS = 8     # sub-clusters per slab
SUBSIZE = SLAB // SUBS
GROUP = 8    # slabs per slab group (csrc/triangle_pt.cuh kGroup)
BALLS = 8    # interior certain-hit balls per mesh (kBalls)
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


def _point_tri_dist(p: np.ndarray, a: np.ndarray, b: np.ndarray,
                    c: np.ndarray) -> np.ndarray:
    """Exact point-to-triangle distances, batched: p (C,3) x tris (n,3)
    -> (C,n): the in-face plane distance where the projection falls inside
    the triangle, else the nearest of the three edge segments."""
    def seg(p, a, d):  # p (C,3), a (n,3), d (n,3) -> (C,n)
        ap = p[:, None, :] - a[None, :, :]
        t = np.clip((ap * d).sum(-1)
                    / np.maximum((d * d).sum(-1), 1e-30), 0.0, 1.0)
        q = ap - t[..., None] * d
        return np.sqrt((q * q).sum(-1))

    ab, ac, bc = b - a, c - a, c - b
    n = np.cross(ab, ac)
    nn = np.maximum((n * n).sum(-1), 1e-30)
    ap = p[:, None, :] - a[None, :, :]
    dist_n = (ap * n).sum(-1) / np.sqrt(nn)
    d00 = (ab * ab).sum(-1)
    d01 = (ab * ac).sum(-1)
    d11 = (ac * ac).sum(-1)
    d20 = (ap * ab).sum(-1)
    d21 = (ap * ac).sum(-1)
    denom = np.maximum(d00 * d11 - d01 * d01, 1e-30)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    inside = (v >= 0.0) & (w >= 0.0) & (v + w <= 1.0)
    edge = np.minimum(np.minimum(seg(p, a, ab), seg(p, a, ac)),
                      seg(p, b, bc))
    return np.where(inside, np.abs(dist_n), edge)


def _solid_angle_inside(p: np.ndarray, a: np.ndarray, b: np.ndarray,
                        c: np.ndarray) -> np.ndarray:
    """True per candidate point (C,3) where the summed signed solid angle
    of the closed mesh (tris (n,3) x3) about it is ~4 pi (van Oosterom and
    Strackee's formula): the point lies inside the solid."""
    ra = a[None] - p[:, None]
    rb = b[None] - p[:, None]
    rc = c[None] - p[:, None]
    la = np.linalg.norm(ra, axis=-1)
    lb = np.linalg.norm(rb, axis=-1)
    lc = np.linalg.norm(rc, axis=-1)
    num = (ra * np.cross(rb, rc)).sum(-1)
    den = (la * lb * lc + (ra * rb).sum(-1) * lc
           + (ra * rc).sum(-1) * lb + (rb * rc).sum(-1) * la)
    omega = 2.0 * np.arctan2(num, den)
    area2 = np.linalg.norm(np.cross(rb - ra, rc - ra), axis=-1)
    total = np.where(area2 > 1e-12, omega, 0.0).sum(-1)
    return np.abs(np.abs(total) - 4.0 * np.pi) < 1e-2


def _canonical_vertex_ids(verts: np.ndarray) -> np.ndarray:
    """Vertex ids canonicalized by position: vertices closer than 1e-6 of
    the scene's extent are merged (connected components over
    scipy.spatial.cKDTree's pairs), so the seam and pole duplicates that
    tessellators and OBJ exporters emit, which may differ in the last ulp,
    share an id. Without scipy, only byte-identical positions merge: a
    conservative fallback (a seam then fails the watertight test, and the
    mesh gets no certain-hit data)."""
    pts = np.ascontiguousarray(np.asarray(verts, np.float32))
    n = len(pts)
    if n == 0:
        return np.zeros((0,), np.int64)
    extent = float(pts.max(0).__sub__(pts.min(0)).max()) or 1.0
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        _, canon = np.unique(pts.view([("", np.float32)] * 3).reshape(-1),
                             return_inverse=True)
        return canon
    pairs = cKDTree(pts).query_pairs(1e-6 * extent, output_type="ndarray")
    parent = np.arange(n)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for i, j in pairs:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)
    return np.fromiter((find(i) for i in range(n)), np.int64, n)


def _mesh_watertight(verts: np.ndarray, tris: np.ndarray,
                     canon: np.ndarray | None = None) -> bool:
    """Is the indexed mesh closed: every undirected edge of its live faces
    shared by exactly two faces? On the scene's vertex buffer and face
    indices, with ids canonicalized by `_canonical_vertex_ids` (computed
    once per scene); faces with two corners on one canonical point (pole
    slivers) are dropped first. A mesh with a crack, however small, fails,
    and so gets no certain-hit data."""
    if canon is None:
        canon = _canonical_vertex_ids(verts)
    a, b, c = canon[tris[:, 0]], canon[tris[:, 1]], canon[tris[:, 2]]
    live = (a != b) & (b != c) & (a != c)
    a, b, c = a[live], b[live], c[live]
    if a.size == 0:
        return False
    edges = np.concatenate([np.stack([a, b], 1), np.stack([b, c], 1),
                            np.stack([c, a], 1)], 0)
    edges.sort(axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    return bool((counts == 2).all())


def _interior_balls(v1, v2, v3, sub_centers, sub_radii) -> np.ndarray:
    """Up to BALLS certain-hit balls strictly inside one closed mesh: a ray
    from outside that crosses one hits the surface no later than its entry
    (for meshes whose bound centre lies outside the solid, e.g. a torus).

    Candidates: sub-cluster centroids stepped inward along the mean inward
    normal at three depths (at most 64 seeds); kept if the solid-angle
    test puts them inside, with the exact distance to the nearest triangle
    (shrunk by 1e-3) as radius; chosen largest first, spread apart.
    Returns (BALLS, 4) [cx cy cz r^2], dead entries r^2 = -1, live ones
    first."""
    out = np.full((BALLS, 4), -1.0, np.float32)
    n_geo = np.cross(v2 - v1, v3 - v1)
    ln = np.linalg.norm(n_geo, axis=1, keepdims=True)
    ok = ln[:, 0] > 1e-12
    if not ok.any():
        return out
    # Orient: signed volume > 0 <=> cross(e1, e2) points outward.
    vol6 = float((v1 * np.cross(v2, v3)).sum())
    sign = 1.0 if vol6 > 0.0 else -1.0
    cents = (v1 + v2 + v3) / 3.0
    normals = sign * n_geo / np.maximum(ln, 1e-30)
    if len(sub_centers) > 64:
        stride = -(-len(sub_centers) // 64)
        sub_centers = sub_centers[::stride]
        sub_radii = sub_radii[::stride]
    cand = []
    for sc, sr in zip(sub_centers, sub_radii):
        d2 = ((cents - sc) ** 2).sum(1)
        near = d2 <= max(sr, 1e-6) ** 2 * 4.0
        if not near.any():
            continue
        inward = -normals[near].mean(0)
        nl = np.linalg.norm(inward)
        if nl < 1e-6:
            continue
        inward /= nl
        base = cents[near].mean(0)
        for h in (0.35, 0.7, 1.4):
            cand.append(base + inward * (h * max(sr, 1e-6)))
    if not cand:
        return out
    p = np.asarray(cand, np.float64)
    inside = _solid_angle_inside(p, v1, v2, v3)
    if not inside.any():
        return out
    p = p[inside]
    radii = _point_tri_dist(p, v1, v2, v3).min(-1) * (1.0 - 1e-3)
    good = radii > 1e-6
    p, radii = p[good], radii[good]
    order = np.argsort(-radii)
    chosen: list[int] = []
    for i in order:
        if len(chosen) >= BALLS:
            break
        if all(np.linalg.norm(p[i] - p[j]) > 0.7 * max(radii[i], radii[j])
               for j in chosen):
            chosen.append(int(i))
    for k, i in enumerate(chosen):
        out[k] = [p[i, 0], p[i, 1], p[i, 2], radii[i] * radii[i]]
    return out


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
                 (the `rows_sel` permutation), -1 for padding;
    group_bounds (M, G, 5) f32 [cx cy cz r^2 r] per run of GROUP slabs,
                 G = ceil(S / GROUP), empty groups r^2 = -1e30, and
                 group_count (M,) i32 (pack_slab_groups);
    inner_gap    (M,) f32: r_out^2 - r_in^2 of the inscribed sphere about
                 the bound centre of a watertight mesh that encloses that
                 centre, +3e30 elsewhere (no certain hit);
    balls        (M, BALLS, 4) f32 [cx cy cz r^2]: interior certain-hit
                 balls of watertight meshes whose inscribed sphere is weak
                 (_interior_balls), dead entries r^2 = -1.
    """

    blocks: np.ndarray
    bounds: np.ndarray
    slab_bounds: np.ndarray
    sub_bounds: np.ndarray
    slab_count: np.ndarray
    slot_index: np.ndarray
    group_bounds: np.ndarray
    group_count: np.ndarray
    inner_gap: np.ndarray
    balls: np.ndarray

    @property
    def tpad(self) -> int:
        return self.blocks.shape[2]


def pack_mesh_blocks(scene) -> MeshBlocks:
    """Pack `scene`'s soup (a TriangleScene) into per-mesh slab blocks,
    bounding spheres, slab groups and certain-hit data; the fields of the
    JAX package's pack_mesh_blocks that the Hopper kernel reads, plus each
    slot's soup index."""
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
    group_bounds, group_count = pack_slab_groups(slab_bounds, slab_count,
                                                 GROUP)
    inner_gap, balls = _certain_hits(scene, soup, mesh_id, bounds,
                                     sub_bounds)
    return MeshBlocks(blocks, bounds, slab_bounds, sub_bounds, slab_count,
                      slot_index, group_bounds, group_count, inner_gap,
                      balls)


def _certain_hits(scene, soup, mesh_id, bounds, sub_bounds):
    """(inner_gap (M,), balls (M, BALLS, 4)) of the packed scene; see
    MeshBlocks. Only watertight meshes get them: through a crack an
    inscribed sphere or a ball would promise a hit that is not there."""
    m_count = bounds.shape[0]
    scene_verts = np.asarray(scene.vertices)
    scene_tris = np.asarray(scene.indices).reshape(-1, 3)
    tri_offsets = np.asarray(scene.index_offset) // 3
    tri_counts = np.asarray(scene.triangle_count)
    canon_ids = _canonical_vertex_ids(scene_verts)
    watertight = np.zeros((m_count,), bool)
    for m in range(m_count):
        tris_m = scene_tris[tri_offsets[m]:tri_offsets[m] + tri_counts[m]]
        if len(tris_m):
            watertight[m] = _mesh_watertight(scene_verts, tris_m,
                                             canon=canon_ids)

    # The inscribed sphere about the bound centre c of a mesh closed around
    # c (its triangles' signed solid angles about c sum to 4 pi): radius
    # r_in, the nearest face plane's distance, so that in the kernel
    # c_inner = c_outer + inner_gap.
    inner_gap = np.full((m_count,), 3.0e30, np.float32)
    for m in range(m_count):
        sel = mesh_id == m
        if not sel.any() or not watertight[m]:
            continue
        c = bounds[m, :3]
        a = np.stack([soup[f"v1{ax}"][sel] for ax in "xyz"], 1) - c
        b = a + np.stack([soup[f"e1{ax}"][sel] for ax in "xyz"], 1)
        cc = a + np.stack([soup[f"e2{ax}"][sel] for ax in "xyz"], 1)
        la = np.linalg.norm(a, axis=1)
        lb = np.linalg.norm(b, axis=1)
        lc = np.linalg.norm(cc, axis=1)
        num = np.einsum("ij,ij->i", a, np.cross(b, cc))
        den = (la * lb * lc + np.einsum("ij,ij->i", a, b) * lc
               + np.einsum("ij,ij->i", a, cc) * lb
               + np.einsum("ij,ij->i", b, cc) * la)
        omega = 2.0 * np.arctan2(num, den)
        # Degenerate triangles (pole slivers) subtend nothing but can hit
        # the atan2(0, -x) = pi branch.
        area2 = np.linalg.norm(np.cross(b - a, cc - a), axis=1)
        omega = np.where(area2 > 1e-12, omega, 0.0)
        if abs(abs(float(omega.sum())) - 4.0 * np.pi) > 1e-2:
            continue  # not closed around the centre
        n_geo = np.cross(b - a, cc - a)
        ln = np.linalg.norm(n_geo, axis=1)
        ok = ln > 1e-6 * float(ln.max())  # slivers' planes are noise
        if not ok.any():
            continue
        plane_d = np.abs(np.einsum("ij,ij->i", n_geo[ok], a[ok])) / ln[ok]
        r_in = float(plane_d.min())
        if r_in > 0.0:
            inner_gap[m] = bounds[m, 3] - r_in * r_in

    # Interior balls for the watertight meshes whose inscribed sphere is
    # absent or weak (r_in < 0.5 r_out), e.g. tori.
    balls = np.full((m_count, BALLS, 4), -1.0, np.float32)
    for m in range(m_count):
        if inner_gap[m] < 2e30 and \
                bounds[m, 3] - inner_gap[m] >= 0.25 * bounds[m, 3]:
            continue
        sel = np.flatnonzero(mesh_id == m)
        if len(sel) == 0 or not watertight[m]:
            continue
        v1 = np.stack([soup[f"v1{a}"][sel] for a in "xyz"], 1).astype(
            np.float64)
        v2 = v1 + np.stack([soup[f"e1{a}"][sel] for a in "xyz"], 1)
        v3 = v1 + np.stack([soup[f"e2{a}"][sel] for a in "xyz"], 1)
        live = sub_bounds[m, :, :, 3].reshape(-1) > 0
        sub_c = sub_bounds[m].reshape(-1, 5)[live, :3].astype(np.float64)
        sub_r = sub_bounds[m].reshape(-1, 5)[live, 4].astype(np.float64)
        balls[m] = _interior_balls(v1, v2, v3, sub_c, sub_r)
    return inner_gap, balls


def pack_slab_groups(slab_np: np.ndarray, scount_np: np.ndarray,
                     gsub: int) -> tuple[np.ndarray, np.ndarray]:
    """Bounding spheres over runs of `gsub` consecutive slabs (a second
    bound level for huge meshes). Returns (group_bounds (M, G, 5)
    [cx cy cz r^2 r], group_count (M,) i32); empty groups get r^2 = -1e30.
    Conservative: group radius = max over member slabs of
    |slab_center - group_center| + slab_radius, grown by 1e-5. The Hopper
    kernel walks the groups of meshes of more than `gsub` slabs."""
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
