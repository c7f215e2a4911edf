"""The shell visit of lat/long sphere meshes: detection, the kernel's
buffers and the plain torch version of its casts (counterpart of
l2n_tpu/ops/kernels/shellwalk.py).

A scene whose every mesh is exactly tessellate_sphere(c, r, disc_lat,
disc_long) (the reference's triangle scene) lets a cast name the cells of
a mesh that its chord through the mesh's shell can meet: the kernel tests
those cells' stored triangles instead of the mesh's slabs (csrc/
shellwalk.cuh, which carries the coverage argument; csrc/triangle_pt.cuh
walk_list). Unlike the JAX kernel, which rebuilds the window's vertices
with in-kernel sin/cos and flips hits against its oracle, only the choice
of cells is procedural here: each triangle is read from the stored rows,
so the hit is the brute-force sweep's bit for bit.

  * `unit_inner_radius`, `detect_lat_long_spheres`: the JAX package's
    functions on the port's scene/tessellate.py (the same float32 centres,
    radii and r_in).
  * `shell_constants`: the kernel's constants for a tessellation, or None
    where its window cannot be proven (then every mesh walks its slabs).
  * `shell_buffers`: the shell buffer (constants, then each mesh's sphere
    and shell radii) and the stored rows by cell, which
    `TriangleBuffers.from_scene` carries.
  * `shell_window`: the kernel's per-mesh decision in torch, the same
    float32 operations in the same order.
  * `shell_nearest`: the JAX package's shell cast in torch (the K nearest
    shells by entry, each tried on its window; a hit before the next
    shell's entry is final, else the lane is pending), over the stored
    rows. The tests and chip_smoke.py's counts use it; the step does not.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from l2n_tpu_torch.maths.sampling import sqrt
from l2n_tpu_torch.ops.intersect import moller_trumbore
from l2n_tpu_torch.scene.tessellate import (
    tessellate_sphere,
    tessellate_sphere_info,
)

# csrc/shellwalk.cuh: the head of the shell buffer and where its tables
# start, the window's spans and the cells repeated at the end of a row.
SHELL_HEAD = 64
MESH_STRIDE = 8
ROW_AT = 8
PHI_AT = 32
SPAN_I = 3
SPAN_J = 2
PAD = SPAN_I + 2
MISS, WINDOW, WIDE = 0, 1, 2
# The kernel's slot row width (csrc/triangle_pt.cuh kTriStride).
_STRIDE = 12
# Lanes of one chunk of shell_nearest's (rays x meshes) temporaries.
_CHUNK = 4096


def unit_inner_radius(disc_lat: int, disc_long: int) -> float:
    """Min distance from center to any face plane of the UNIT lat/long
    tessellation — scale-invariant, so r_in(mesh) = r * this."""
    v, _, _, idx = tessellate_sphere(np.zeros(3), 1.0, disc_lat, disc_long)
    tri = idx.reshape(-1, 3)
    a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    n = np.cross(b - a, c - a)
    ln = np.linalg.norm(n, axis=1)
    ok = ln > 1e-6 * ln.max()
    return float((np.abs((n[ok] * a[ok]).sum(1)) / ln[ok]).min())


def detect_lat_long_spheres(scene, disc_lat: int, disc_long: int):
    """(centers (M,3), radii (M,)) if every mesh is exactly a
    tessellate_sphere(center, radius, disc_lat, disc_long) vertex grid,
    else None."""
    v_count, i_count = tessellate_sphere_info(disc_lat, disc_long)
    verts = np.asarray(scene.vertices)
    m_count = int(scene.mesh_count)
    if verts.shape[0] != m_count * v_count:
        return None
    if not np.array_equal(np.asarray(scene.triangle_count),
                          np.full(m_count, i_count // 3, np.int32)):
        return None
    grids = verts.reshape(m_count, disc_long + 1, disc_lat + 1, 3)
    # South pole row is (0,-1,0)*r + c repeated; north +r.
    south = grids[:, 0].mean(1)
    north = grids[:, -1].mean(1)
    centers = 0.5 * (south + north)
    radii = 0.5 * np.linalg.norm(north - south, axis=1)
    if (radii <= 0).any():
        return None
    for m in range(m_count):
        want, _, _, _ = tessellate_sphere(centers[m], float(radii[m]),
                                          disc_lat, disc_long)
        if not np.allclose(verts[m * v_count:(m + 1) * v_count], want,
                           atol=1e-3 * float(radii[m]) + 1e-6):
            return None
    return centers.astype(np.float32), radii.astype(np.float32)


def _bulge(span: float) -> float:
    """The most a great-circle arc between two points `span` apart in phi
    rises above the higher end's latitude: max over the vertex latitude i
    of i - atan(tan(i) cos(span / 2)), at tan(i) = 1 / sqrt(k)."""
    k = math.cos(0.5 * span)
    return math.atan(1.0 / math.sqrt(k)) - math.atan(math.sqrt(k))


def shell_constants(disc_lat: int, disc_long: int):
    """The kShellHead constants of csrc/shellwalk.cuh for a tessellation,
    float32; None where the window is not proven for it: an odd or small
    disc_lat (the window and its margins must fit in half a turn), tables
    beyond the head, or latitude bulges (the chord's over its largest
    span, the facets' top edges) plus the slack of one row or more."""
    dl, dj = int(disc_lat), int(disc_long)
    if dl % 2 or dl < 2 * (SPAN_I + 3) + 2 or dj < 2:
        return None
    if dj - 1 > PHI_AT - ROW_AT or 2 * (dl // 2 - 1) > SHELL_HEAD - PHI_AT:
        return None
    d_phi, d_theta = 2.0 * math.pi / dl, math.pi / dj
    if (_bulge((SPAN_I + 1.5) * d_phi) + _bulge(d_phi) + 0.05 + 0.01
            >= d_theta):
        return None
    h = np.zeros(SHELL_HEAD, np.float64)
    h[0], h[1] = dl, dj
    h[2] = 4e-6 / d_phi
    h[3] = 2e-5
    for k in range(1, dj):
        s = math.sin(-0.5 * math.pi + k * d_theta)
        h[ROW_AT + k - 1] = s * abs(s)
    for k in range(1, dl // 2):
        h[PHI_AT + 2 * (k - 1)] = math.sin(k * d_phi)
        h[PHI_AT + 2 * (k - 1) + 1] = math.cos(k * d_phi)
    return h.astype(np.float32)


def shell_radii(soup, centers: np.ndarray):
    """(r_out^2, r_in^2) (M,) float32 of each mesh's shell about its
    float32 centre, on the stored floats in float64: the farthest corner
    and the nearest plane of a facet (facets of area under 1e-3 r^2, the
    pole slivers, lie on their neighbours' edges and are skipped), widened
    by 1e-4 in the square and rounded outward."""
    mesh_id = soup["mesh_id"]
    m = centers.shape[0]
    v1 = np.stack([soup[f"v1{a}"] for a in "xyz"], 1).astype(np.float64)
    e1 = np.stack([soup[f"e1{a}"] for a in "xyz"], 1).astype(np.float64)
    e2 = np.stack([soup[f"e2{a}"] for a in "xyz"], 1).astype(np.float64)
    c = centers.astype(np.float64)[mesh_id]
    far = np.zeros(m)
    for p in (v1, v1 + e1, v1 + e2):
        np.maximum.at(far, mesh_id, ((p - c) ** 2).sum(1))
    n = np.cross(e1, e2)
    ln = np.linalg.norm(n, axis=1)
    ok = ln > 1e-3 * far[mesh_id]
    near = np.full(m, np.inf)
    dist = (n[ok] * (v1[ok] - c[ok])).sum(1) / ln[ok]
    np.minimum.at(near, mesh_id[ok], dist * dist)
    r2o = np.nextafter((far * (1.0 + 1e-4)).astype(np.float32),
                       np.float32(np.inf))
    r2i = np.nextafter((near * (1.0 - 1e-4)).astype(np.float32),
                       np.float32(0.0))
    return r2o, r2i


def sphere_normals(soup, mesh_bounds: np.ndarray) -> bool:
    """The JAX packer's sphere-normal test (l2n_tpu/ops/kernels/
    triangle_pt.py pack_mesh_blocks): every corner normal of each mesh is
    (corner - bound centre) / r within 1e-4, r the corners' mean distance,
    whose spread is within 1e-3 r."""
    mesh_id = soup["mesh_id"]
    na = np.stack([soup[f"na{a}"] for a in "xyz"], 1)
    nb = np.stack([soup[f"nb{a}"] for a in "xyz"], 1)
    nc = np.stack([soup[f"nc{a}"] for a in "xyz"], 1)
    v1 = np.stack([soup[f"v1{a}"] for a in "xyz"], 1)
    v2 = v1 + np.stack([soup[f"e1{a}"] for a in "xyz"], 1)
    v3 = v1 + np.stack([soup[f"e2{a}"] for a in "xyz"], 1)
    for m in range(mesh_bounds.shape[0]):
        sel = mesh_id == m
        c = mesh_bounds[m, :3]
        rs = np.sqrt(((v1[sel] - c) ** 2).sum(1))
        r = float(rs.mean()) if rs.size else 0.0
        if r <= 0.0 or float(np.abs(rs - r).max()) > 1e-3 * r:
            return False
        for v, nrm in ((v1, na), (v2, nb), (v3, nc)):
            if float(np.abs((v[sel] - c) / r - nrm[sel]).max()) > 1e-4:
                return False
    return True


def _tessellations(scene):
    """The (disc_lat, disc_long) pairs whose per-mesh vertex and triangle
    counts the scene's first mesh has: a lat/long mesh of V vertices and
    T triangles has disc_lat + disc_long = V - 1 - T / 2 and disc_lat
    disc_long = T / 2."""
    if scene.mesh_count == 0:
        return []
    t = int(scene.triangle_count[0])
    v = scene.vertices.shape[0] // scene.mesh_count
    s, p = v - 1 - t // 2, t // 2
    disc = s * s - 4 * p
    if t % 2 or disc < 0 or math.isqrt(disc) ** 2 != disc:
        return []
    a, b = (s + math.isqrt(disc)) // 2, (s - math.isqrt(disc)) // 2
    return [(x, y) for x, y in {(a, b), (b, a)} if x > 0 and y > 0]


def shell_buffers(scene, soup, mesh_bounds, slot_rows):
    """(shell (SHELL_HEAD + 8 M,) float32, shell_tris (rows, 12) float32,
    on) for a TriangleScene: `soup` its soup(), `mesh_bounds` the packed
    (M, 4) bounds, `slot_rows(idx)` the kernel's slot rows (v1 e1 e2, the
    soup index's int32 bits, 0, 0) of soup indices idx. On when the scene
    is a lat/long sphere scene with sphere normals whose tessellation has
    shell constants; off: a zero head and no rows. The shell holds the
    head, then per mesh cx cy cz r (detected), r_out^2, r_in^2
    (shell_radii), 0, 0; shell_tris, per mesh, row of cells and cell i of
    disc_lat + PAD (i mod disc_lat), the cell's two triangles."""
    m = int(scene.mesh_count)
    off = (np.zeros(SHELL_HEAD + MESH_STRIDE * m, np.float32),
           np.zeros((0, _STRIDE), np.float32), False)
    for dl, dj in _tessellations(scene):
        head = shell_constants(dl, dj)
        if head is None:
            continue
        det = detect_lat_long_spheres(scene, dl, dj)
        if det is None:
            continue
        centers, radii = det
        if not sphere_normals(soup, mesh_bounds):
            continue
        r2o, r2i = shell_radii(soup, centers)
        if not (r2i > 0.0).all():
            continue
        per_mesh = np.zeros((m, MESH_STRIDE), np.float32)
        per_mesh[:, :3], per_mesh[:, 3] = centers, radii
        per_mesh[:, 4], per_mesh[:, 5] = r2o, r2i
        shell = np.concatenate([head, per_mesh.reshape(-1)])
        j = np.arange(dj)[:, None, None]
        i = np.arange(dl + PAD)[None, :, None] % dl
        k = np.arange(2)[None, None, :]
        local = (2 * (j * dl + i) + k).reshape(-1)
        idx = (np.arange(m)[:, None] * (2 * dl * dj) + local[None]).reshape(-1)
        return shell, slot_rows(idx), True
    return off


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def shell_window(shell: torch.Tensor, mesh, ox, oy, oz, bx, by, bz):
    """csrc/shellwalk.cuh shell_window over broadcast lanes: mesh indices
    `mesh` (int64) against rays o + t b (b of unit length), float32.
    Returns (kind, i0, ni, j0, nj, t0, t_lim): kind MISS / WINDOW / WIDE,
    the window's cells (valid where kind == WINDOW), t0 the chord's entry
    (clamped at 0) and t_lim the t at or below which a candidate settles
    the mesh (inf: always)."""
    dev = shell.device
    h = shell[:SHELL_HEAD]
    dl, dj = int(h[0]), int(h[1])
    sm = shell[SHELL_HEAD:].reshape(-1, MESH_STRIDE)[mesh]
    cx, cy, cz, r, r2o, r2i = sm[..., :6].unbind(-1)
    rox, roy, roz = ox - cx, oy - cy, oz - cz
    hb = rox * bx + roy * by + roz * bz
    c0 = rox * rox + roy * roy + roz * roz
    lx, ly, lz = rox - hb * bx, roy - hb * by, roz - hb * bz
    h2 = lx * lx + ly * ly + lz * lz
    e = _f32(3e-6, dev) * c0 + _f32(2e-6, dev) * r2o
    wo2 = r2o - h2 + e
    zero = _f32(0.0, dev)
    wo = sqrt(torch.where(wo2 >= 0.0, wo2, zero))
    slack = (_f32(1e-6, dev) * (hb.abs() + wo) + _f32(1e-4, dev) * r)
    t_exit = -hb + wo + slack
    wi2 = r2i - h2 - e
    crossing = (hb < 0.0) & (wi2 > _f32(0.01, dev) * r2i)
    t1 = torch.where(crossing,
                     -hb - sqrt(torch.where(crossing, wi2, zero)) + slack,
                     t_exit)
    t0 = torch.clamp(-hb - wo - slack, min=0.0)
    x0, y0, z0 = rox + t0 * bx, roy + t0 * by, roz + t0 * bz
    x1, y1, z1 = rox + t1 * bx, roy + t1 * by, roz + t1 * bz
    perr = hb.abs() + t1 + r
    gp, gt = h[2] * perr, h[3] * perr
    xz0, xz1 = x0 * x0 + z0 * z0, x1 * x1 + z1 * z1
    p20, p21 = xz0 + y0 * y0, xz1 + y1 * y1
    guard = ((xz0 >= gp * gp) & (xz1 >= gp * gp) & (p20 >= gt * gt)
             & (p21 >= gt * gt))

    def cell_i(x, z):
        flip = x < 0.0
        x, z = torch.where(flip, -x, x), torch.where(flip, -z, z)
        i = torch.where(flip, dl // 2, 0)
        for k in range(1, dl // 2):
            s, c = h[PHI_AT + 2 * (k - 1)], h[PHI_AT + 2 * (k - 1) + 1]
            i = i + (x * c - z * s >= 0.0).long()
        return i

    def cell_j(y, p2):
        sy = y * y.abs()
        j = torch.zeros(y.shape, dtype=torch.int64, device=dev)
        for k in range(1, dj):
            j = j + (sy > h[ROW_AT + k - 1] * p2).long()
        return j

    ia, ib = cell_i(x0, z0), cell_i(x1, z1)
    ja, jb = cell_j(y0, p20), cell_j(y1, p21)
    fwd, bwd = (ib - ia) % dl, (ia - ib) % dl
    si = torch.minimum(fwd, bwd)
    sj = (ja - jb).abs()
    i0 = (torch.where(fwd <= bwd, ia, ib) - 1) % dl
    ni = si + 3
    j0 = torch.clamp(torch.minimum(ja, jb) - 1, min=0)
    nj = torch.clamp(torch.maximum(ja, jb) + 1, max=dj - 1) - j0 + 1
    t_lim = torch.where(crossing, t1, _f32(float("inf"), dev))
    wide = ((~(wo2 >= 0.0)) | (c0 <= r2i) | ~guard | (si > SPAN_I)
            | (sj > SPAN_J))
    miss = (wo2 < 0.0) | ((wo2 >= 0.0) & ~(c0 <= r2i) & (t_exit < 0.0))
    kind = torch.where(miss, MISS, torch.where(wide, WIDE, WINDOW))
    return kind, i0, ni, j0, nj, t0, t_lim


def _window_hits(shell, shell_tris, mesh, i0, ni, j0, nj, o, d):
    """The nearest candidate of each lane's window (rows (R,) of lanes):
    (t, soup index), inf and 2^62 where the window has none; the first
    soup index of the minimum t, the walk's winner rule."""
    h = shell[:SHELL_HEAD]
    dl, dj = int(h[0]), int(h[1])
    dev = shell.device
    rows = torch.arange(SPAN_J + 3, device=dev)
    cols = torch.arange(2 * (SPAN_I + 3), device=dev)
    jj = j0[:, None, None] + rows[None, :, None]
    flat = (((mesh[:, None, None] * dj + jj) * (dl + PAD)
             + i0[:, None, None]) * 2 + cols[None, None, :])
    live = ((rows[None, :, None] < nj[:, None, None])
            & (cols[None, None, :] < 2 * ni[:, None, None]))
    flat = torch.where(live, flat, 0).reshape(flat.shape[0], -1)
    tri = shell_tris[flat]  # (R, W, 12)
    cols9 = {k: tri[..., n] for n, k in enumerate(
        ("v1x", "v1y", "v1z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z"))}
    idx = tri[..., 9].contiguous().view(torch.int32).long()
    ray = [a[:, None] for a in (*o, *d)]
    t, _, _, valid = moller_trumbore(*ray, cols9)
    inf = _f32(float("inf"), dev)
    t = torch.where(valid & live.reshape(valid.shape) & (t < inf), t, inf)
    tmin = t.amin(1)
    big = torch.full((), 1 << 62, dtype=torch.int64, device=dev)
    imin = torch.where((t == tmin[:, None]) & (t < inf), idx, big).amin(1)
    return tmin, imin


def shell_nearest(shell: torch.Tensor, shell_tris: torch.Tensor, ox, oy, oz,
                  dx, dy, dz, k_slots: int = 4, stats: dict | None = None):
    """The JAX package's shell cast (l2n_tpu/ops/kernels/shellwalk.py
    shell_nearest) over the stored rows, with the kernel's windows: per
    ray the k_slots nearest meshes by chord entry (ties by index) are
    tried in order; a try that is WIDE, or whose window settles nothing
    under its t_lim (a crossing chord with no candidate in it), makes the
    lane pending, as does a hit that lies beyond the next mesh's entry
    after k_slots tries. A lane is resolved when its best hit lies before
    the next mesh's entry, or there is none. (dx, dy, dz) of unit length.

    Returns (t, mesh, pending) of the ray shape: t = -1 and mesh = -1 where
    no hit was found (for a resolved lane, a miss), the best hit so far on
    pending lanes. `stats`, if given, gets counts added: rays, resolved,
    pending, no_candidate, and per try: tries, wide (the mesh walks its
    slabs), unsettled (its window settled nothing: the slabs too), and
    pending_k (lanes that ran out of tries)."""
    shape = torch.broadcast_shapes(ox.shape, dx.shape)
    o = [torch.broadcast_to(a, shape).reshape(-1) for a in (ox, oy, oz)]
    d = [torch.broadcast_to(a, shape).reshape(-1) for a in (dx, dy, dz)]
    dev = shell.device
    h = shell[:SHELL_HEAD]
    if not float(h[0]) > 0.0:
        raise ValueError("shell_nearest: the scene has no shell")
    per_mesh = 2 * int(h[0]) * int(h[1])
    n_mesh = (shell.shape[0] - SHELL_HEAD) // MESH_STRIDE
    inf = _f32(float("inf"), dev)
    counts = dict(rays=0, resolved=0, pending=0, no_candidate=0, tries=0,
                  wide=0, unsettled=0, pending_k=0)
    out_t, out_m, out_p = [], [], []
    meshes = torch.arange(n_mesh, device=dev)
    for c0 in range(0, o[0].numel(), _CHUNK):
        oc = [a[c0:c0 + _CHUNK] for a in o]
        dc = [a[c0:c0 + _CHUNK] for a in d]
        n = oc[0].shape[0]
        kind, i0, ni, j0, nj, t0, t_lim = shell_window(
            shell, meshes[None, :], *(a[:, None] for a in (*oc, *dc)))
        entry = torch.where(kind != MISS, t0, inf)
        entry, order = torch.sort(entry, dim=1, stable=True)
        best_t = torch.full((n,), float("inf"), device=dev)
        best_i = torch.full((n,), 1 << 62, dtype=torch.int64, device=dev)
        done = ~(entry[:, 0] < inf)
        pending = torch.zeros(n, dtype=torch.bool, device=dev)
        lane = torch.arange(n, device=dev)
        for k in range(min(k_slots, n_mesh)):
            mk = order[:, k]
            active = ~done & (entry[:, k] < inf)
            pick = [a[lane, mk] for a in (kind, i0, ni, j0, nj, t_lim)]
            kd, wi0, wni, wj0, wnj, wlim = pick
            window = active & (kd == WINDOW)
            t_w, i_w = _window_hits(shell, shell_tris, mk, wi0, wni, wj0,
                                    wnj, oc, dc)
            unsettled = window & ~(t_w <= wlim)
            better = window & ((t_w < best_t)
                               | ((t_w == best_t) & (i_w < best_i)))
            best_t = torch.where(better, t_w, best_t)
            best_i = torch.where(better, i_w, best_i)
            wide = active & (kd == WIDE)
            pending = pending | wide | unsettled
            nxt = entry[:, k + 1] if k + 1 < n_mesh else torch.full_like(
                best_t, float("inf"))
            resolved = active & ~pending & ((best_t < nxt) | ~(nxt < inf))
            done = done | resolved
            counts["tries"] += int(active.sum())
            counts["wide"] += int(wide.sum())
            counts["unsettled"] += int(unsettled.sum())
        ran_out = ~done & ~pending
        pending = pending | ~done
        counts["rays"] += n
        counts["no_candidate"] += int((~(entry[:, 0] < inf)).sum())
        counts["resolved"] += int((~pending).sum())
        counts["pending"] += int(pending.sum())
        counts["pending_k"] += int(ran_out.sum())
        hit = best_t < inf
        out_t.append(torch.where(hit, best_t, _f32(-1.0, dev)))
        out_m.append(torch.where(hit, best_i // per_mesh, -1))
        out_p.append(pending)
    if stats is not None:
        for key, v in counts.items():
            stats[key] = stats.get(key, 0) + v
    return tuple(torch.cat(a).reshape(shape)
                 for a in (out_t, out_m, out_p))
