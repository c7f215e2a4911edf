// The shell visit of a lat/long sphere mesh (the counterpart of the TPU
// kernel's shellwalk, l2n_tpu/ops/kernels/shellwalk.py): which cells of
// mesh m's tessellation a ray's chord through the mesh's shell can meet,
// so that the walk (csrc/triangle_pt.cuh walk_list) tests those cells'
// stored triangles instead of walking the mesh's slabs.
//
// A detected mesh is exactly tessellate_sphere(c, r, disc_lat, disc_long)
// (ops/kernels/shellwalk.py detect_lat_long_spheres): cell (i, j) spans
// phi in [i dphi, (i+1) dphi] (phi = atan2(x, z)) and latitude in
// [-pi/2 + j dtheta, -pi/2 + (j+1) dtheta], and holds soup triangles
// 2 (j disc_lat + i) and + 1 of the mesh. Only the CHOICE of cells is
// procedural: every triangle tested is read from the stored rows
// (`shell_tris`, the same v1/e1/e2 floats as the slot rows and the soup
// that the brute-force sweep reads) and goes through the walk's own
// Möller-Trumbore test and winner rule, so the hit stays the sweep's.
//
// Why the window holds every candidate of the chord (exact arithmetic
// first, then the float slack):
//  * Shell. Every point of the mesh lies between its inscribed sphere
//    (radius r_in: the nearest plane of a facet) and its vertex sphere
//    (r_out: the farthest corner), both measured about the float32 centre
//    on the stored floats in float64 and widened by 1e-4 in the square
//    (ops/kernels/shellwalk.py shell_buffers; the float32 corners of a
//    mesh of radius 0.14 centred 500 units out lie up to 4e-4 r off the
//    ideal sphere, more than the JAX kernel's 3e-4 in r^2). The chord is
//    [t0, t1]: t0 the entry into the outer sphere, or 0 from inside; t1
//    its exit, or, for a ray that crosses the inscribed sphere, the entry
//    there. The half-chord is taken from the perpendicular offset
//    l = ro - (ro.b) b, whose square h2 is off by at most 32 u |ro| |l|
//    (u = 2^-24): the radicand is inflated by 3e-6 |ro|^2 + 2e-6 r_out^2,
//    which covers that and bound_enter's -1e-6 |ro|^2 (csrc/
//    triangle_pt.cuh), and each end moves out by 1e-6 (|hb| + w) + 1e-4 r
//    for the rounding of -hb and of a candidate's t.
//  * Longitude. A straight segment projects onto the xz plane as a
//    segment, whose angle about the y axis sweeps monotonically, less than
//    pi, from one end's phi to the other's the short way; and a facet's
//    radial projection lies exactly inside its phi wedge (the wedge of
//    dphi < pi is convex and holds all three corners; the pole corners lie
//    on its edge). So the cells from the end cells' one to the other's
//    hold every candidate in longitude.
//  * Latitude. Neither is exact: a facet's top edge, a chord between two
//    corners dphi apart, bulges poleward by at most
//    atan(1 / sqrt(k)) - atan(sqrt(k)) with k = cos(dphi / 2) (0.56 deg
//    at disc_lat 16), and the chord's arc by that bound with k =
//    cos(D / 2), D its true phi span, < (3 + 1.5) dphi after the span
//    test below (12.9 deg at disc_lat 16). So the rows from one end's row
//    to the other's, one row wider on each side, hold every candidate as
//    long as both bulges and the slack stay under one row (22.5 deg at
//    disc_long 8); shell_constants checks that for the tessellation and
//    leaves the shell off where it fails.
//  * Slack. An end point's position is off by at most 1e-6 (|hb| + t1 +
//    r) per coordinate; the window refuses ends nearer the pole axis than
//    4 / dphi times that (so phi is off by under dphi / 4), or nearer the
//    centre than 2e4 times it (latitude off by under 0.05 rad). The cells
//    come from sign tests against the boundary meridians and latitude
//    rows, with no atan2 or sqrt, identically in torch and here.
//  * So the window is the end cells' phi run plus one cell on each side
//    (at most 3 + 3 cells) by their row run plus one row on each side
//    (at most 2 + 3 rows, clipped at the poles). A chord whose ends lie
//    more than 3 cells or 2 rows apart (near a pole, or grazing), and an
//    origin inside the inscribed sphere, are WIDE: the mesh walks its
//    slabs.
//  * The rule per mesh. Without a crossing the chord is all of the shell
//    ahead of the origin: the window's candidates are all of the mesh's,
//    and the mesh is done. With one, the window holds every candidate at
//    t <= t1; the far side's (beyond the inscribed sphere, more than
//    0.2 r_in farther) are not in it. If the window found a candidate at
//    t <= t1, the mesh's nearest is among the window's and the mesh is
//    done; else (a ray through an epsilon crack between two facets) the
//    mesh walks its slabs as well. Only the pole slivers (degenerate
//    facets with |det| >= 1e-6, ROADMAP Queue 3 #18) can be accepted far
//    from their facet, and those the slab walk misses as well.
//
// `__host__ __device__`: the CPU tests build it with g++ and hold it to
// the torch version (ops/kernels/shellwalk.py shell_window) bit for bit.

#pragma once

namespace l2n {

// The shell buffer: kShellHead floats of constants, then kShellMesh per
// mesh: cx, cy, cz, r (the detected sphere), r_out^2, r_in^2 (the shell),
// 0, 0. Constants: [0] disc_lat, [1] disc_long, [2] the phi guard
// 4e-6 / dphi, [3] the latitude guard 2e-5; [kShellRowAt + k - 1]
// sin(th_k) |sin(th_k)| of the rows' lower latitudes th_k, k = 1 ..
// disc_long - 1; [kShellPhiAt + 2 (k - 1)] sin, cos of phi_k = k dphi,
// k = 1 .. disc_lat / 2 - 1. disc_lat 0: no shell.
constexpr int kShellHead = 64;
constexpr int kShellMesh = 8;
constexpr int kShellRowAt = 8;
constexpr int kShellPhiAt = 32;
// Cells a window may span beyond the end cells (MAX_SPAN in JAX), and the
// cells repeated at the end of each stored row so that a window that wraps
// phi is one run of slots: shell_tris is (M, disc_long, disc_lat +
// kShellPad, 2) rows of kTriStride floats.
constexpr int kShellSpanI = 3;
constexpr int kShellSpanJ = 2;
constexpr int kShellPad = kShellSpanI + 2;

enum { kShellMiss = 0, kShellWindow = 1, kShellWide = 2 };

// A mesh's cell window: cells i0 .. i0 + ni - 1 (stored run, may pass
// disc_lat) of rows j0 .. j0 + nj - 1; a candidate at t <= t_lim settles
// the mesh (inf: any candidate, or none).
struct ShellWindow {
  int i0, ni, j0, nj;
  float t_lim;
};

// The phi cell of a direction (x, z) (sign tests against the meridians).
L2N_HD int shell_cell_i(const float* h, int dl, float x, float z) {
  int i = 0;
  if (x < 0.0f) {
    x = -x;
    z = -z;
    i = dl / 2;
  }
  for (int k = 1; k < dl / 2; ++k) {
    const float s = load1(h + kShellPhiAt + 2 * (k - 1));
    const float c = load1(h + kShellPhiAt + 2 * (k - 1) + 1);
    i += x * c - z * s >= 0.0f;
  }
  return i;
}

// The latitude row of a point of height y and squared length p2.
L2N_HD int shell_cell_j(const float* h, int dj, float y, float p2) {
  const float sy = y * fabsf(y);
  int j = 0;
  for (int k = 1; k < dj; ++k) j += sy > load1(h + kShellRowAt + k - 1) * p2;
  return j;
}

// Mesh m against the ray o + t b (b of unit length): kShellMiss (the ray
// misses the shell ahead: no candidate), kShellWindow (w set) or
// kShellWide (walk the slabs). See the top of this file.
L2N_HD int shell_window(const float* h, int m, float ox, float oy, float oz,
                        float bx, float by, float bz, ShellWindow& w) {
  const int dl = static_cast<int>(load1(h));
  const int dj = static_cast<int>(load1(h + 1));
  const F4 sm = load4(h + kShellHead + kShellMesh * m);
  const F4 sr = load4(h + kShellHead + kShellMesh * m + 4);
  const float r2o = sr.x, r2i = sr.y;
  const float rox = ox - sm.x, roy = oy - sm.y, roz = oz - sm.z;
  const float hb = rox * bx + roy * by + roz * bz;
  const float c0 = rox * rox + roy * roy + roz * roz;
  const float lx = rox - hb * bx, ly = roy - hb * by, lz = roz - hb * bz;
  const float h2 = lx * lx + ly * ly + lz * lz;
  const float e = 3e-6f * c0 + 2e-6f * r2o;
  const float wo2 = r2o - h2 + e;
  if (wo2 < 0.0f) return kShellMiss;
  if (!(wo2 >= 0.0f) || c0 <= r2i) return kShellWide;
  const float wo = sqrtf(wo2);
  const float slack = 1e-6f * (fabsf(hb) + wo) + 1e-4f * sm.w;
  const float t_exit = -hb + wo + slack;
  if (t_exit < 0.0f) return kShellMiss;
  const float wi2 = r2i - h2 - e;
  const bool crossing = hb < 0.0f && wi2 > 0.01f * r2i;
  const float t1 = crossing ? -hb - sqrtf(wi2) + slack : t_exit;
  const float t0 = fmaxf(-hb - wo - slack, 0.0f);
  const float perr = fabsf(hb) + t1 + sm.w;
  const float gp = load1(h + 2) * perr, gt = load1(h + 3) * perr;
  // The end cells, one end at a time (fewer live registers).
  int ia, ja, ib, jb;
  {
    const float x = rox + t0 * bx, y = roy + t0 * by, z = roz + t0 * bz;
    const float xz = x * x + z * z, p2 = xz + y * y;
    if (!(xz >= gp * gp && p2 >= gt * gt)) return kShellWide;
    ia = shell_cell_i(h, dl, x, z);
    ja = shell_cell_j(h, dj, y, p2);
  }
  {
    const float x = rox + t1 * bx, y = roy + t1 * by, z = roz + t1 * bz;
    const float xz = x * x + z * z, p2 = xz + y * y;
    if (!(xz >= gp * gp && p2 >= gt * gt)) return kShellWide;
    ib = shell_cell_i(h, dl, x, z);
    jb = shell_cell_j(h, dj, y, p2);
  }
  const int fwd = (ib - ia + dl) % dl, bwd = (ia - ib + dl) % dl;
  const int si = fwd < bwd ? fwd : bwd;
  const int sj = ja > jb ? ja - jb : jb - ja;
  if (si > kShellSpanI || sj > kShellSpanJ) return kShellWide;
  w.i0 = ((fwd <= bwd ? ia : ib) - 1 + dl) % dl;
  w.ni = si + 3;
  const int jlo = (ja < jb ? ja : jb) - 1, jhi = (ja > jb ? ja : jb) + 1;
  w.j0 = jlo > 0 ? jlo : 0;
  w.nj = (jhi < dj - 1 ? jhi : dj - 1) - w.j0 + 1;
  w.t_lim = crossing ? t1 : INFINITY;
  return kShellWindow;
}

}  // namespace l2n
