// The triangle scene of the triangle path-tracing kernel
// (csrc/triangle_pt.cu): per-thread traversal of the packed bound hierarchy
// (mesh sphere -> for meshes of more than 8 slabs, 8-slab group sphere ->
// 128-triangle slab sphere -> 16-triangle sub-cluster sphere ->
// Möller-Trumbore), seeded by the meshes' certain hits, which the shared
// path body (csrc/pathtrace.cuh) calls as nearest(), nearest_primary(),
// anyhit() and occluded().
//
// `__host__ __device__` like the path body: the CPU tests build this header
// with g++ against the plain torch path (brute force over the soup).
//
// The traversal owes the oracle's nearest hit, not its order: the oracle
// keeps the FIRST soup index of the minimum t. Here a candidate wins on
// `t < best || (t == best && soup_index < best_index)`, so the winner is
// the same whatever order meshes, slabs and triangles are visited in, and a
// bound is visited while its entry distance is <= best (ties included).
// Candidate arithmetic is the oracle's (ops/intersect.py::
// intersect_triangle_scene) in the same order on the same floats (the slot
// rows are a permutation of the soup's), and the winner's attributes are
// interpolated from the soup's corner values in the oracle's three-weight
// form.
//
// Certain-hit seeding (the JAX kernel's `t_ub`): a ray from outside a
// watertight mesh that crosses its inscribed sphere, or one of its
// interior balls, meets the surface no later than its entry into that
// sphere. While it scans the mesh bounds, a cast takes the nearest such
// entry over the meshes it enters from outside their bounds, inflated
// (kSeedScale, kSeedPad), as its starting `best`, so the walk prunes every
// bound beyond it from the start. That keeps the hit the brute-force
// sweep's, bit for bit: a candidate at t < seed lies in bounds entered at
// <= t, which the walk visits. Where the promise fails (a ray through a
// Möller-Trumbore epsilon crack), the seeded walk finds nothing under the
// seed, and the cast walks again unseeded; the JAX kernel returns a miss
// there.

#pragma once

#include "cull.cuh"

namespace l2n {

constexpr int kSlab = 128;    // triangles per slab
constexpr int kSubs = 8;      // sub-clusters per slab
constexpr int kSubSize = kSlab / kSubs;
constexpr int kTriStride = 12;   // per slot: v1 xyz, e1 xyz, e2 xyz, soup idx, 0, 0
constexpr int kAttrStride = 16;  // per soup triangle: na nb nc xyz, ta tb tc uv, mesh
constexpr int kBoundStride = 5;  // cx cy cz r^2 r
constexpr int kGroup = 8;     // slabs per slab group
constexpr int kBalls = 8;     // interior certain-hit balls per mesh
constexpr float kMtEps = 1e-6f;  // Möller-Trumbore epsilon
// The seed of a cast with certain-hit bound t_ub: t_ub * kSeedScale +
// kSeedPad, the JAX kernel's inflation.
constexpr float kSeedScale = 1.000004f;
constexpr float kSeedPad = 1e-5f;

struct F4 {
  float x, y, z, w;
};

// Four floats through the read-only data cache (16-byte aligned rows).
L2N_HD F4 load4(const float* p) {
#if defined(__CUDA_ARCH__)
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return F4{v.x, v.y, v.z, v.w};
#else
  return F4{p[0], p[1], p[2], p[3]};
#endif
}

L2N_HD float load1(const float* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

L2N_HD int float_as_int(float f) {
#if defined(__CUDA_ARCH__)
  return __float_as_int(f);
#else
  int i;
  memcpy(&i, &f, 4);
  return i;
#endif
}

// Does the ray meet the bound sphere (c, r2) with some t >= 0, at an entry
// distance that may still hold a hit at t <= best? Conservatively: a bound
// the brute-force sweep finds a hit in is never rejected. The test is the
// JAX package's sqrt-free form `c < 0 || (hb < 0 && hb*hb - c >= 0)`
// (never `hb*hb >= c`), but hb*hb - c cancels two terms of size |o - c|^2,
// and its rounding (at most 16.4 units of 2^-24 times |o - c|^2) once
// rejected, 900 units away, a mesh of radius 0.8 that the sweep hit: the
// discriminant is held against -1e-6 |o - c|^2 (16.8 units), which widens
// only far bounds (by 0.85 in r^2 at 924 units). The exact form, from the
// perpendicular component of o - c (Haines et al., Ray Tracing Gems, 2019,
// ch. 7), cost the default triangle step 3% (10 tiles) and 8% (whole
// frame) on the card, this one about 1.3% (PERF.md §6).
// The entry distance -hb - sqrt(max(disc, 0)) loses digits to
// cancellation at grazing incidence, so it is held against best plus a
// margin of 1e-3 |hb|: visiting a bound too many changes nothing. `enter`
// and `margin` return the two sides' terms (-inf and 0 for an origin
// inside the bound), so the test can be repeated later against a smaller
// best.
L2N_HD bool bound_enter(float ox, float oy, float oz, float dx, float dy,
                        float dz, float cx, float cy, float cz, float r2,
                        float best, float& enter, float& margin) {
  const float rox = ox - cx, roy = oy - cy, roz = oz - cz;
  const float hb = rox * dx + roy * dy + roz * dz;
  const float c = rox * rox + roy * roy + roz * roz - r2;
  if (c < 0.0f) {
    enter = -INFINITY;
    margin = 0.0f;
    return true;
  }
  const float disc = hb * hb - c;
  if (!(hb < 0.0f && disc >= -1e-6f * (c + r2))) return false;
  enter = -hb - sqrtf(disc > 0.0f ? disc : 0.0f);
  margin = 1e-3f * -hb;
  return enter <= best + margin;
}

L2N_HD bool bound_visit(float ox, float oy, float oz, float dx, float dy,
                        float dz, const float* b, float best) {
  float enter, margin;
  return bound_enter(ox, oy, oz, dx, dy, dz, b[0], b[1], b[2], b[3], best,
                     enter, margin);
}

// The running nearest hit: the first soup index of the minimum t.
struct NearestVisit {
  float best = INFINITY, bu = 0.0f, bv = 0.0f;
  int bi = -1;
  L2N_HD bool operator()(int idx, float t, float u, float v) {
    if (t < best || (t == best && idx < bi)) {
      best = t;
      bu = u;
      bv = v;
      bi = idx;
    }
    return false;
  }
  // A seeded walk that found no candidate under its seed.
  L2N_HD bool fell_short() const { return bi < 0 && best < INFINITY; }
};

// Stops at the first valid candidate; prunes only by the seed.
struct AnyVisit {
  float best = INFINITY;
  bool hit = false;
  L2N_HD bool operator()(int, float, float, float) {
    hit = true;
    return true;
  }
  L2N_HD bool fell_short() const { return !hit && best < INFINITY; }
};

// Entries of a lane's front-to-back list of entered meshes; a ray that
// enters more meshes walks them in chunks of this many (TriSceneView::walk).
#ifndef L2N_LANE_LIST
#define L2N_LANE_LIST 8
#endif
constexpr int kLaneList = L2N_LANE_LIST;
// A hook the CPU tests define to count each scan's list length and whether
// it overflowed; nothing in the kernels.
#ifndef L2N_NOTE_SCAN
#define L2N_NOTE_SCAN(cnt, more) ((void)0)
#endif
// A hook the CPU tests define to count the casts that walk again unseeded.
#ifndef L2N_NOTE_FALLBACK
#define L2N_NOTE_FALLBACK() ((void)0)
#endif
// A hook the CPU tests define to read the seed that a seeded walk's first
// scan takes (visit.best before anything is walked).
#ifndef L2N_NOTE_SEED
#define L2N_NOTE_SEED(best) ((void)0)
#endif

// kCallWalk: each cast's walk out of line on the card (see cast).
template <bool kCallWalk>
struct TriSceneViewT {
  int n;          // meshes
  int n_slabs;    // slab capacity per mesh (S)
  int tpad;       // triangle slots per mesh (S * kSlab)
  const float* mesh_bounds;   // (M, 4) cx cy cz r^2
  const int32_t* slab_count;  // (M,) live slabs per mesh
  const float* slab_bounds;   // (M, S, 5)
  const float* sub_bounds;    // (M, S, kSubs, 5)
  const float* group_bounds;  // (M, ceil(S / kGroup), 5)
  const float* inner_gap;     // (M,) r_out^2 - r_in^2, 3e30: none
  const float* balls;         // (M, kBalls, 4) cx cy cz r^2, live first
  const float* tris;          // (M * tpad, kTriStride)
  const float* attrs;         // (T, kAttrStride)
  const float *ar, *ag, *ab;  // albedo rows, (3, M)
  const float* mat = nullptr;  // material rows, (6, M) (brdf.cuh Material)
  const int32_t* vis = nullptr;  // the primaries' visible meshes, ascending;
  int n_vis = 0;                 // null: every mesh

  // The normal AOV's colour of a miss: magenta.
  L2N_HD static void miss_color(float col[3]) {
    col[0] = 1.0f;
    col[1] = 0.0f;
    col[2] = 1.0f;
  }

  // NEE samples a direction in the cone of a light mesh's bounding sphere
  // (pathtrace.cuh nee_cone); mesh i's bound: centre and r^2.
  static constexpr bool kConeLights = true;
  L2N_HD void bound(int i, float& x, float& y, float& z, float& r2) const {
    const float* b = mesh_bounds + 4 * i;
    x = b[0];
    y = b[1];
    z = b[2];
    r2 = b[3];
  }

  // Does the ray visit bound b (4 floats at `b`, read through the
  // read-only data cache) at the running best?
  L2N_HD static bool visits(float ox, float oy, float oz, float dx, float dy,
                            float dz, const float* b, float best) {
    const float c[4] = {load1(b), load1(b + 1), load1(b + 2), load1(b + 3)};
    return bound_visit(ox, oy, oz, dx, dy, dz, c, best);
  }

  // The certain-hit bound of a ray that enters mesh m's bound mb (the JAX
  // kernel's t_ub of one mesh, in the bound tests' direction b): the entry
  // into the inscribed sphere or into the nearest live interior ball; inf
  // where it crosses neither, and for an origin inside the bound. There
  // the JAX kernel takes the bound's exit or a sphere's entry too, which
  // fail for a ray that starts on the surface and heads into the solid (a
  // bumped bounce, a shadow ray from a backface): such a lane walks again,
  // and its warp with it (PERF.md §6).
  L2N_HD float certain_hit(int m, const float* mb, float ox, float oy,
                           float oz, float bx, float by, float bz) const {
    const float rox = ox - mb[0], roy = oy - mb[1], roz = oz - mb[2];
    const float hb = rox * bx + roy * by + roz * bz;
    const float c = rox * rox + roy * roy + roz * roz - mb[3];
    if (!(c >= 0.0f)) return INFINITY;
    const float c_in = c + load1(inner_gap + m);
    const float disc_in = hb * hb - c_in;
    float ub = INFINITY;
    if (hb < 0.0f && disc_in >= 0.0f && c_in >= 0.0f)
      ub = -hb - sqrtf(disc_in);
    for (int k = 0; k < kBalls; ++k) {
      const F4 bl = load4(balls + 4 * (kBalls * m + k));
      if (!(bl.w > 0.0f)) break;  // the live balls come first
      const float rbx = ox - bl.x, rby = oy - bl.y, rbz = oz - bl.z;
      const float hbb = rbx * bx + rby * by + rbz * bz;
      const float cb = rbx * rbx + rby * rby + rbz * rbz - bl.w;
      const float discb = hbb * hbb - cb;
      if (hbb < 0.0f && discb >= 0.0f && cb >= 0.0f)
        ub = fminf(ub, -hbb - sqrtf(discb));
    }
    return ub;
  }

  // Walk every triangle whose bounds the ray visits among the candidate
  // meshes `cand` (n_cand mesh indices; null: 0 .. n_cand - 1):
  // `visit(soup_index, t, u, v)` gets each valid candidate and returns true
  // to stop the walk (any-hit); `visit.best` is read for pruning. The bound
  // tests take the direction (bx, by, bz), which is (dx, dy, dz) but for a
  // direction that is not of unit length (see occluded); the triangle tests
  // take (dx, dy, dz).
  //
  // Per lane, not per warp: the lane tests the candidates' mesh bounds and
  // keeps the meshes it enters in a list sorted front to back by entry
  // distance (ties by index), then runs ONE loop over its own work items,
  // (mesh, slab, sub-cluster) bound tests until it reaches a sub-cluster to
  // sweep, then that sub-cluster's 16 triangles: the "while-while" traversal
  // of Aila & Laine (HPG 2009), so a warp pays for its longest lane's walk,
  // not for the union of its lanes' meshes. A lane that enters more than
  // kLaneList meshes takes them in chunks: each scan keeps the kLaneList
  // nearest meshes after the last one walked, and a mesh the running best
  // has pruned is never taken again; none is dropped. With `seed`, the
  // first scan (which tests every candidate) lowers `visit.best` to the
  // certain-hit seed of each mesh the ray enters, before anything is
  // walked (see the top of this file).
  template <class Visit>
  L2N_HD void walk(const int32_t* cand, int n_cand, float ox, float oy,
                   float oz, float dx, float dy, float dz, float bx,
                   float by, float bz, bool seed, Visit& visit) const {
    float last_enter = -INFINITY;
    int last_mesh = -1;
    for (;;) {
      float ent[kLaneList], mar[kLaneList];
      int mi[kLaneList];
      int cnt = 0;
      bool more = false;
      for (int j = 0; j < n_cand; ++j) {
        const int m = cand ? cand[j] : j;
        const float* mb = mesh_bounds + 4 * m;
        float enter, margin;
        if (!bound_enter(ox, oy, oz, bx, by, bz, mb[0], mb[1], mb[2], mb[3],
                         visit.best, enter, margin))
          continue;
        if (seed && last_mesh < 0)
          visit.best = fminf(visit.best,
                             certain_hit(m, mb, ox, oy, oz, bx, by, bz) *
                                     kSeedScale +
                                 kSeedPad);
        if (enter < last_enter || (enter == last_enter && m <= last_mesh))
          continue;  // walked in an earlier chunk
        if (cnt == kLaneList) {
          more = true;
          if (enter > ent[cnt - 1] ||
              (enter == ent[cnt - 1] && m > mi[cnt - 1]))
            continue;
          --cnt;  // evict the farthest; a later chunk takes it
        }
        int q = cnt++;
        for (; q > 0 && (ent[q - 1] > enter ||
                         (ent[q - 1] == enter && mi[q - 1] > m));
             --q) {
          ent[q] = ent[q - 1];
          mar[q] = mar[q - 1];
          mi[q] = mi[q - 1];
        }
        ent[q] = enter;
        mar[q] = margin;
        mi[q] = m;
      }
      L2N_NOTE_SCAN(cnt, more);
      if (seed && last_mesh < 0) L2N_NOTE_SEED(visit.best);
      if (walk_list(ent, mar, mi, cnt, ox, oy, oz, dx, dy, dz, bx, by, bz,
                    visit) ||
          !more)
        return;
      last_enter = ent[cnt - 1];
      last_mesh = mi[cnt - 1];
    }
  }

  // The work-item loop over a lane's sorted meshes (see walk); true when
  // `visit` stopped it. A mesh of more than kGroup slabs tests the bound
  // of each group of kGroup slabs first and walks only the slabs of the
  // groups it visits; every run of slabs ends at the mesh's own slab
  // count (the last group may be partial), and slabs keep ascending order.
  template <class Visit>
  L2N_HD bool walk_list(const float* ent, const float* mar, const int* mi,
                        int cnt, float ox, float oy, float oz, float dx,
                        float dy, float dz, float bx, float by, float bz,
                        Visit& visit) const {
    const int groups = (n_slabs + kGroup - 1) / kGroup;  // per mesh
    int li = 0, level = 0, m = 0, s = 0, send = 0, c = 0;
    for (;;) {
      // Bound tests until a sub-cluster to sweep (slot0) or the list's end.
      int slot0 = -1;
      while (li < cnt) {
        if (level == 0) {  // the next mesh, pruned against the running best
          if (ent[li] <= visit.best + mar[li]) {
            m = mi[li];
            s = 0;
            level = 1;
          } else {
            ++li;
          }
        } else if (level == 1) {  // the next run of slabs of mesh m, from s
          const int slabs = slab_count[m];
          if (s >= slabs) {
            ++li;
            level = 0;
          } else if (slabs <= kGroup) {  // no group level: every slab
            send = slabs;
            level = 2;
          } else {  // group s / kGroup
            send = s + kGroup < slabs ? s + kGroup : slabs;
            if (visits(ox, oy, oz, bx, by, bz,
                       group_bounds +
                           kBoundStride * (m * groups + s / kGroup),
                       visit.best))
              level = 2;
            else
              s = send;
          }
        } else if (level == 2) {  // slab s of the run
          if (s == send) {
            level = 1;
          } else if (visits(ox, oy, oz, bx, by, bz,
                            slab_bounds + kBoundStride * (m * n_slabs + s),
                            visit.best)) {
            c = 0;
            level = 3;
          } else {
            ++s;
          }
        } else if (c == kSubs) {  // sub-clusters of slab s done
          ++s;
          level = 2;
        } else {  // sub-cluster c of slab s
          const int ms = m * n_slabs + s;
          const bool in = visits(
              ox, oy, oz, bx, by, bz,
              sub_bounds + kBoundStride * (ms * kSubs + c), visit.best);
          if (in) slot0 = m * tpad + s * kSlab + c * kSubSize;
          ++c;
          if (in) break;
        }
      }
      if (slot0 < 0) return false;
      for (int i = 0; i < kSubSize; ++i) {
        const float* row = tris + static_cast<size_t>(slot0 + i) * kTriStride;
        const F4 a = load4(row), b = load4(row + 4), g = load4(row + 8);
        const float v1x = a.x, v1y = a.y, v1z = a.z;
        const float e1x = a.w, e1y = b.x, e1z = b.y;
        const float e2x = b.z, e2y = b.w, e2z = g.x;
        // P = cross(dir, e2); det = dot(e1, P)
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool det_ok = fabsf(det) >= kMtEps;
        const float rcp_det = 1.0f / (det_ok ? det : 1.0f);
        const float tx = ox - v1x, ty = oy - v1y, tz = oz - v1z;
        const float u = (tx * px + ty * py + tz * pz) * rcp_det;
        // Q = cross(T, e1)
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * rcp_det;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * rcp_det;
        const bool valid = det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                           u + v <= 1.0f && t >= kMtEps;
        // An infinite t never wins the oracle's strict `<` against its
        // initial inf, so it is no hit.
        if (valid && t < INFINITY && visit(float_as_int(g.y), t, u, v))
          return true;
      }
    }
  }

  L2N_HD Hit resolve(const NearestVisit& nv) const {
    const float best = nv.best, bu = nv.bu, bv = nv.bv;
    const int bi = nv.bi;
    Hit h;
    if (bi < 0) {
      h.t = -1.0f;
      h.nx = h.ny = h.nz = 0.0f;
      h.index = -1;
      h.r2 = 1.0f;
      h.tc_u = h.tc_v = h.b_u = h.b_v = 0.0f;
      return h;
    }
    const float* at = attrs + static_cast<size_t>(bi) * kAttrStride;
    const F4 a0 = load4(at), a1 = load4(at + 4), a2 = load4(at + 8),
             a3 = load4(at + 12);
    // na = a0.xyz, nb = (a0.w, a1.xy), nc = (a1.zw, a2.x),
    // ta = a2.yz, tb = (a2.w, a3.x), tc = a3.yz, mesh = a3.w
    const float w = 1.0f - bu - bv;
    h.t = best;
    h.nx = bu * a0.w + bv * a1.z + w * a0.x;
    h.ny = bu * a1.x + bv * a1.w + w * a0.y;
    h.nz = bu * a1.y + bv * a2.x + w * a0.z;
    h.tc_u = bu * a2.w + bv * a3.y + w * a2.y;
    h.tc_v = bu * a3.x + bv * a3.z + w * a2.z;
    h.b_u = bu;
    h.b_v = bv;
    h.index = float_as_int(a3.w);
    h.r2 = 1.0f;
    return h;
  }

  // The seeded walk, and where it fell short of its seed, the unseeded
  // one (one call site of walk).
  template <class Visit>
  L2N_HD Visit cast_walk(const int32_t* cand, int n_cand, float ox,
                         float oy, float oz, float dx, float dy, float dz,
                         float bx, float by, float bz) const {
    Visit visit;
    for (bool seed = true;; seed = false) {
      walk(cand, n_cand, ox, oy, oz, dx, dy, dz, bx, by, bz, seed, visit);
      if (!seed || !visit.fell_short()) return visit;
      L2N_NOTE_FALLBACK();
      visit = Visit();
    }
  }

  // cast_walk out of line on the card: one copy of the walk per Visit
  // type, which gets the registers that the path body holds at the call.
  template <class Visit>
#if defined(__CUDA_ARCH__)
  __noinline__
#endif
  L2N_HD Visit cast_call(const int32_t* cand, int n_cand, float ox,
                         float oy, float oz, float dx, float dy, float dz,
                         float bx, float by, float bz) const {
    return cast_walk<Visit>(cand, n_cand, ox, oy, oz, dx, dy, dz, bx, by,
                            bz);
  }

  // Every cast. The materials, NEE and fog bodies (csrc/triangle_pt.cu),
  // whose path state spills under the 80-register cap with the walk
  // inlined, call it out of line, which made their whole frames with
  // lights, NEE or fog faster on the card; the Lambert and AOV bodies,
  // which do not spill, are faster with it inlined (PERF.md §6). One form
  // per body: in the materials body only the explicit lights gain (-16%,
  // 0.33 ms a whole frame), while microfacet and the bump lose 2-8%
  // (0.01-0.08 ms) against the parent commit's inlined walk.
  template <class Visit>
  L2N_HD Visit cast(const int32_t* cand, int n_cand, float ox, float oy,
                    float oz, float dx, float dy, float dz, float bx,
                    float by, float bz) const {
    if constexpr (kCallWalk)
      return cast_call<Visit>(cand, n_cand, ox, oy, oz, dx, dy, dz, bx, by,
                              bz);
    else
      return cast_walk<Visit>(cand, n_cand, ox, oy, oz, dx, dy, dz, bx, by,
                              bz);
  }

  L2N_HD Hit nearest(float ox, float oy, float oz, float dx, float dy,
                     float dz) const {
    return resolve(cast<NearestVisit>(nullptr, n, ox, oy, oz, dx, dy, dz,
                                      dx, dy, dz));
  }

  // The primary cast walks only the tile's visible meshes (csrc/cull.cuh).
  L2N_HD Hit nearest_primary(float ox, float oy, float oz, float dx,
                             float dy, float dz) const {
    return resolve(cast<NearestVisit>(vis, vis ? n_vis : n, ox, oy, oz, dx,
                                      dy, dz, dx, dy, dz));
  }

  // Any valid candidate: exactly nearest(...).t >= 0. The seed prunes the
  // bounds beyond it; any candidate, near or far, ends the walk. The JAX
  // kernel's shortcut, a hit declared for every ray that crosses a
  // certain-hit sphere without a walk, is not taken: it would differ from
  // the brute-force sweep at the rays through an epsilon crack.
  L2N_HD bool anyhit(float ox, float oy, float oz, float dx, float dy,
                     float dz) const {
    return cast<AnyVisit>(nullptr, n, ox, oy, oz, dx, dy, dz, dx, dy, dz)
        .hit;
  }

  // The ambient-occlusion cast along (dx, dy, dz) of any length: exactly
  // nearest(...).t >= 0 (the JAX package's nearest-hit cast; whether a
  // valid candidate exists does not depend on the order of the walk). Its
  // direction is the unnormalized hemisphere sample, of length |n| < 1 for
  // an interpolated mesh normal, which the bound tests' half-b form takes
  // as 1: they take the direction normalized (the same line meets the same
  // bounds), the triangle tests the direction as given, and the seed, in
  // the bound tests' units, prunes only bounds.
  L2N_HD bool occluded(float ox, float oy, float oz, float dx, float dy,
                       float dz) const {
    float bx = dx, by = dy, bz = dz;
    normalize3(bx, by, bz, false);
    return cast<AnyVisit>(nullptr, n, ox, oy, oz, dx, dy, dz, bx, by, bz)
        .hit;
  }
};

using TriSceneView = TriSceneViewT<false>;

}  // namespace l2n
