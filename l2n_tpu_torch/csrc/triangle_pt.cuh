// The triangle scene of the triangle path-tracing kernel
// (csrc/triangle_pt.cu): per-thread traversal of the packed bound hierarchy
// (mesh sphere -> 128-triangle slab sphere -> 16-triangle sub-cluster
// sphere -> Möller-Trumbore), which the shared path body
// (csrc/pathtrace.cuh) calls as nearest(), nearest_primary() and anyhit().
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

#pragma once

#include "cull.cuh"

namespace l2n {

constexpr int kSlab = 128;    // triangles per slab
constexpr int kSubs = 8;      // sub-clusters per slab
constexpr int kSubSize = kSlab / kSubs;
constexpr int kTriStride = 12;   // per slot: v1 xyz, e1 xyz, e2 xyz, soup idx, 0, 0
constexpr int kAttrStride = 16;  // per soup triangle: na nb nc xyz, ta tb tc uv, mesh
constexpr int kBoundStride = 5;  // cx cy cz r^2 r
constexpr float kMtEps = 1e-6f;  // Möller-Trumbore epsilon

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
};

// Stops at the first valid candidate; never prunes.
struct AnyVisit {
  float best = INFINITY;
  bool hit = false;
  L2N_HD bool operator()(int, float, float, float) {
    hit = true;
    return true;
  }
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

struct TriSceneView {
  int n;          // meshes
  int n_slabs;    // slab capacity per mesh (S)
  int tpad;       // triangle slots per mesh (S * kSlab)
  const float* mesh_bounds;   // (M, 4) cx cy cz r^2
  const int32_t* slab_count;  // (M,) live slabs per mesh
  const float* slab_bounds;   // (M, S, 5)
  const float* sub_bounds;    // (M, S, kSubs, 5)
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
  // has pruned is never taken again; none is dropped.
  template <class Visit>
  L2N_HD void walk(const int32_t* cand, int n_cand, float ox, float oy,
                   float oz, float dx, float dy, float dz, float bx,
                   float by, float bz, Visit& visit) const {
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
      if (walk_list(ent, mar, mi, cnt, ox, oy, oz, dx, dy, dz, bx, by, bz,
                    visit) ||
          !more)
        return;
      last_enter = ent[cnt - 1];
      last_mesh = mi[cnt - 1];
    }
  }

  // The work-item loop over a lane's sorted meshes (see walk); true when
  // `visit` stopped it.
  template <class Visit>
  L2N_HD bool walk_list(const float* ent, const float* mar, const int* mi,
                        int cnt, float ox, float oy, float oz, float dx,
                        float dy, float dz, float bx, float by, float bz,
                        Visit& visit) const {
    int li = 0, level = 0, m = 0, slabs = 0, s = 0, c = 0;
    for (;;) {
      // Bound tests until a sub-cluster to sweep (slot0) or the list's end.
      int slot0 = -1;
      while (li < cnt) {
        if (level == 0) {  // the next mesh, pruned against the running best
          if (ent[li] <= visit.best + mar[li]) {
            m = mi[li];
            slabs = slab_count[m];  // never past the mesh's own slabs
            s = 0;
            level = 1;
          } else {
            ++li;
          }
        } else if (level == 1) {  // slab s of mesh m
          if (s == slabs) {
            ++li;
            level = 0;
          } else if (visits(ox, oy, oz, bx, by, bz,
                            slab_bounds + kBoundStride * (m * n_slabs + s),
                            visit.best)) {
            c = 0;
            level = 2;
          } else {
            ++s;
          }
        } else if (c == kSubs) {  // sub-clusters of slab s done
          ++s;
          level = 1;
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

  L2N_HD Hit nearest(float ox, float oy, float oz, float dx, float dy,
                     float dz) const {
    NearestVisit nv;
    walk(nullptr, n, ox, oy, oz, dx, dy, dz, dx, dy, dz, nv);
    return resolve(nv);
  }

  // The primary cast walks only the tile's visible meshes (csrc/cull.cuh).
  L2N_HD Hit nearest_primary(float ox, float oy, float oz, float dx,
                             float dy, float dz) const {
    NearestVisit nv;
    walk(vis, vis ? n_vis : n, ox, oy, oz, dx, dy, dz, dx, dy, dz, nv);
    return resolve(nv);
  }

  // Any valid candidate: exactly nearest(...).t >= 0.
  L2N_HD bool anyhit(float ox, float oy, float oz, float dx, float dy,
                     float dz) const {
    AnyVisit av;
    walk(nullptr, n, ox, oy, oz, dx, dy, dz, dx, dy, dz, av);
    return av.hit;
  }

  // The ambient-occlusion cast along (dx, dy, dz) of any length: exactly
  // nearest(...).t >= 0 (the JAX package's nearest-hit cast; whether a
  // valid candidate exists does not depend on the order of the walk). Its
  // direction is the unnormalized hemisphere sample, of length |n| < 1 for
  // an interpolated mesh normal, which the bound tests' half-b form takes
  // as 1: they take the direction normalized (the same line meets the same
  // bounds), the triangle tests the direction as given, and a walk that
  // stops at its first valid candidate prunes nothing by distance.
  L2N_HD bool occluded(float ox, float oy, float oz, float dx, float dy,
                       float dz) const {
    float bx = dx, by = dy, bz = dz;
    normalize3(bx, by, bz, false);
    AnyVisit av;
    walk(nullptr, n, ox, oy, oz, dx, dy, dz, bx, by, bz, av);
    return av.hit;
  }
};

}  // namespace l2n
