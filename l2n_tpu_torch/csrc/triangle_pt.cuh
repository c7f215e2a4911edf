// The triangle scene of the triangle path-tracing kernel
// (csrc/triangle_pt.cu): per-thread traversal of the packed bound hierarchy
// (mesh sphere -> 128-triangle slab sphere -> 16-triangle sub-cluster
// sphere -> Möller-Trumbore), which the shared path body
// (csrc/pathtrace.cuh) calls as nearest() and anyhit().
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

#include "pathtrace.cuh"

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
// distance that may still hold a hit at t <= best? The enter test is the
// JAX package's sqrt-free form `c < 0 || (hb < 0 && hb*hb - c >= 0)` (never
// `hb*hb >= c`). The entry distance -hb - sqrt(hb*hb - c) loses digits to
// cancellation at grazing incidence, so it is held against best plus a
// margin of 1e-3 |hb|: visiting a bound too many changes nothing.
L2N_HD bool bound_visit(float ox, float oy, float oz, float dx, float dy,
                        float dz, float cx, float cy, float cz, float r2,
                        float best) {
  const float rox = ox - cx, roy = oy - cy, roz = oz - cz;
  const float hb = rox * dx + roy * dy + roz * dz;
  const float c = rox * rox + roy * roy + roz * roz - r2;
  if (c < 0.0f) return true;
  const float disc = hb * hb - c;
  if (!(hb < 0.0f && disc >= 0.0f)) return false;
  return -hb - sqrtf(disc) <= best + 1e-3f * -hb;
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

  // Walk every triangle whose bounds the ray visits: `visit(soup_index, t,
  // u, v)` gets each valid candidate and returns true to stop the walk
  // (any-hit); `visit.best` is read for pruning.
  template <class Visit>
  L2N_HD void walk(float ox, float oy, float oz, float dx, float dy, float dz,
                   Visit& visit) const {
    for (int m = 0; m < n; ++m) {
      const float* mb = mesh_bounds + 4 * m;
      if (!bound_visit(ox, oy, oz, dx, dy, dz, mb[0], mb[1], mb[2], mb[3],
                       visit.best))
        continue;
      const int slabs = slab_count[m];  // never past the mesh's own slabs
      for (int s = 0; s < slabs; ++s) {
        const int ms = m * n_slabs + s;
        const float* sb = slab_bounds + kBoundStride * ms;
        if (!bound_visit(ox, oy, oz, dx, dy, dz, load1(sb), load1(sb + 1),
                         load1(sb + 2), load1(sb + 3), visit.best))
          continue;
        for (int c = 0; c < kSubs; ++c) {
          const float* cb = sub_bounds + kBoundStride * (ms * kSubs + c);
          if (!bound_visit(ox, oy, oz, dx, dy, dz, load1(cb), load1(cb + 1),
                           load1(cb + 2), load1(cb + 3), visit.best))
            continue;
          const int slot0 = m * tpad + s * kSlab + c * kSubSize;
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
            const bool valid = det_ok && u >= 0.0f && u <= 1.0f &&
                               v >= 0.0f && u + v <= 1.0f && t >= kMtEps;
            // An infinite t never wins the oracle's strict `<` against its
            // initial inf, so it is no hit.
            if (valid && t < INFINITY &&
                visit(float_as_int(g.y), t, u, v))
              return;
          }
        }
      }
    }
  }

  L2N_HD Hit nearest(float ox, float oy, float oz, float dx, float dy,
                     float dz) const {
    NearestVisit nv;
    walk(ox, oy, oz, dx, dy, dz, nv);
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

  // Any valid candidate: exactly nearest(...).t >= 0.
  L2N_HD bool anyhit(float ox, float oy, float oz, float dx, float dy,
                     float dz) const {
    AnyVisit av;
    walk(ox, oy, oz, dx, dy, dz, av);
    return av.hit;
  }
};

}  // namespace l2n
