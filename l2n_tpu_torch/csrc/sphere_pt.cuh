// The sphere scene of the sphere path-tracing kernel (csrc/sphere_pt.cu):
// the nearest-hit and any-hit sweeps over the sphere SoA that the shared
// path body (csrc/pathtrace.cuh) calls.
//
// `__host__ __device__` like the path body: the CPU tests build this header
// with g++ against the plain torch path. The sweeps are the JAX package's
// half-b form (ops/intersect.py) in the same order of operations.

#pragma once

#include "pathtrace.cuh"

namespace l2n {

// Sphere SoA plus the per-sphere albedo table: rows of a (7, n) buffer.
struct SceneView {
  const float *cx, *cy, *cz, *r2, *ar, *ag, *ab;
  int n;

  L2N_HD Hit nearest(float ox, float oy, float oz, float dx, float dy,
                     float dz) const;
  L2N_HD bool anyhit(float ox, float oy, float oz, float dx, float dy,
                     float dz) const;
};

L2N_HD SceneView scene_view(const float* packed, int n) {
  return SceneView{packed, packed + n, packed + 2 * n, packed + 3 * n,
                   packed + 4 * n, packed + 5 * n, packed + 6 * n, n};
}

// Half-b sweep: a negative discriminant makes sqrtf NaN, and NaN fails every
// comparison, so the candidate is a miss.
L2N_HD Hit SceneView::nearest(float ox, float oy, float oz, float dx,
                              float dy, float dz) const {
  float best = kBig, bcx = 0.0f, bcy = 0.0f, bcz = 0.0f, br2 = 1.0f;
  int bi = -1;
  for (int i = 0; i < n; ++i) {
    const float rox = ox - cx[i], roy = oy - cy[i], roz = oz - cz[i];
    const float hb = rox * dx + roy * dy + roz * dz;
    const float c = rox * rox + roy * roy + roz * roz - r2[i];
    const float disc = hb * hb - c;
    const float sq = sqrtf(disc);
    const float nhb = -hb;
    const float t1 = nhb - sq;
    const float t2 = nhb + sq;
    float t = t1 >= 0.0f ? t1 : t2;
    t = t >= 0.0f ? t : kBig;
    if (t < best) {
      best = t;
      bi = i;
      bcx = cx[i];
      bcy = cy[i];
      bcz = cz[i];
      br2 = r2[i];
    }
  }
  Hit h;
  const bool hit = best < kBig;
  h.t = hit ? best : -1.0f;
  const float nx = ox + h.t * dx - bcx;
  const float ny = oy + h.t * dy - bcy;
  const float nz = oz + h.t * dz - bcz;
  const float rcp = hit ? 1.0f / sqrtf(nx * nx + ny * ny + nz * nz) : 0.0f;
  h.nx = nx * rcp;
  h.ny = ny * rcp;
  h.nz = nz * rcp;
  h.index = bi;
  h.r2 = br2;
  h.tc_u = h.tc_v = h.b_u = h.b_v = 0.0f;
  return h;
}

// Any sphere with t >= 0: origin inside (c < 0) or ahead with a real root.
L2N_HD bool SceneView::anyhit(float ox, float oy, float oz, float dx,
                              float dy, float dz) const {
  for (int i = 0; i < n; ++i) {
    const float rox = ox - cx[i], roy = oy - cy[i], roz = oz - cz[i];
    const float hb = rox * dx + roy * dy + roz * dz;
    const float c = rox * rox + roy * roy + roz * roz - r2[i];
    if (c < 0.0f || (hb < 0.0f && hb * hb >= c)) return true;
  }
  return false;
}

}  // namespace l2n
