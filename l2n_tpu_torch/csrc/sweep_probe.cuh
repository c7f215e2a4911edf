// Per-lane bodies of the sphere-sweep probes (csrc/sweep_variants.cu,
// csrc/onehot_recovery.cu).
//
// `__host__ __device__` like the path body: the CPU tests build this header
// with g++ (-ffp-contract=off) against the plain torch versions
// (probes/sweep_variants.py, probes/onehot_recovery.py); nvcc builds it with
// -fmad=false. Each form keeps the JAX probe's float32 operations in its
// order, so all three agree bit for bit.
//
// Two forms of one candidate test:
//   * half-b two roots (benchmarks/sweep_variants.py:62-80): ro = o - c,
//     t1 = -hb - sq, else t2 = -hb + sq, else kBig;
//   * assume_outside, t1 only (benchmarks/onehot_recovery.py:58-85):
//     co = c - o, c = (cox*cox - r2) + coy*coy + coz*coz, t1 = nhb - sq,
//     else kBig.
// Each sweep is a template on `kCarry`: carry the winner's four attributes
// through every candidate (true), or keep (t, index) only and read the
// attributes afterwards (false, `gather`).

#pragma once

#include <math.h>
#include <stdint.h>

#ifndef L2N_HD
#if defined(__CUDACC__)
#define L2N_HD __host__ __device__ __forceinline__
#else
#define L2N_HD inline
#endif
#endif

namespace l2n_probe {

constexpr float kBig = 3.0e38f;

// Sphere SoA: rows cx, cy, cz, r2 of a (4, n) buffer.
struct Spheres {
  const float* rows;
  int n;
};

// The winner of a sweep: t (kBig on a miss), index (-1 on a miss) and the
// attributes (cx, cy, cz, r2) of the winner, or the miss values.
struct Winner {
  float t;
  int i;
  float cx, cy, cz, r2;
};

// One candidate of the half-b two-root form: its t, or kBig. A negative
// discriminant makes sqrtf NaN, which fails both comparisons.
struct TwoRoot {
  L2N_HD static float t(float ox, float oy, float oz, float dx, float dy,
                        float dz, float cx, float cy, float cz, float r2) {
    const float rox = ox - cx, roy = oy - cy, roz = oz - cz;
    const float hb = rox * dx + roy * dy + roz * dz;
    const float c = rox * rox + roy * roy + roz * roz - r2;
    const float sq = sqrtf(hb * hb - c);
    const float t1 = -hb - sq;
    const float t2 = -hb + sq;
    float t = t1 >= 0.0f ? t1 : t2;
    return t >= 0.0f ? t : kBig;
  }
};

// One candidate of the assume_outside t1-only form.
struct T1Only {
  L2N_HD static float t(float ox, float oy, float oz, float dx, float dy,
                        float dz, float cx, float cy, float cz, float r2) {
    const float cox = cx - ox, coy = cy - oy, coz = cz - oz;
    const float nhb = cox * dx + coy * dy + coz * dz;
    const float c = (cox * cox - r2) + coy * coy + coz * coz;
    const float sq = sqrtf(nhb * nhb - c);
    const float t1 = nhb - sq;
    return t1 >= 0.0f ? t1 : kBig;
  }
};

// The winner's attributes read from a table after an index-only sweep:
// attribute k (cx, cy, cz, r2) of sphere i at table[i * row + k * col]
// (the (4, n) sphere rows: row 1, col n; onehot_recovery's (S, 8) table:
// row 8, col 1), or (0, 0, 0, 0) on a miss. The one-hot recoveries of both
// JAX probes (a sum of one attribute and zeros) are exactly this gather.
L2N_HD void gather(const float* table, int row, int col, Winner& w) {
  if (w.i >= 0) {
    const float* a = table + static_cast<size_t>(w.i) * row;
    w.cx = a[0];
    w.cy = a[col];
    w.cz = a[2 * col];
    w.r2 = a[3 * col];
  } else {
    w.cx = w.cy = w.cz = w.r2 = 0.0f;
  }
}

// The nearest sphere along (o, d) with candidate test `Form` (TwoRoot or
// T1Only); `miss_r2` is the carried r2 before any hit (0 in
// sweep_variants, 1 in onehot_recovery's carry kernel). Without kCarry
// the attributes stay (0, 0, 0, miss_r2): the caller gathers them.
template <bool kCarry, class Form>
L2N_HD Winner sweep(const Spheres& s, float ox, float oy, float oz, float dx,
                    float dy, float dz, float miss_r2) {
  Winner w{kBig, -1, 0.0f, 0.0f, 0.0f, miss_r2};
  for (int j = 0; j < s.n; ++j) {
    const float cx = s.rows[j], cy = s.rows[s.n + j],
                cz = s.rows[2 * s.n + j], r2 = s.rows[3 * s.n + j];
    const float t = Form::t(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2);
    if (t < w.t) {
      w.t = t;
      w.i = j;
      if (kCarry) {
        w.cx = cx;
        w.cy = cy;
        w.cz = cz;
        w.r2 = r2;
      }
    }
  }
  return w;
}

// sweep_variants' repeat r: the direction's x scaled by 1 + 1e-4 r
// (benchmarks/sweep_variants.py:54-59), in float32.
L2N_HD float perturb_scale(int r) {
  return 1.0f + 1e-4f * static_cast<float>(r);
}

// sweep_variants' per-repeat accumulation (benchmarks/sweep_variants.py:
// 96-97), left to right: acc + t (0 on a miss) + cx 1e-6 + r2 1e-9 +
// index 1e-3.
L2N_HD float accumulate_vpu(float acc, const Winner& w) {
  return acc + (w.t < kBig ? w.t : 0.0f) + w.cx * 1e-6f + w.r2 * 1e-9f +
         static_cast<float>(w.i) * 1e-3f;
}

// One lane of sweep_variants' vpu (kCarry) or vpu2 (gather) kernel: R
// repeats of the two-root sweep from `bias`.
template <bool kCarry>
L2N_HD float sweep_lane(const Spheres& s, int repeats, float ox, float oy,
                        float oz, float dx, float dy, float dz, float bias) {
  float acc = bias;
  for (int r = 0; r < repeats; ++r) {
    Winner w = sweep<kCarry, TwoRoot>(s, ox, oy, oz, dx * perturb_scale(r),
                                      dy, dz, 0.0f);
    if (!kCarry) gather(s.rows, 1, s.n, w);
    acc = accumulate_vpu(acc, w);
  }
  return acc;
}

}  // namespace l2n_probe
