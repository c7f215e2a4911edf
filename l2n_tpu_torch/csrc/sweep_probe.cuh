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
// onehot_recovery.cu runs the t1-only form through `split_sweep`: one ray's
// sweep split over a group of lanes. sweep_variants.cu runs the two-root
// form through `sweep_lane_chunked` (end of this file): the spheres
// outside, a chunk of repeats inside. `sweep_lane` (serial, repeats
// outside) is the order both are tested against.

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

// ---------------------------------------------------------------------------
// onehot_recovery's split sweep (csrc/onehot_recovery.cu): the t1-only
// sweep of one ray split over a group of G lanes of a warp, the spheres
// packed 16 bytes each.
// ---------------------------------------------------------------------------

// A sphere's centre and r^2 in one 16-byte word: one shared-memory load per
// candidate instead of four.
struct alignas(16) Sphere4 {
  float cx, cy, cz, r2;
};

// Sphere j of the (4, n) SoA rows, packed.
L2N_HD Sphere4 packed_sphere(const float* rows, int n, int j) {
  return Sphere4{rows[j], rows[n + j], rows[2 * n + j], rows[3 * n + j]};
}

// T1Only::t with the square root taken only on a real discriminant. The
// same value to the bit: where nhb^2 - c < 0 (or is NaN) T1Only's sqrtf is
// NaN and fails t1 >= 0, giving kBig; -0.0 passes `>= 0.0f` and takes the
// sqrt as before.
L2N_HD float t1_only_guarded(float ox, float oy, float oz, float dx,
                             float dy, float dz, const Sphere4& q) {
  const float cox = q.cx - ox, coy = q.cy - oy, coz = q.cz - oz;
  const float nhb = cox * dx + coy * dy + coz * dz;
  const float c = (cox * cox - q.r2) + coy * coy + coz * coz;
  const float disc = nhb * nhb - c;
  if (!(disc >= 0.0f)) return kBig;
  const float t1 = nhb - sqrtf(disc);
  return t1 >= 0.0f ? t1 : kBig;
}

// TwoRoot::t from its half-b `hb` and c = |o - c|^2 - r^2, with the square
// root taken only on a real discriminant. The same value to the bit: where
// hb^2 - c < 0 (or is NaN) TwoRoot's sqrtf is NaN, so t1 and then t2 fail
// `>= 0`, giving kBig; -0.0 and +inf pass `>= 0.0f` and take the sqrt as
// before.
L2N_HD float two_root_guarded(float hb, float c) {
  const float disc = hb * hb - c;
  if (!(disc >= 0.0f)) return kBig;
  const float sq = sqrtf(disc);
  const float t1 = -hb - sq;
  const float t2 = -hb + sq;
  const float t = t1 >= 0.0f ? t1 : t2;
  return t >= 0.0f ? t : kBig;
}

// Part `part` of the sweep: spheres part, part + G, ... in ascending order,
// kept as `sweep` keeps them (strictly smaller t). Every lane runs the same
// ceil(n / G) rounds, a lane past the last sphere testing none, so that the
// group's shuffles after the sweep stay matched when G does not divide n or
// exceeds it.
template <bool kCarry, int G>
L2N_HD void sweep_part(const Sphere4* s, int n, int part, float ox, float oy,
                       float oz, float dx, float dy, float dz, Winner& w) {
  for (int base = 0; base < n; base += G) {
    const int j = base + part;
    const bool in = j < n;
    const Sphere4 q = s[in ? j : 0];
    const float t = in ? t1_only_guarded(ox, oy, oz, dx, dy, dz, q) : kBig;
    if (t < w.t) {
      w.t = t;
      w.i = j;
      if (kCarry) {
        w.cx = q.cx;
        w.cy = q.cy;
        w.cz = q.cz;
        w.r2 = q.r2;
      }
    }
  }
}

// Keep the other part's winner if its t is smaller or, on a tie, its index:
// over all parts, the first index of the minimum t, which is the serial
// sweep's winner. A part that hits nothing stays (kBig, -1, 0, 0, 0,
// miss_r2), and no candidate's t is kBig, so an all-miss ray keeps the
// serial sweep's miss values. With kCarry the winner's attributes move
// with it.
template <bool kCarry>
L2N_HD void combine(Winner& w, const Winner& o) {
  if (o.t < w.t || (o.t == w.t && o.i < w.i)) {
    w.t = o.t;
    w.i = o.i;
    if (kCarry) {
      w.cx = o.cx;
      w.cy = o.cy;
      w.cz = o.cz;
      w.r2 = o.r2;
    }
  }
}

// The lanes of the G-lane group holding warp lane `lane` (groups aligned to
// G within the warp).
template <int G>
L2N_HD unsigned group_mask(int lane) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0,
                "G is a power of two up to a warp");
  return G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
}

// `sweep<kCarry, T1Only>` over the packed spheres, split across the G lanes
// of a group: lane g sweeps part g, then log2(G) rounds of __shfl_xor_sync
// over the group's lanes (`mask`) combine the parts, (t, index) and, with
// kCarry, the four attributes. Every lane of the group returns the winner.
// The host build (the CPU tests) runs the G parts one after another, last
// part first, and combines them the same way: the tie rule is a total order
// on (t, index), so the order of combination does not change the winner,
// and combining the higher parts first leaves a tie to the rule.
template <bool kCarry, int G>
L2N_HD Winner split_sweep(const Sphere4* s, int n, int g, unsigned mask,
                          float ox, float oy, float oz, float dx, float dy,
                          float dz, float miss_r2) {
  Winner w{kBig, -1, 0.0f, 0.0f, 0.0f, miss_r2};
#if defined(__CUDA_ARCH__)
  sweep_part<kCarry, G>(s, n, g, ox, oy, oz, dx, dy, dz, w);
  for (int off = 1; off < G; off <<= 1) {
    Winner o;
    o.t = __shfl_xor_sync(mask, w.t, off);
    o.i = __shfl_xor_sync(mask, w.i, off);
    if (kCarry) {
      o.cx = __shfl_xor_sync(mask, w.cx, off);
      o.cy = __shfl_xor_sync(mask, w.cy, off);
      o.cz = __shfl_xor_sync(mask, w.cz, off);
      o.r2 = __shfl_xor_sync(mask, w.r2, off);
    }
    combine<kCarry>(w, o);
  }
#else
  (void)g;
  (void)mask;
  for (int part = G - 1; part >= 0; --part) {
    Winner o{kBig, -1, 0.0f, 0.0f, 0.0f, miss_r2};
    sweep_part<kCarry, G>(s, n, part, ox, oy, oz, dx, dy, dz, o);
    combine<kCarry>(w, o);
  }
#endif
  return w;
}

// `gather` from packed records, `stride` records apart, in one 16-byte load
// of the winner's, or (0, 0, 0, 0) on a miss.
L2N_HD void gather_packed(const Sphere4* s, int stride, Winner& w) {
  if (w.i >= 0) {
    const Sphere4 a = s[static_cast<size_t>(w.i) * stride];
    w.cx = a.cx;
    w.cy = a.cy;
    w.cz = a.cz;
    w.r2 = a.r2;
  } else {
    w.cx = w.cy = w.cz = w.r2 = 0.0f;
  }
}

// `gather` from onehot_recovery's (S, 8) table: columns 0-3 (cx, cy, cz,
// r2) of the winner's row, rows 32 bytes apart, so 16-byte aligned when the
// table is.
L2N_HD void gather_row(const float* table, Winner& w) {
  gather_packed(reinterpret_cast<const Sphere4*>(table), 2, w);
}

// ---------------------------------------------------------------------------
// sweep_variants' chunked sweep (csrc/sweep_variants.cu): the spheres
// outside, a chunk of R repeats inside, the spheres packed 16 bytes each,
// the roots only for the spheres that a lane's line meets.
// ---------------------------------------------------------------------------

#if defined(__CUDACC__)
#define L2N_UNROLL _Pragma("unroll")
#else
#define L2N_UNROLL
#endif

// Spheres per round of pass 1's loop over a block of spheres; a remainder
// loop takes the rest.
constexpr int kSphereUnroll = 4;

// The index of the lowest set bit of v != 0.
L2N_HD int lowest_bit(unsigned v) {
#if defined(__CUDA_ARCH__)
  return __ffs(static_cast<int>(v)) - 1;
#else
  return __builtin_ctz(v);
#endif
}

// What a lane's candidates of one sphere share across the repeats: o - c's
// x, hb's products roy dy and roz dz (the repeats perturb dx only), and
// c = |o - c|^2 - r^2, each rounded as TwoRoot rounds it.
struct SphereTerms {
  float rox, py, pz, c;
};

L2N_HD SphereTerms sphere_terms(const Sphere4& q, float ox, float oy,
                                float oz, float dy, float dz) {
  const float rox = ox - q.cx, roy = oy - q.cy, roz = oz - q.cz;
  return SphereTerms{rox, roy * dy, roz * dz,
                     rox * rox + roy * roy + roz * roz - q.r2};
}

// TwoRoot's hb = rox dx + roy dy + roz dz for the direction's x `dxr`.
L2N_HD float chunk_hb(const SphereTerms& a, float dxr) {
  return a.rox * dxr + a.py + a.pz;
}

// Pass 1: does the lane's line meet the sphere (hb^2 - c >= 0, TwoRoot's
// discriminant) in a repeat of the chunk?
template <int R>
L2N_HD bool chunk_meets(const SphereTerms& a, const float (&dxr)[R]) {
  bool meets = false;
  L2N_UNROLL
  for (int k = 0; k < R; ++k) {
    const float hb = chunk_hb(a, dxr[k]);
    meets |= hb * hb - a.c >= 0.0f;
  }
  return meets;
}

// Pass 2: sphere j's roots in each repeat of the chunk, each repeat's
// winner kept as `sweep` keeps it (strictly smaller t).
template <bool kCarry, int R>
L2N_HD void chunk_roots(const Sphere4& q, int j, const SphereTerms& a,
                        const float (&dxr)[R], Winner (&w)[R]) {
  L2N_UNROLL
  for (int k = 0; k < R; ++k) {
    const float t = two_root_guarded(chunk_hb(a, dxr[k]), a.c);
    if (t < w[k].t) {
      w[k].t = t;
      w[k].i = j;
      if (kCarry) {
        w[k].cx = q.cx;
        w[k].cy = q.cy;
        w[k].cz = q.cz;
        w[k].r2 = q.r2;
      }
    }
  }
}

// Repeats r0 .. r0 + R - 1 of sweep_lane, over the spheres in blocks of
// 32: pass 1 marks in a 32-bit mask the spheres of the block that the
// lane's line meets in a repeat of the chunk, pass 2 runs the roots of the
// marked ones, lowest index first. A sphere that pass 1 leaves out has no
// real discriminant in any repeat, so its roots are kBig and would change
// no winner: every repeat keeps the serial sweep's winner, ties included.
// Then each repeat's accumulation, in order (without kCarry, after its
// gather).
template <bool kCarry, int R>
L2N_HD void sweep_chunk(const Sphere4* s, int n, int r0, float ox, float oy,
                        float oz, float dx, float dy, float dz, float& acc) {
  float dxr[R];
  Winner w[R];
  L2N_UNROLL
  for (int k = 0; k < R; ++k) {
    dxr[k] = dx * perturb_scale(r0 + k);
    w[k] = Winner{kBig, -1, 0.0f, 0.0f, 0.0f, 0.0f};
  }
  for (int base = 0; base < n; base += 32) {
    const int m = n - base < 32 ? n - base : 32;
    unsigned hits = 0u;
    int u = 0;
    for (; u + kSphereUnroll <= m; u += kSphereUnroll) {
      L2N_UNROLL
      for (int v = 0; v < kSphereUnroll; ++v) {
        const SphereTerms a = sphere_terms(s[base + u + v], ox, oy, oz, dy, dz);
        hits |= static_cast<unsigned>(chunk_meets<R>(a, dxr)) << (u + v);
      }
    }
    for (; u < m; ++u) {
      const SphereTerms a = sphere_terms(s[base + u], ox, oy, oz, dy, dz);
      hits |= static_cast<unsigned>(chunk_meets<R>(a, dxr)) << u;
    }
    for (; hits != 0u; hits &= hits - 1u) {
      const int j = base + lowest_bit(hits);
      chunk_roots<kCarry, R>(s[j], j, sphere_terms(s[j], ox, oy, oz, dy, dz),
                             dxr, w);
    }
  }
  L2N_UNROLL
  for (int k = 0; k < R; ++k) {
    if (!kCarry) gather_packed(s, 1, w[k]);
    acc = accumulate_vpu(acc, w[k]);
  }
}

// `count` repeats from r0 in chunks of R, then what is left in chunks of
// R / 2, R / 4, ... 1.
template <bool kCarry, int R>
L2N_HD void sweep_chunks(const Sphere4* s, int n, int r0, int count,
                         float ox, float oy, float oz, float dx, float dy,
                         float dz, float& acc) {
  static_assert(R >= 1, "a chunk holds a repeat");
  for (; count >= R; r0 += R, count -= R)
    sweep_chunk<kCarry, R>(s, n, r0, ox, oy, oz, dx, dy, dz, acc);
  if constexpr (R > 1)
    sweep_chunks<kCarry, R / 2>(s, n, r0, count, ox, oy, oz, dx, dy, dz,
                                acc);
}

// sweep_lane over the packed spheres, chunks of R repeats: each repeat
// still meets the spheres in ascending index and keeps a strictly smaller
// t, so its winner, ties included, is the serial sweep's, and the
// accumulation runs repeat by repeat in order: the same value to the bit.
template <bool kCarry, int R>
L2N_HD float sweep_lane_chunked(const Sphere4* s, int n, int repeats,
                                float ox, float oy, float oz, float dx,
                                float dy, float dz, float bias) {
  float acc = bias;
  sweep_chunks<kCarry, R>(s, n, 0, repeats, ox, oy, oz, dx, dy, dz, acc);
  return acc;
}

}  // namespace l2n_probe
