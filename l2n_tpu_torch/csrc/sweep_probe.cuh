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
// form through `sweep_lane_chunked`: the spheres outside, a chunk of
// repeats inside. `sweep_lane` (serial, repeats outside) is the order both
// are tested against. The tensor-core sweep's pieces (the mma algebra, its
// miss test and exact resolve) close the file.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

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

// ---------------------------------------------------------------------------
// sweep_variants' tensor-core sweep (csrc/sweep_variants.cu sweep_mma): the
// JAX mxu kernel's algebra (benchmarks/sweep_variants.py:170-198), as its
// plain version defines it (probes/sweep_variants.py sweep_mma_plain: the
// two dot products exact and rounded once to float32),
//   c = |o|^2 - (o.c + o.c) + (|c|^2 - r^2),  hb = o.d - c.d,
// then the two roots, a miss mapped to kBig, the lowest index among equal t.
// The kernel takes c.d - o.d on the tensor cores in 3xTF32 (below), rejects
// a (lane, sphere, repeat) whose line provably misses (`mma_threshold`), and
// resolves the rest exactly (`mma_resolve_t`): every repeat's winner is then
// the plain version's, to the bit.
// ---------------------------------------------------------------------------

// A float's bits and back.
L2N_HD uint32_t f32_bits(float x) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(x);
#else
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
#endif
}

L2N_HD float bits_f32(uint32_t u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

// x rounded to TF32 (10 fraction bits), to nearest, ties away from zero
// (cvt.rna.tf32.f32's rounding), as a float whose 13 low fraction bits are
// zero: half of the last kept bit added to the magnitude, then the rest
// cleared (integer operations on the card, where a cvt issues at the
// conversion rate). Infinities and NaN are left as they are.
L2N_HD float tf32_rna(float x) {
  const uint32_t u = f32_bits(x);
  const uint32_t r = (u & 0x7F800000u) != 0x7F800000u ? u + 0x1000u : u;
  return bits_f32(r & 0xFFFFE000u);
}

// The 12 products of one (lane, sphere) pair, 8 for an m16n8k8 and 4 for an
// m16n8k4 mma: x = big + small, big = tf32_rna(x), small = tf32_rna(x -
// big) (x - big is exact in float32), for the direction d and the centre c;
// each component's big.big, big.small and small.big (small.small dropped);
// and o.d in three TF32 parts whose sum is o.d exactly (after two roundings
// to 11 significant bits the rest has at most two), each against -1. Slot
// k of the lane side multiplies slot k of the sphere side:
//   slot  0    1    2    3    4    5    6    7    8    9    10   11
//   lane  dx.b dx.b dx.s od.b od.s od.t dy.b dy.b dy.s dz.b dz.b dz.s
//   sph.  cx.b cx.s cx.b -1   -1   -1   cy.b cy.s cy.b cz.b cz.s cz.b
// so the sum over the slots is c.d - o.d = -hb. A repeat changes slots 0-5
// (dx and o.d) only: the kernel's thread of column q of the m16n8k8's B
// holds lane slots q and q + 4 (one register pair per repeat) and q + 8 of
// the m16n8k4 (the same in every repeat).
constexpr int kMmaSlots = 12;

L2N_HD void mma_lane_slots(float dx, float dy, float dz, float od,
                           float (&s)[kMmaSlots]) {
  const float xb = tf32_rna(dx), xs = tf32_rna(dx - xb);
  const float yb = tf32_rna(dy), ys = tf32_rna(dy - yb);
  const float zb = tf32_rna(dz), zs = tf32_rna(dz - zb);
  const float ob = tf32_rna(od), os = tf32_rna(od - ob);
  const float ot = (od - ob) - os;
  const float v[kMmaSlots] = {xb, xb, xs, ob, os, ot, yb, yb, ys, zb, zb, zs};
  for (int k = 0; k < kMmaSlots; ++k) s[k] = v[k];
}

L2N_HD void mma_sphere_slots(float cx, float cy, float cz,
                             float (&s)[kMmaSlots]) {
  const float xb = tf32_rna(cx), xs = tf32_rna(cx - xb);
  const float yb = tf32_rna(cy), ys = tf32_rna(cy - yb);
  const float zb = tf32_rna(cz), zs = tf32_rna(cz - zb);
  const float v[kMmaSlots] = {xb, xs, xb, -1.0f, -1.0f, -1.0f, yb, ys, yb,
                              zb, zs, zb};
  for (int k = 0; k < kMmaSlots; ++k) s[k] = v[k];
}

// The exact dot product of float32 vectors rounded once to float32, in the
// plain version's order: ((cx x + cy y) + cz z) in float64 (the products
// are exact there, so the fused form rounds the same), then to float32.
L2N_HD float exact_dot(double cx, double cy, double cz, double x, double y,
                       double z) {
#if defined(__CUDA_ARCH__)
  return __double2float_rn(__fma_rn(cz, z, __fma_rn(cy, y, cx * x)));
#else
  return static_cast<float>((cx * x + cy * y) + cz * z);
#endif
}

// A sphere as the kernel reads it: the centre, |c|^2 - r^2 (cmat row 4),
// r^2 (row 3, which the accumulation gathers with cx), |cx| + |cy| + |cz|
// and the |c|^2 - r^2 term of the c margin (`mma_pair_c_lower`).
struct alignas(16) MmaSphere {
  float cx, cy, cz, ccr, r2, c1, cm, pad;
};

// The miss test's margin. Write S_d = sum_k |c_k| |d_k| and D for the
// tensor cores' sum over the 12 slots, which approximates c.d - o.d, with
// od = o.d as the plain version rounds it. Its error, against cd - od, cd =
// c.d exact rounded to float32 as the plain version takes it:
//   * the dropped products: x - big - small is at most 2^-22 |x| (two
//     roundings to 11 significant bits), |big| <= (1 + 2^-11) |x|, |small|
//     <= 2^-11 (1 + 2^-11) |x|, so small.small, big.(c - big - small),
//     small.(c - ...) and (d - big - small).c together are at most
//     3.01 2^-22 S_d = 6.02 2^-23 S_d; od's three parts are exact;
//   * the tensor cores: TF32 x TF32 products are exact in float32; an
//     mma.sync sums its k products and C in an unspecified order, possibly
//     truncating: model it as off by at most 2^-23 times the sum of the
//     magnitudes it adds for each term it adds (C and the k products) and
//     once more for its result, k + 2 units. The m16n8k8 (C = 0) and the
//     m16n8k4 (C = the m16n8k8's sum) then err by at most 16.01 2^-23
//     (1.002 S_d + 1.001 |od|);
//   * cd itself: float64 sums of exact products, rounded to float32, is
//     within 0.51 2^-23 S_d of c.d.
// So |D - (cd - od)| <= E = 2^-23 (22.57 S_d + 16.02 |od|). The kernel uses
// four times E, rounded up: kMmaDirMargin and kMmaOdMargin are 92 and 68
// units of 2^-23, taken on bounds of S_d (|c|_1 times the lane's largest
// |d_k| over every repeat) and |od| (sum_k |o_k| |d_k|, likewise);
// kMmaAbsMargin covers flushed subnormals.
//
// The threshold takes c from o.c summed in float32 (`mma_pair_c_lower`),
// not from the exact o.c the plain version rounds once (the resolve
// computes that): with S_o = sum_k |c_k| |o_k| and u = 2^-24, the two o.c
// differ by at most 4.02 u S_o (three float32 roundings against one
// float64 sum rounded to float32), so the two c = (|o|^2 - (oc + oc)) +
// (|c|^2 - r^2) by at most u (16.13 S_o + 4.02 |o|^2 + 2 ||c|^2 - r^2|)
// (the doubled difference, and both sides' two roundings). The threshold
// uses c less four times that, rounded up (kMmaSoMargin, kMmaOoMargin,
// kMmaCcrMargin: 65, 17 and 8 units of u, S_o bounded by |c|_1 max_k
// |o_k|), which also covers the subtraction's own rounding: never more
// than the plain version's c.
constexpr float kMmaDirMargin = 23.0f * 0x1p-21f;
constexpr float kMmaOdMargin = 17.0f * 0x1p-21f;
constexpr float kMmaAbsMargin = 1e-30f;
constexpr float kMmaSoMargin = 65.0f * 0x1p-24f;
constexpr float kMmaOoMargin = 17.0f * 0x1p-24f;
constexpr float kMmaCcrMargin = 8.0f * 0x1p-24f;
// sqrt(c) from rsqrt (2 ulp: 2^-22 relative) shrunk by 2^-18.
constexpr float kMmaSqrtShrink = 1.0f - 0x1p-18f;
constexpr float kMmaTinyC = 1e-30f;

L2N_HD MmaSphere mma_sphere(float cx, float cy, float cz, float r2,
                            float ccr) {
  return MmaSphere{cx,  cy, cz, ccr, r2, (fabsf(cx) + fabsf(cy)) + fabsf(cz),
                   kMmaCcrMargin * fabsf(ccr), 0.0f};
}

// 1 / sqrt(c) for a normal c, within 2^-22 (the card's rsqrt.approx: one
// MUFU.RSQ, no subnormal scaling).
L2N_HD float mma_rsqrt(float c) {
#if defined(__CUDA_ARCH__)
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(c));
  return r;
#else
  return 1.0f / sqrtf(c);
#endif
}

// What one lane's pairs share across the repeats: o, |o|^2 as the plain
// version rounds it, and the lane's terms of the margins: of D (per unit
// of |c|_1, and the o.d term) for every repeat up to `scale_max`
// (perturb_scale of the last repeat: dx grows with the repeat), and of c
// (per unit of |c|_1, and the |o|^2 term).
struct MmaLane {
  float ox, oy, oz, oo, md, mo, mc, mcoo;
};

L2N_HD MmaLane mma_lane(float ox, float oy, float oz, float dx, float dy,
                        float dz, float scale_max) {
  const float dxm = fabsf(dx) * scale_max, ady = fabsf(dy), adz = fabsf(dz);
  const float dinf = fmaxf(dxm, fmaxf(ady, adz));
  const float sod = (fabsf(ox) * dxm + fabsf(oy) * ady) + fabsf(oz) * adz;
  const float oinf = fmaxf(fabsf(ox), fmaxf(fabsf(oy), fabsf(oz)));
  const float oo = (ox * ox + oy * oy) + oz * oz;
  return MmaLane{ox,
                 oy,
                 oz,
                 oo,
                 kMmaDirMargin * dinf,
                 kMmaOdMargin * sod + kMmaAbsMargin,
                 kMmaSoMargin * oinf,
                 kMmaOoMargin * oo};
}

// A lower bound of the plain version's c of a pair, from o.c summed in
// float32 (see the margin above).
L2N_HD float mma_pair_c_lower(const MmaLane& l, const MmaSphere& s) {
  const float oc = (s.cx * l.ox + s.cy * l.oy) + s.cz * l.oz;
  const float c = (l.oo - (oc + oc)) + s.ccr;
  return c - fmaf(s.c1, l.mc, l.mcoo + s.cm);
}

// The plain version's c of a pair: o.c exact rounded once, then
// (|o|^2 - (oc + oc)) + (|c|^2 - r^2).
L2N_HD float mma_pair_c(float ox, float oy, float oz, const MmaSphere& s) {
  const float oc = exact_dot(s.cx, s.cy, s.cz, ox, oy, oz);
  return ((ox * ox + oy * oy) + oz * oz - (oc + oc)) + s.ccr;
}

// The pair's miss threshold T from c, at most the plain version's c: where
// |D| < T the plain version's discriminant is negative in every repeat, so
// its t is kBig. Proof: T = fl(sq shrink - delta), delta >= 4 E (above), sq
// = c rsqrt(c) <= sqrt(c) (1 + 2^-22)(1 + 2^-24), so T <= sqrt(c) (1 -
// 2^-20) - delta, and the plain version's c is larger. Then |D| < T
// gives |od - cd| < |D| + E < sqrt(c) (1 - 2^-20), hb = fl(od - cd) within
// (1 + 2^-24) of it, fl(hb hb) <= hb^2 (1 + 2^-24) < c, and hb hb - c < 0
// (the difference of two unequal floats is never zero). c <= kMmaTinyC, or
// NaN, gives T = -1: no pair is rejected; |D| NaN is never rejected either.
L2N_HD float mma_threshold(float c, float c1, const MmaLane& l) {
  const bool real = c > kMmaTinyC;
  const float cr = real ? c : 1.0f;
  const float t =
      fmaf(cr * mma_rsqrt(cr), kMmaSqrtShrink, -fmaf(c1, l.md, l.mo));
  return real ? t : -1.0f;
}

// The exact (lane, sphere) candidate of one repeat, the plain version's t
// to the bit: c and od as it rounds them, cd exact rounded once, hb = od -
// cd, and the two roots with the square root taken only on a real
// discriminant.
L2N_HD float mma_resolve_t(float ox, float oy, float oz, float dx, float dy,
                           float dz, const MmaSphere& s) {
  const float od = ox * dx + oy * dy + oz * dz;
  const float cd = exact_dot(s.cx, s.cy, s.cz, dx, dy, dz);
  return two_root_guarded(od - cd, mma_pair_c(ox, oy, oz, s));
}

// A repeat's winner as one 64-bit key that orders as the plain version
// picks: the smaller t, then the smaller index (t in [0, kBig); -0.0 orders
// as 0.0 and keeps its sign in the low bit). kMmaNoHit: no candidate.
constexpr uint64_t kMmaNoHit = ~0ull;

L2N_HD uint64_t mma_key(float t, int j) {
  const uint32_t u = f32_bits(t);
  return (static_cast<uint64_t>(u & 0x7FFFFFFFu) << 32) |
         (static_cast<uint64_t>(j) << 1) | (u >> 31);
}

// The winner of a key, with the attributes the accumulation reads (cx and
// r^2 of sphere j of `s`), or the miss values.
L2N_HD Winner mma_winner(uint64_t key, const MmaSphere* s) {
  if (key == kMmaNoHit) return Winner{kBig, -1, 0.0f, 0.0f, 0.0f, 0.0f};
  const uint32_t lo = static_cast<uint32_t>(key);
  const float t = bits_f32(static_cast<uint32_t>(key >> 32) | (lo << 31));
  const int j = static_cast<int>(lo >> 1);
  return Winner{t, j, s[j].cx, 0.0f, 0.0f, s[j].r2};
}

// One repeat's term of the mma sweep's accumulation (benchmarks/
// sweep_variants.py:192-193), summed before it is added to the lane's
// acc: t (0 on a miss) + cx 1e-6 + r2 1e-9 + index 1e-3.
L2N_HD float mma_row(const Winner& w) {
  return (w.t < kBig ? w.t : 0.0f) + w.cx * 1e-6f + w.r2 * 1e-9f +
         static_cast<float>(w.i) * 1e-3f;
}

}  // namespace l2n_probe
