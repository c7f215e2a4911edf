// The sphere-sweep formulations probe for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernels of benchmarks/sweep_variants.py: `_kernel_vpu`
// (:83), `_kernel_vpu2` (:101) and `_kernel_mxu` (:138), pallas_call at
// :207. Each runs R repeats of a nearest-hit sweep over n spheres for every
// lane of (blocks, 32, 128) rays, the direction's x scaled by 1 + 1e-4 r in
// repeat r, and accumulates t, the winner's cx and r2 and its index into
// `out`, starting from `bias`:
//   * sweep_vpu: the production sweep, the winner's attributes carried
//     with it (selected at every update of the winner);
//   * sweep_vpu2: (t, index) only, the attributes read afterwards. The TPU
//     has no gather and recovered them with a one-hot sum; here it is one
//     shared-memory load, and the result is bit-equal to sweep_vpu;
//   * sweep_mma: the JAX mxu kernel's algebra (c = |o|^2 - (o.c + o.c) +
//     (|c|^2 - r^2), hb = o.d - c.d, the two roots, the lowest index among
//     equal t) with its dot products on the tensor cores; it differs from
//     sweep_vpu by design, and equals its plain version, whose dot products
//     are exact and rounded once, to the bit.
//
// What bounds them on this card: instruction issue, not memory (32 bytes per
// lane read and written once for all R x n candidates). A lane-candidate of
// the scalar pair whose line misses the sphere needs 6 operations (hb on
// the products roy dy and roz dz, which the repeats share as they perturb
// dx only; the discriminant; its test), one of the mma algebra 4 (hb, its
// square, the discriminant, its test); the sqrt, the roots and the update
// only where the line meets (0.34% of the probe's candidates); o - c and c
// once per (lane, sphere), not once per repeat. Design:
//   * vpu / vpu2: one thread per lane, the spheres staged once per block
//     into shared memory as 16-byte records (every thread of a warp reads
//     the same sphere, a broadcast); the spheres outside and a chunk of
//     kChunk repeats inside (csrc/sweep_probe.cuh `sweep_lane_chunked`,
//     the body shared with the CPU tests), each repeat's winner in
//     registers. Per block of 32 spheres, pass 1 only tests whether the
//     lane's line meets each sphere in a repeat of the chunk and marks it
//     in a 32-bit mask; pass 2 runs the roots (and sqrtf) for the marked
//     spheres, lowest index first. So no negative discriminant reaches
//     sqrtf's slow path, and pass 2 holds a warp for as many rounds as its
//     lane with the most marked spheres (about one in ten (warp, sphere,
//     chunk) has one); a vote per (sphere, chunk) or a branch per
//     candidate were slower (PERF.md). __launch_bounds__ keeps 4 blocks
//     (1,024 threads) per SM with no spill;
//   * mma: c and the pair's miss threshold T depend on the lane's origin
//     alone, so they are taken once per (lane, sphere) (sweep_probe.cuh
//     `mma_threshold`, from o.c summed in float32 with a bounded error).
//     Per repeat only c.d - o.d comes from the tensor cores, in 3xTF32
//     (`mma_lane_slots`: each float32 split into two TF32 parts, small x
//     small dropped, and o.d carried in three exact parts against -1): an
//     m16n8k8 and an m16n8k4 mma.sync, fp32 accumulators, one warp per 8
//     lanes x 16 spheres. A miss then costs one compare per (lane, sphere,
//     repeat), |D| < T, with no conversion and no square root: T has a
//     proven margin (4x the bound on the TF32 split, the unspecified-order,
//     possibly truncating fp32 accumulation, the float32 o.c and the plain
//     version's roundings), so a rejected candidate has a negative
//     discriminant in the plain version's own arithmetic. Each pair's test
//     is OR-ed over the 16 repeats of a chunk; pairs that pass (0.36% of
//     the probe's) go to a per-warp queue, and the warp resolves them 32
//     (pair, repeat) candidates a round: c and the dot products exact in
//     float64 in the plain version's order, then the roots with sqrtf only
//     on a real discriminant (`mma_resolve_t`, the kernel's one sqrtf
//     site), the winner kept as a 64-bit (t, index) key by a shared-memory
//     atomicMin (the tie rule is the key's order). The winners' attributes
//     are read afterwards, one load each. The spheres sit in shared memory
//     as each thread's A fragments (16 per tile; n = 8 mod 16 pads a tile
//     with rows whose T is +inf), staged once per block of a persistent
//     grid, so the miss path reads no shared memory per pair; a repeat's
//     two m16n8k8 B values sit in one register pair, the m16n8k4's is the
//     same in every repeat. No wgmma or TMA: 262,144 lanes x 3 floats are
//     not a matrix-shaped load, and mma.sync leaves the tensor pipe idle
//     most of the time (PERF.md: timing the kernel with its mma replaced by
//     fp32 multiplies moved nothing).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_probe.cuh"

namespace {

using l2n_probe::kBig;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks per SM that __launch_bounds__ asks room for (at most 64 registers
// a thread), and the repeats per chunk of each scalar kernel (measured on
// the card, PERF.md): the carry holds 4 values a repeat (t, index, cx,
// r2), vpu2 2, and at 8 repeats a chunk the carry no longer fits 64
// registers without a spill.
constexpr int kMinBlocks = 4;
constexpr int kChunkVpu = 4;
constexpr int kChunkVpu2 = 8;

// sweep_vpu (kCarry) / sweep_vpu2: one thread per lane, R repeats a chunk.
template <bool kCarry, int R>
__device__ __forceinline__ void sweep_vpu_body(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ cz, const float* __restrict__ r2, int n,
    int lanes, int repeats, const float* __restrict__ bias,
    float* __restrict__ out) {
  extern __shared__ l2n_probe::Sphere4 packed[];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < lanes;
  // The ray's loads are issued before the barrier, beside the staging.
  float ray[6] = {}, b = 0.0f;
  if (live) {
    for (int k = 0; k < 3; ++k) {
      ray[k] = o[k * lanes + p];
      ray[3 + k] = d[k * lanes + p];
    }
    b = bias[p];
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    packed[j] = l2n_probe::Sphere4{cx[j], cy[j], cz[j], r2[j]};
  __syncthreads();
  if (!live) return;
  out[p] = l2n_probe::sweep_lane_chunked<kCarry, R>(
      packed, n, repeats, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], b);
}

// One kernel name per variant, so that a profile tells them apart.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sweep_vpu_kernel(const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ cx,
                     const float* __restrict__ cy,
                     const float* __restrict__ cz,
                     const float* __restrict__ r2, int n,
                     int lanes, int repeats,
                     const float* __restrict__ bias,
                     float* __restrict__ out) {
  sweep_vpu_body<true, kChunkVpu>(o, d, cx, cy, cz, r2, n, lanes, repeats,
                                  bias, out);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sweep_vpu2_kernel(const float* __restrict__ o,
                      const float* __restrict__ d,
                      const float* __restrict__ cx,
                      const float* __restrict__ cy,
                      const float* __restrict__ cz,
                      const float* __restrict__ r2, int n,
                      int lanes, int repeats,
                      const float* __restrict__ bias,
                      float* __restrict__ out) {
  sweep_vpu_body<false, kChunkVpu2>(o, d, cx, cy, cz, r2, n, lanes, repeats,
                                    bias, out);
}

// ---------------------------------------------------------------------------
// sweep_mma
// ---------------------------------------------------------------------------

constexpr int kMmaLanes = 8;    // lanes per warp tile: the mma's N
constexpr int kMmaRows = 16;    // spheres per sphere tile: the mma's M
constexpr int kMmaChunk = 16;   // repeats per chunk
constexpr int kMmaFlush = 32 / kMmaChunk;  // queued pairs a resolve round takes
constexpr int kMmaQueue = kMmaFlush - 1 + 4 * 32;
constexpr int kMmaMinBlocks = 2;
// Blocks per SM of the grid: each warp walks lane tiles until they run out,
// so the spheres are staged once per block.
constexpr int kMmaGridPerSm = 2;

// A warp's shared memory: the B values of each repeat of the chunk, (b0,
// m16n8k4 b0) per thread (the rows of the accumulation after the sweep),
// each (lane, repeat)'s winner key, the queue of pairs to resolve (sphere
// << 3 | lane), and the tile's rays (o, d).
struct MmaWarp {
  float2 bx[kMmaChunk * 32];
  unsigned long long win[kMmaLanes * kMmaChunk];
  unsigned queue[kMmaQueue];
  float ray[kMmaLanes][8];
};

size_t mma_smem(int n) {
  const size_t tiles = static_cast<size_t>((n + kMmaRows - 1) / kMmaRows);
  return tiles * 32 * (sizeof(float4) + sizeof(float2)) +
         tiles * kMmaRows * sizeof(l2n_probe::MmaSphere) +
         kWarps * sizeof(MmaWarp);
}

int mma_grid(int lanes) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = (lanes / kMmaLanes + kWarps - 1) / kWarps;
  return blocks < kMmaGridPerSm * sms ? blocks : kMmaGridPerSm * sms;
}

// D (16x8) = A (16x8 TF32, row) . B (8x8 TF32, col), C = 0. Thread (g, q)
// = (lane / 4, lane % 4) holds A[g][q], A[g+8][q], A[g][q+4], A[g+8][q+4]
// (a), B[q][g], B[q+4][g] (b) and D[g][2q], D[g][2q+1], D[g+8][2q],
// D[g+8][2q+1].
__device__ __forceinline__ void mma_k8(float (&acc)[4], const float4& a,
                                       const float2& b) {
  const float z = 0.0f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(acc[0]), "=f"(acc[1]), "=f"(acc[2]), "=f"(acc[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)),
        "r"(__float_as_uint(a.z)), "r"(__float_as_uint(a.w)),
        "r"(__float_as_uint(b.x)), "r"(__float_as_uint(b.y)), "f"(z), "f"(z),
        "f"(z), "f"(z));
}

// D += A (16x4 TF32) . B (4x8 TF32): thread (g, q) holds A[g][q],
// A[g+8][q] (a) and B[q][g] (b).
__device__ __forceinline__ void mma_k4(float (&acc)[4], const float2& a,
                                       float b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)),
        "r"(__float_as_uint(b)));
}

// Slot q, q + 4 or q + 8 of a slot vector, by selects (no local memory).
__device__ __forceinline__ float slot_of(const float (&s)[l2n_probe::kMmaSlots],
                                         int base, int q) {
  return q == 0 ? s[base] : q == 1 ? s[base + 1] : q == 2 ? s[base + 2]
                                                          : s[base + 3];
}

// sweep_mma: one warp per tile of 8 lanes, the spheres in tiles of 16 (the
// last padded with rows that never pass), the repeats in chunks of 16 (a
// shorter chunk's missing repeats made inert). cmat: (8, n) rows cx, cy,
// cz, r2, |c|^2 - r^2 (rows 5-7 unused). `index` (repeats, lanes) int32 or
// null: each repeat's winner. `stats` null, or 4 counters the warps add
// to: pairs the miss test passed, resolved candidates, resolve rounds, and
// (warp tile, chunk)s.
__global__ void __launch_bounds__(kThreads, kMmaMinBlocks)
    sweep_mma_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ cmat, int n, int lanes,
                     int repeats, const float* __restrict__ bias,
                     float* __restrict__ out, int32_t* __restrict__ index,
                     unsigned long long* __restrict__ stats) {
  using l2n_probe::kMmaSlots;
  using l2n_probe::MmaLane;
  using l2n_probe::MmaSphere;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = (n + kMmaRows - 1) / kMmaRows;
  float4* a8 = reinterpret_cast<float4*>(smem);
  float2* a4 = reinterpret_cast<float2*>(a8 + tiles * 32);
  MmaSphere* sph = reinterpret_cast<MmaSphere*>(a4 + tiles * 32);
  MmaWarp& w =
      reinterpret_cast<MmaWarp*>(sph + tiles * kMmaRows)[threadIdx.x >> 5];
  // Each thread's A fragments of every sphere tile, and the spheres as the
  // pairs' setup, the resolve and the gather read them; padding rows zero.
  for (int e = threadIdx.x; e < tiles * 32; e += blockDim.x) {
    const int row = (e >> 5) * kMmaRows + ((e & 31) >> 2), q = e & 3;
    float s0[kMmaSlots] = {}, s1[kMmaSlots] = {};
    if (row < n)
      l2n_probe::mma_sphere_slots(cmat[row], cmat[n + row],
                                  cmat[2 * n + row], s0);
    if (row + 8 < n)
      l2n_probe::mma_sphere_slots(cmat[row + 8], cmat[n + row + 8],
                                  cmat[2 * n + row + 8], s1);
    a8[e] = make_float4(slot_of(s0, 0, q), slot_of(s1, 0, q),
                        slot_of(s0, 4, q), slot_of(s1, 4, q));
    a4[e] = make_float2(slot_of(s0, 8, q), slot_of(s1, 8, q));
  }
  for (int j = threadIdx.x; j < tiles * kMmaRows; j += blockDim.x)
    sph[j] = j < n ? l2n_probe::mma_sphere(cmat[j], cmat[n + j],
                                           cmat[2 * n + j], cmat[3 * n + j],
                                           cmat[4 * n + j])
                   : MmaSphere{};
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float inf = __int_as_float(0x7f800000);
  unsigned long long passed = 0, items = 0, rounds = 0, chunks = 0;
  for (int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
       tile < lanes / kMmaLanes; tile += gridDim.x * kWarps) {
    const int p0 = tile * kMmaLanes;
    float acc = 0.0f;
    if (lane < kMmaLanes) {
      for (int k = 0; k < 3; ++k) {
        w.ray[lane][k] = o[k * lanes + p0 + lane];
        w.ray[lane][3 + k] = d[k * lanes + p0 + lane];
      }
      acc = bias[p0 + lane];
    }
    for (int e = lane; e < kMmaLanes * kMmaChunk; e += 32)
      w.win[e] = l2n_probe::kMmaNoHit;
    __syncwarp();
    // Lane g's B column: its constant m16n8k4 slot, and what od takes from
    // it (oy dy and oz dz as od rounds them; only dx moves between
    // repeats).
    const float* rg = w.ray[g];
    float cs[kMmaSlots];
    l2n_probe::mma_lane_slots(rg[3], rg[4], rg[5], 0.0f, cs);
    const float b4 = slot_of(cs, 8, q);
    const float gox = rg[0], gdx = rg[3], gpy = rg[1] * rg[4],
                gpz = rg[2] * rg[5];
    // Lanes 2q and 2q + 1, this thread's D columns.
    const float scale_max = l2n_probe::perturb_scale(repeats > 0 ? repeats - 1
                                                                 : 0);
    const float* r0p = w.ray[2 * q];
    const float* r1p = w.ray[2 * q + 1];
    const MmaLane l0 = l2n_probe::mma_lane(r0p[0], r0p[1], r0p[2], r0p[3],
                                           r0p[4], r0p[5], scale_max);
    const MmaLane l1 = l2n_probe::mma_lane(r1p[0], r1p[1], r1p[2], r1p[3],
                                           r1p[4], r1p[5], scale_max);

    for (int r0 = 0; r0 < repeats; r0 += kMmaChunk) {
      const int rc = min(kMmaChunk, repeats - r0);
      // The chunk's m16n8k8 B values of lane g (slots q and q + 4), repeats
      // q, q + 4, ... for the four threads of its column. A repeat past the
      // chunk's end gets zeros: its D is 0, which every pair with a positive
      // T rejects (the others pass in every repeat).
      for (int k = q; k < kMmaChunk; k += 4) {
        float s[kMmaSlots] = {};
        if (k < rc) {
          const float dx = gdx * l2n_probe::perturb_scale(r0 + k);
          l2n_probe::mma_lane_slots(dx, rg[4], rg[5], gox * dx + gpy + gpz, s);
        }
        float2* v = w.bx + k * 32 + g * 4;
        v[0] = make_float2(s[0], s[4]);
        v[1] = make_float2(s[1], s[5]);
        v[2] = make_float2(s[2], s[6]);
        v[3] = make_float2(s[3], s[7]);
      }
      __syncwarp();
      float2 bk[kMmaChunk];
#pragma unroll
      for (int k = 0; k < kMmaChunk; ++k) bk[k] = w.bx[k * 32 + lane];
      __syncwarp();

      // Per sphere tile: the pairs' T once, then the repeats on the tensor
      // cores; a pair passes where some repeat's |D| < T fails (NaN
      // included). The pairs that pass are queued and resolved, a round of
      // 32 (pair, repeat) candidates at a time, and after the last tile.
      int qn = 0;
      for (int st = 0; st <= tiles; ++st) {
        if (st < tiles) {
          const float4 fa = a8[st * 32 + lane];
          const float2 fb = a4[st * 32 + lane];
          const int ja = st * kMmaRows + g, jb = ja + 8;
          const MmaSphere sa = sph[ja], sb = sph[jb];
          const float c[4] = {l2n_probe::mma_pair_c_lower(l0, sa),
                              l2n_probe::mma_pair_c_lower(l1, sa),
                              l2n_probe::mma_pair_c_lower(l0, sb),
                              l2n_probe::mma_pair_c_lower(l1, sb)};
          const float t[4] = {
              ja < n ? l2n_probe::mma_threshold(c[0], sa.c1, l0) : inf,
              ja < n ? l2n_probe::mma_threshold(c[1], sa.c1, l1) : inf,
              jb < n ? l2n_probe::mma_threshold(c[2], sb.c1, l0) : inf,
              jb < n ? l2n_probe::mma_threshold(c[3], sb.c1, l1) : inf};
          bool pass[4] = {false, false, false, false};
#pragma unroll
          for (int k = 0; k < kMmaChunk; ++k) {
            float dd[4];
            mma_k8(dd, fa, bk[k]);
            mma_k4(dd, fb, b4);
#pragma unroll
            for (int i = 0; i < 4; ++i) pass[i] |= !(fabsf(dd[i]) < t[i]);
          }
          if (__any_sync(0xffffffffu, pass[0] | pass[1] | pass[2] | pass[3])) {
            const unsigned below = (1u << lane) - 1u;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const unsigned m = __ballot_sync(0xffffffffu, pass[i]);
              if (pass[i])
                w.queue[qn + __popc(m & below)] = static_cast<unsigned>(
                    ((i < 2 ? ja : jb) << 3) | (2 * q) | (i & 1));
              qn += __popc(m);
              passed += __popc(m);
            }
          }
        }
        if (qn >= kMmaFlush || (st == tiles && qn > 0)) {
          __syncwarp();
          const int count = qn * kMmaChunk;
          for (int it = lane; it < count; it += 32) {
            const int k = it & (kMmaChunk - 1);
            const unsigned e = w.queue[it / kMmaChunk];
            const int l = e & 7, j = static_cast<int>(e >> 3);
            if (k < rc && j < n) {
              const float* ry = w.ray[l];
              const float tk = l2n_probe::mma_resolve_t(
                  ry[0], ry[1], ry[2], ry[3] * l2n_probe::perturb_scale(r0 + k),
                  ry[4], ry[5], sph[j]);
              if (tk < kBig)
                atomicMin(&w.win[l * kMmaChunk + k], l2n_probe::mma_key(tk, j));
            }
          }
          items += static_cast<unsigned long long>(qn) * rc;
          rounds += (count + 31) / 32;
          qn = 0;
          __syncwarp();
        }
      }

      // Each (lane, repeat)'s row, then each lane's accumulation in order.
      float* rows = reinterpret_cast<float*>(w.bx);
      for (int e = lane; e < kMmaLanes * kMmaChunk; e += 32) {
        const int l = e & 7, k = e >> 3;
        if (k < rc) {
          unsigned long long& key = w.win[l * kMmaChunk + k];
          const l2n_probe::Winner win = l2n_probe::mma_winner(key, sph);
          key = l2n_probe::kMmaNoHit;
          rows[l * kMmaChunk + k] = l2n_probe::mma_row(win);
          if (index != nullptr)
            index[static_cast<size_t>(r0 + k) * lanes + p0 + l] = win.i;
        }
      }
      __syncwarp();
      if (lane < kMmaLanes)
        for (int k = 0; k < rc; ++k) acc = acc + rows[lane * kMmaChunk + k];
      ++chunks;
      __syncwarp();
    }
    if (lane < kMmaLanes) out[p0 + lane] = acc;
    __syncwarp();  // the next tile rewrites the rays
  }
  if (stats != nullptr && lane == 0) {
    atomicAdd(stats, passed);
    atomicAdd(stats + 1, items);
    atomicAdd(stats + 2, rounds);
    atomicAdd(stats + 3, chunks);
  }
}

// Lets sweep_mma_kernel take `bytes` of dynamic shared memory (above the
// default 48 KB).
int mma_prepare(size_t bytes) {
  static size_t allowed = 0;
  if (bytes <= allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      sweep_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return static_cast<int>(err);
}

int vpu_grid(int lanes) { return (lanes + kThreads - 1) / kThreads; }

size_t vpu_smem(int n) {
  return sizeof(l2n_probe::Sphere4) * static_cast<size_t>(n);
}

template <bool kCarry>
int launch_vpu(const float* o, const float* d, const float* cx,
               const float* cy, const float* cz, const float* r2, int n,
               int lanes, int repeats, const float* bias, float* out,
               void* stream) {
  const dim3 grid(static_cast<unsigned>(vpu_grid(lanes)));
  const size_t smem = vpu_smem(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kCarry) {
    sweep_vpu_kernel<<<grid, kThreads, smem, s>>>(o, d, cx, cy, cz, r2, n,
                                                  lanes, repeats, bias, out);
  } else {
    sweep_vpu2_kernel<<<grid, kThreads, smem, s>>>(o, d, cx, cy, cz, r2, n,
                                                   lanes, repeats, bias, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o, d: (3, lanes) float32; cx, cy, cz, r2: (n,) float32; bias, out:
// (lanes,) float32; all device pointers. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int l2n_sweep_vpu(const float* o, const float* d, const float* cx,
                             const float* cy, const float* cz,
                             const float* r2, int n, int lanes, int repeats,
                             const float* bias, float* out, void* stream) {
  return launch_vpu<true>(o, d, cx, cy, cz, r2, n, lanes, repeats, bias, out,
                          stream);
}

extern "C" int l2n_sweep_vpu2(const float* o, const float* d, const float* cx,
                              const float* cy, const float* cz,
                              const float* r2, int n, int lanes, int repeats,
                              const float* bias, float* out, void* stream) {
  return launch_vpu<false>(o, d, cx, cy, cz, r2, n, lanes, repeats, bias,
                           out, stream);
}

// The launch shape of sweep_vpu2 (kind 0), sweep_vpu (1) or sweep_mma (2)
// at `lanes` lanes and n spheres into shape[0..3]: repeats per chunk,
// threads per block, blocks, and the blocks an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns the first CUDA
// error (0 on success).
extern "C" int l2n_sweep_shape(int kind, int lanes, int n, int* shape) {
  shape[1] = kThreads;
  if (kind == 2) {
    shape[0] = kMmaChunk;
    shape[2] = mma_grid(lanes);
    const int rc = mma_prepare(mma_smem(n));
    if (rc != 0) return rc;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &shape[3], sweep_mma_kernel, kThreads, mma_smem(n)));
  }
  shape[0] = kind == 1 ? kChunkVpu : kChunkVpu2;
  shape[2] = vpu_grid(lanes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &shape[3], kind == 1 ? sweep_vpu_kernel : sweep_vpu2_kernel, kThreads,
      vpu_smem(n)));
}

// o, d: (3, lanes); cmat: (8, n), n a multiple of 8; bias, out: (lanes,),
// lanes a multiple of 8; index: (repeats, lanes) int32 or null; stats: 4
// uint64 counters or null.
extern "C" int l2n_sweep_mma(const float* o, const float* d, const float* cmat,
                             int n, int lanes, int repeats, const float* bias,
                             float* out, int32_t* index,
                             unsigned long long* stats, void* stream) {
  const size_t smem = mma_smem(n);
  const int rc = mma_prepare(smem);
  if (rc != 0) return rc;
  sweep_mma_kernel<<<mma_grid(lanes), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      o, d, cmat, n, lanes, repeats, bias, out, index, stats);
  return static_cast<int>(cudaGetLastError());
}
