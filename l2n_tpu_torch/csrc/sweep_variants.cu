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
//   * sweep_mma: the dot products o.c and d.c of every (lane, sphere) pair
//     on the tensor cores, the roots in an fp32 epilogue over (lane,
//     sphere), then a min over spheres (the lowest index among ties) and a
//     gather. Its algebra is the JAX kernel's (c = |o|^2 - (o.c + o.c) +
//     (|c|^2 - r^2), hb = o.d - c.d), not the scalar sweep's, so it differs
//     from sweep_vpu by design.
//
// What bounds them on this card: fp32 issue, not memory (32 bytes per lane
// read and written once for all R x n candidates). A lane-candidate whose
// line misses the sphere needs 6 operations (hb on the products roy dy and
// roz dz, which the repeats share as they perturb dx only; the
// discriminant; its test); the sqrt, the roots and the update only where
// it meets (0.34% of the probe's candidates); o - c and c once per (lane,
// sphere), not once per repeat. Design:
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
//   * mma: one warp per 8 lanes. mma.sync m8n8k4 in FP64 (DMMA): A is the
//     8 lanes' (x, y, z, 0) as doubles, B the (x, y, z, 0) of 8 spheres
//     from shared memory, so K = 4 holds the three components with one
//     zero and no padding instruction. Products of fp32 inputs are exact in
//     fp64, so each dot product is the exact one rounded to fp32 (the fp64
//     sum's own rounding moves that only in a tie of the fp32 rounding),
//     which is what the plain version computes. Summed in fp32, the dot
//     products would move the roots of grazing rays beyond the probe's
//     gate. The other fp32-input route, 3xTF32 m16n8k8 (each
//     f32 split into big and small TF32 parts), needs three mma per product
//     and drops the small x small term; FP64 is exact and simpler, and its
//     rate (67 TFLOP/s) is not what bounds this kernel: the epilogue's
//     ~20 fp32 operations per pair are. Each thread holds 2 (lane, sphere)
//     results per instruction pair; the min over spheres is in-thread over
//     its 32 spheres, then two shuffles across the 4 threads of a lane.
//     No wgmma or TMA here (a later redesign).

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

// D (8x8, f64) = A (8x4, row) . B (4x8, col). Thread `lane` holds
// A[lane / 4][lane % 4], B[lane % 4][lane / 4] and D[lane / 4][2 (lane % 4)
// + {0, 1}].
__device__ __forceinline__ void dmma_8x8x4(double& d0, double& d1, double a,
                                           double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%4, %5};\n"
      : "=d"(d0), "=d"(d1)
      : "d"(a), "d"(b), "d"(0.0), "d"(0.0));
}

// One (lane, sphere) root of the mma algebra (benchmarks/sweep_variants.py:
// 176-182), its dot products already rounded to fp32.
__device__ __forceinline__ float mma_t(float oo, float od, float oc, float cd,
                                       float ccr) {
  const float c = oo - (oc + oc) + ccr;
  const float hb = od - cd;
  const float sq = sqrtf(hb * hb - c);
  const float t1 = -hb - sq;
  const float t2 = -hb + sq;
  const float t = t1 >= 0.0f ? t1 : t2;
  return t >= 0.0f ? t : kBig;
}

// sweep_mma: one warp per 8 lanes, grid-stride over the lanes' 8-tiles.
// cmat: (8, n) rows cx, cy, cz, r2, |c|^2 - r^2 (rows 5-7 unused); n a
// multiple of 8. `index` (R, lanes) int32, or null: each repeat's winner.
__global__ void sweep_mma_kernel(const float* __restrict__ o,
                                 const float* __restrict__ d,
                                 const float* __restrict__ cmat, int n,
                                 int lanes, int repeats,
                                 const float* __restrict__ bias,
                                 float* __restrict__ out,
                                 int32_t* __restrict__ index) {
  extern __shared__ double smem[];
  double* bfrag = smem;  // (n / 8, 32): B fragment of each sphere 8-tile
  float* ccr = reinterpret_cast<float*>(smem + 4 * n);
  float* wcx = ccr + n;
  float* wr2 = wcx + n;
  for (int e = threadIdx.x; e < 4 * n; e += blockDim.x) {
    const int tile = e >> 5, ln = e & 31, k = ln & 3;
    const int j = tile * 8 + (ln >> 2);
    bfrag[e] = k < 3 ? static_cast<double>(cmat[k * n + j]) : 0.0;
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    ccr[j] = cmat[4 * n + j];
    wcx[j] = cmat[j];
    wr2[j] = cmat[3 * n + j];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, q = lane & 3;
  const int tiles = lanes / 8;
  const int sphere_tiles = n / 8;
  for (int tile = blockIdx.x * kWarps + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * kWarps) {
    const int p = tile * 8 + (lane >> 2);  // this thread's lane (pixel)
    const float ox = o[p], oy = o[lanes + p], oz = o[2 * lanes + p];
    const float dx0 = d[p], dy = d[lanes + p], dz = d[2 * lanes + p];
    const double a_o = q == 0 ? ox : q == 1 ? oy : q == 2 ? oz : 0.0;
    const float oo = ox * ox + oy * oy + oz * oz;
    float acc = bias[p];
    for (int r = 0; r < repeats; ++r) {
      const float dx = dx0 * l2n_probe::perturb_scale(r);
      const double a_d = q == 0 ? dx : q == 1 ? dy : q == 2 ? dz : 0.0;
      const float od = ox * dx + oy * dy + oz * dz;
      float best = kBig;
      int bi = n;
      for (int st = 0; st < sphere_tiles; ++st) {
        const double b = bfrag[st * 32 + lane];
        double cd0, cd1, oc0, oc1;
        dmma_8x8x4(cd0, cd1, a_d, b);
        dmma_8x8x4(oc0, oc1, a_o, b);
        const int j = st * 8 + 2 * q;
        const float t0 = mma_t(oo, od, static_cast<float>(oc0),
                               static_cast<float>(cd0), ccr[j]);
        const float t1 = mma_t(oo, od, static_cast<float>(oc1),
                               static_cast<float>(cd1), ccr[j + 1]);
        if (t0 < best) {
          best = t0;
          bi = j;
        }
        if (t1 < best) {
          best = t1;
          bi = j + 1;
        }
      }
      // The 4 threads of a lane hold disjoint spheres: the min, and the
      // lowest index among equal t.
      for (int m = 1; m <= 2; m <<= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, best, m);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, m);
        if (ot < best || (ot == best && oi < bi)) {
          best = ot;
          bi = oi;
        }
      }
      const bool hit = best < kBig;
      const int idx = hit ? bi : -1;
      const float w0 = hit ? wcx[bi] : 0.0f;
      const float w3 = hit ? wr2[bi] : 0.0f;
      const float row = (hit ? best : 0.0f) + w0 * 1e-6f + w3 * 1e-9f +
                        static_cast<float>(idx) * 1e-3f;
      acc = acc + row;
      if (index != nullptr && q == 0)
        index[static_cast<size_t>(r) * lanes + p] = idx;
    }
    if (q == 0) out[p] = acc;
  }
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

// The scalar kernels' launch shape at `lanes` lanes and n spheres into
// shape[0..3]: repeats per chunk, threads per block, blocks, and the blocks
// an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Returns that call's CUDA error (0 on success).
extern "C" int l2n_sweep_shape(int carry, int lanes, int n, int* shape) {
  shape[0] = carry ? kChunkVpu : kChunkVpu2;
  shape[1] = kThreads;
  shape[2] = vpu_grid(lanes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &shape[3], carry ? sweep_vpu_kernel : sweep_vpu2_kernel, kThreads,
      vpu_smem(n)));
}

// o, d: (3, lanes); cmat: (8, n), n a multiple of 8; bias, out: (lanes,),
// lanes a multiple of 8; index: (repeats, lanes) int32 or null.
extern "C" int l2n_sweep_mma(const float* o, const float* d, const float* cmat,
                             int n, int lanes, int repeats, const float* bias,
                             float* out, int32_t* index, void* stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = lanes / 8;
  const int blocks = (tiles + kWarps - 1) / kWarps;
  const dim3 grid(static_cast<unsigned>(blocks < 8 * sms ? blocks : 8 * sms));
  const size_t smem = sizeof(double) * 4 * static_cast<size_t>(n) +
                      sizeof(float) * 3 * static_cast<size_t>(n);
  sweep_mma_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, cmat, n, lanes, repeats, bias, out, index);
  return static_cast<int>(cudaGetLastError());
}
