// The sphere-sweep formulations probe for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernels of benchmarks/sweep_variants.py: `_kernel_vpu`
// (:83), `_kernel_vpu2` (:101) and `_kernel_mxu` (:138), pallas_call at
// :207. Each runs R repeats of a nearest-hit sweep over n spheres for every
// lane of (blocks, 32, 128) rays, the direction's x scaled by 1 + 1e-4 r in
// repeat r, and accumulates t, the winner's cx and r2 and its index into
// `out`, starting from `bias`:
//   * sweep_vpu: the production sweep, the winner's attributes carried
//     through every candidate (selects per candidate);
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
// What bounds them on this card: fp32 issue, not memory. A lane-candidate
// costs ~24 operations and a sqrt (vpu), against 28 bytes per lane read and
// written once for all R x n candidates. Design:
//   * vpu / vpu2: one thread per lane, the sphere rows staged once per block
//     into shared memory (every thread of a warp reads the same sphere, a
//     broadcast), the body shared with the CPU tests (csrc/sweep_probe.cuh);
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

// sweep_vpu (kCarry) / sweep_vpu2: one thread per lane.
template <bool kCarry>
__device__ __forceinline__ void sweep_vpu_body(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ cz, const float* __restrict__ r2, int n,
    int lanes, int repeats, const float* __restrict__ bias,
    float* __restrict__ out) {
  extern __shared__ float rows[];  // (4, n): cx, cy, cz, r2
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    rows[j] = cx[j];
    rows[n + j] = cy[j];
    rows[2 * n + j] = cz[j];
    rows[3 * n + j] = r2[j];
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= lanes) return;
  const l2n_probe::Spheres s{rows, n};
  out[p] = l2n_probe::sweep_lane<kCarry>(
      s, repeats, o[p], o[lanes + p], o[2 * lanes + p], d[p], d[lanes + p],
      d[2 * lanes + p], bias[p]);
}

// One kernel name per variant, so that a profile tells them apart.
__global__ void sweep_vpu_kernel(const float* __restrict__ o,
                                 const float* __restrict__ d,
                                 const float* __restrict__ cx,
                                 const float* __restrict__ cy,
                                 const float* __restrict__ cz,
                                 const float* __restrict__ r2, int n,
                                 int lanes, int repeats,
                                 const float* __restrict__ bias,
                                 float* __restrict__ out) {
  sweep_vpu_body<true>(o, d, cx, cy, cz, r2, n, lanes, repeats, bias, out);
}

__global__ void sweep_vpu2_kernel(const float* __restrict__ o,
                                  const float* __restrict__ d,
                                  const float* __restrict__ cx,
                                  const float* __restrict__ cy,
                                  const float* __restrict__ cz,
                                  const float* __restrict__ r2, int n,
                                  int lanes, int repeats,
                                  const float* __restrict__ bias,
                                  float* __restrict__ out) {
  sweep_vpu_body<false>(o, d, cx, cy, cz, r2, n, lanes, repeats, bias, out);
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

template <bool kCarry>
int launch_vpu(const float* o, const float* d, const float* cx,
               const float* cy, const float* cz, const float* r2, int n,
               int lanes, int repeats, const float* bias, float* out,
               void* stream) {
  const dim3 grid(static_cast<unsigned>((lanes + kThreads - 1) / kThreads));
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(n);
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
