// Wavefront sphere path-tracing step for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernels of l2n_tpu/ops/kernels/wavefront.py:
//   * pass A, _pass_a_kernel (pallas_call in build_sphere_wavefront_step):
//     per sample of every pixel of the K scheduled tiles, the jittered
//     primary ray, the nearest-sphere sweep, the first-vertex resolve
//     (emission, primary-miss sky), the b=0 scatter and Russian roulette;
//     writes the continuation planes, the partial radiance and the meta
//     planes (pixel and sample index) that key the sampler;
//   * pass B, _pass_b_kernel: over the compacted survivors (a dense prefix of
//     n_alive lanes, built between the passes by torch ops on the device,
//     ops/kernels/wavefront.py::compact_survivors), resume each sample's
//     counter-based stream and finish its path; writes the bounce
//     contribution;
//   * pass C, _pass_c_kernel: per pixel, sum + colA + contrib per sample,
//     then accumulate into `accum` and tonemap into `output`, IN PLACE.
// The image is the fused kernel's (csrc/sphere_pt.cu) to the bit: the same
// path body (csrc/pathtrace.cuh), cut at the first vertex.
//
// What bounds each on this card:
//   * pass A: fp32 ALU work, ~25 operations per sphere of the primary sweep
//     per sample (128 spheres at the default config) plus threefry and the
//     scatter, against 60 bytes per lane (4 read, 56 written): above the
//     card's 20 operations per byte, so compute-bound;
//   * pass B: fp32 ALU work of the bounce sweeps and the sky, but divergent:
//     threads of a warp end their paths at different bounces. At the
//     reference's 10 tiles only ~20% of 40,960 lanes survive, which is about
//     64 blocks of 128 threads for 132 SMs: the grid underfills the card;
//   * pass C: bytes (24 per lane and 44 per pixel against ~40 operations).
// What the design does about that:
//   * A and C run one thread per pixel, a block per row of a tile, so plane
//     stores and loads coalesce; A stages the (7, n) sphere SoA and albedo
//     table in shared memory, read as broadcasts;
//   * B runs one thread per compacted lane in blocks of 128, so a warp
//     starts with 32 live paths, not 32 pixels of which ~6 live. n_alive is
//     read from device memory (no host sync between the passes); a block
//     that lies wholly past it exits before staging the scene (the
//     counterpart of the Pallas kernel's pl.when(start < nalive)), and a
//     thread past it exits after the staging barrier.
// Simple first: the compaction is separate torch ops (a later PR folds it
// into pass A with a warp-aggregated append); no persistent threads to
// refill warps as paths die.
//
// Passes A and B are instantiated for the two counter-based samplers,
// threefry and Philox (rng="tpu_hw"), picked by the host entry points
// (pathtrace.cuh::dispatch_counter_rng); the stateful modes cannot resume
// across the compaction and are refused.
//
// Built by l2n_tpu_torch/ops/kernels/build.py (nvcc -fmad=false, no fast
// math); the per-lane bodies are in wavefront.cuh.

#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace {

constexpr int kPassBThreads = 128;

__device__ void stage_spheres(const float* __restrict__ spheres, float* smem,
                              int n) {
  for (int i = threadIdx.x; i < 7 * n; i += blockDim.x) smem[i] = spheres[i];
  __syncthreads();
}

template <class Rng>
__global__ void wavefront_pass_a_kernel(l2n::PtParams p,
                                        const int32_t* __restrict__ sched,
                                        const float* __restrict__ spheres,
                                        const float* __restrict__ accum,
                                        float* __restrict__ rays,
                                        float* __restrict__ col,
                                        int32_t* __restrict__ meta) {
  extern __shared__ float smem[];
  stage_spheres(spheres, smem, p.n_scene);
  const int k = blockIdx.x / p.tile_height;
  const int r = blockIdx.x % p.tile_height;
  l2n::wavefront_pass_a_pixel<Rng>(p, l2n::scene_view(smem, p.n_scene), k, r,
                              static_cast<int>(threadIdx.x), sched, accum,
                              rays, col, meta);
}

template <class Rng>
__global__ void wavefront_pass_b_kernel(l2n::PtParams p, int next_pair,
                                        int has_spare,
                                        const int32_t* __restrict__ n_alive,
                                        const float* __restrict__ spheres,
                                        const float* __restrict__ rays,
                                        const int32_t* __restrict__ meta,
                                        float* __restrict__ contrib) {
  const size_t alive = static_cast<size_t>(n_alive[0]);
  const size_t start = static_cast<size_t>(blockIdx.x) * blockDim.x;
  if (start >= alive) return;  // the whole block: no barrier is skipped
  extern __shared__ float smem[];
  stage_spheres(spheres, smem, p.n_scene);
  const size_t lane = start + threadIdx.x;
  if (lane >= alive) return;
  l2n::wavefront_pass_b_lane<Rng>(p, l2n::scene_view(smem, p.n_scene), next_pair,
                             has_spare != 0, lane, l2n::lane_count(p), rays,
                             meta, contrib);
}

__global__ void wavefront_pass_c_kernel(l2n::PtParams p,
                                        const int32_t* __restrict__ sched,
                                        const float* __restrict__ col,
                                        const float* __restrict__ back,
                                        float* __restrict__ accum,
                                        float* __restrict__ output) {
  const int k = blockIdx.x / p.tile_height;
  const int r = blockIdx.x % p.tile_height;
  l2n::wavefront_pass_c_pixel(p, k, r, static_cast<int>(threadIdx.x), sched,
                              col, back, accum, output);
}

struct LaunchPassA {
  template <class Rng>
  static int run(l2n::PtParams p, const int32_t* sched, const float* spheres,
                 const float* accum, float* rays, float* col, int32_t* meta,
                 cudaStream_t stream) {
    const dim3 grid(static_cast<unsigned>(p.k * p.tile_height));
    const dim3 block(static_cast<unsigned>(p.tile_width));
    const size_t smem = sizeof(float) * 7 * static_cast<size_t>(p.n_scene);
    wavefront_pass_a_kernel<Rng><<<grid, block, smem, stream>>>(
        p, sched, spheres, accum, rays, col, meta);
    return static_cast<int>(cudaGetLastError());
  }
};

struct LaunchPassB {
  template <class Rng>
  static int run(l2n::PtParams p, int next_pair, int has_spare,
                 const int32_t* n_alive, const float* spheres,
                 const float* rays, const int32_t* meta, float* contrib,
                 cudaStream_t stream) {
    const size_t n = l2n::lane_count(p);
    const dim3 grid(
        static_cast<unsigned>((n + kPassBThreads - 1) / kPassBThreads));
    const dim3 block(kPassBThreads);
    const size_t smem = sizeof(float) * 7 * static_cast<size_t>(p.n_scene);
    wavefront_pass_b_kernel<Rng><<<grid, block, smem, stream>>>(
        p, next_pair, has_spare, n_alive, spheres, rays, meta, contrib);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// The three launchers run on `stream` and return cudaGetLastError() after
// the launch (0 on success; passes A and B return -1 for a sampler code,
// ip[14], that is not counter-based). ip/fp: host arrays of
// l2n::kIntParams ints and l2n::kFloatParams floats
// (ops/kernels/common.py::step_params). Device
// pointers: sched (K, 2) int32; spheres (7, n) float32; accum (4, Hp, Wp)
// and output (3, Hp, Wp) float32; lane arrays in wavefront.cuh's layout:
// rays (9, n_lanes) and col, contrib, back (3, n_lanes) float32, meta (2,
// n_lanes) int32, n_alive one int32.

extern "C" int l2n_wavefront_pass_a(const int32_t* ip, const float* fp,
                                    const int32_t* sched,
                                    const float* spheres, const float* accum,
                                    float* rays, float* col, int32_t* meta,
                                    void* stream) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  return l2n::dispatch_counter_rng<LaunchPassA>(
      p.rng, p, sched, spheres, accum, rays, col, meta,
      static_cast<cudaStream_t>(stream));
}

// next_pair/has_spare: the resume point of the sampler's stream after pass A
// (ops/pathtrace.py::wavefront_draw_position). The grid covers all n_lanes;
// blocks past *n_alive exit at once.
extern "C" int l2n_wavefront_pass_b(const int32_t* ip, const float* fp,
                                    int next_pair, int has_spare,
                                    const int32_t* n_alive,
                                    const float* spheres, const float* rays,
                                    const int32_t* meta, float* contrib,
                                    void* stream) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  return l2n::dispatch_counter_rng<LaunchPassB>(
      p.rng, p, next_pair, has_spare, n_alive, spheres, rays, meta, contrib,
      static_cast<cudaStream_t>(stream));
}

extern "C" int l2n_wavefront_pass_c(const int32_t* ip, const float* fp,
                                    const int32_t* sched, const float* col,
                                    const float* back, float* accum,
                                    float* output, void* stream) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp);
  const dim3 grid(static_cast<unsigned>(p.k * p.tile_height));
  const dim3 block(static_cast<unsigned>(p.tile_width));
  wavefront_pass_c_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p, sched, col, back, accum, output);
  return static_cast<int>(cudaGetLastError());
}
