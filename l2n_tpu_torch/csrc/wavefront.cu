// Wavefront sphere path-tracing step for Hopper (sm_90a): three kernels and
// one memset, with no other device work between them.
//
// Replaces the TPU kernels of l2n_tpu/ops/kernels/wavefront.py:
//   * pass A, _pass_a_kernel (pallas_call in build_sphere_wavefront_step):
//     per sample of every pixel of the K scheduled tiles, the jittered
//     primary ray, the nearest-sphere sweep over the tile's cone-visible
//     spheres (the JAX kernel's visibility table, cone_cull=True), the
//     first-vertex resolve (emission, primary-miss sky), the b=0 scatter,
//     its NEE (a shadow ray over every sphere) and Russian roulette; writes
//     the partial radiance by lane and, for a path
//     that ends there, back = 0 by lane; appends each survivor's ray planes
//     and meta (pixel, sample, lane) to a dense prefix of slots, counting
//     them in n_alive (zeroed by a memset before the launch). This is also
//     the JAX step's compaction between the passes (its cumsum and gather);
//   * pass B, _pass_b_kernel: over the n_alive slots, resume each sample's
//     counter-based stream and finish its path; writes the contribution to
//     back at the survivor's own lane (the JAX step's scatter-back; under
//     NEE the path goes on from the lane's col, pass A's direct light, and
//     back gets the whole sum, col 0, so the image stays the fused one);
//   * pass C, _pass_c_kernel: per pixel, sum + colA + back per sample, then
//     accumulate into `accum` and tonemap into `output`, IN PLACE.
// The image is the fused kernel's (csrc/sphere_pt.cu) to the bit: the same
// path body (csrc/pathtrace.cuh), cut at the first vertex. The slot order
// changes from run to run; the image does not (csrc/wavefront.cuh).
//
// What bounds each on this card:
//   * pass A: bytes, ~32 per lane (4 read per pixel; col, then back = 0
//     or a survivor's 48 B of rays and meta) against a few hundred
//     operations: the primaries sweep ~1.6 visible spheres of 128 on the
//     default view, plus threefry, the ray and the scatter;
//   * pass B: fp32 ALU work of the bounce sweeps over every sphere and the
//     sky, but divergent: threads of a warp end their paths at different
//     bounces. About a quarter of the lanes survive pass A: ~215k at whole
//     frame, ~10k at the reference's 10 tiles, too few threads for 132 SMs;
//   * pass C: bytes (24 per lane and 44 per pixel against ~40 operations).
// What the design does about that (each part measured against the others
// on the card, PERF.md):
//   * A and C run one thread per pixel, a block per row of a tile, so the
//     planes by lane coalesce. A's block prologue is sphere_pt's
//     (l2n::stage_culled_scene): the scene in shared memory, the tile's
//     visible list and its hoisted origin terms. A's append is per warp (a
//     ballot and one atomicAdd on n_alive per warp and sample; per block it
//     cost two more barriers per sample and was slower), so survivors keep
//     lane order within a warp;
//   * B runs a thread per lane or the card's full complement of threads
//     (SMs x threads per SM), whichever is more, so its grid does not
//     depend on n_alive; blocks past the survivors exit before staging the
//     scene, and the card's block scheduler refills SMs as warps finish (a
//     persistent grid striding or fetching slots was slower at whole
//     frame). When 8 lanes per survivor fit in that complement, 8 lanes
//     share each ray and split its sphere sweeps (l2n::GroupScene; G picked
//     on the device from n_alive by l2n::group_size, uniform for the
//     launch: 8 at 10 tiles, 1 at whole frame on the default view), so the
//     few rays of a 10-tile step fill the card. Its
//     sweeps read each sphere's centre and r^2 as one 16-byte word from a
//     packed copy beside the SoA. n_alive is read on the device only: no
//     host sync.
//
// Passes A and B are instantiated for the two counter-based samplers,
// threefry and Philox (rng="tpu_hw"), with the body (Lambert, or the
// materials body for the material modes and the bump, which also stages
// the table's six material rows), fast_math and, for pass A, the camera
// form compiled in, picked by the host entry points (pathtrace.cuh::
// dispatch_pass_a / dispatch_pass_b); and with the NEE body, its options
// read at run time (pathtrace.cuh::body_options), whose survivors carry a
// 10th ray plane under MIS and whose pass B resumes its stream with a
// spare pending in the material modes. The stateful modes cannot resume
// across the split and are refused. The sky (none, Mandelbrot, sun) is a
// runtime parameter.
//
// Built by l2n_tpu_torch/ops/kernels/build.py (nvcc -fmad=false, no fast
// math); the per-lane bodies are in wavefront.cuh.

#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace {

constexpr int kPassBThreads = 128;

// Pass A's append, per warp: a ballot of this sample's survivors, one
// atomicAdd on n_alive for the warp's base, and each survivor's rank among
// the warp's. Every thread of the warp calls it once per sample; returns
// the slot, or -1.
struct WarpAppend {
  int32_t* n_alive;

  __host__ __device__ int operator()(bool alive) const {
#if defined(__CUDA_ARCH__)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int live = blockDim.x - 32 * warp;  // the warp's threads
    const unsigned lanes = live >= 32 ? 0xFFFFFFFFu : (1u << live) - 1u;
    const unsigned ballot = __ballot_sync(lanes, alive);
    int base = 0;
    if (lane == 0 && ballot != 0u) base = atomicAdd(n_alive, __popc(ballot));
    base = __shfl_sync(lanes, base, 0);
    return alive ? base + __popc(ballot & ((1u << lane) - 1u)) : -1;
#else
    (void)alive;
    return -1;
#endif
  }
};

// The per-sphere table rows a pass reads: the albedo, and the material rows
// for the materials and NEE bodies.
__host__ __device__ constexpr int pass_table_rows(int body) {
  return l2n::reads_materials(body) ? 9 : 3;
}

template <class Rng, int kBody, bool kFast, bool kViewproj>
__global__ void wavefront_pass_a_kernel(l2n::PtParams params,
                                        const int32_t* __restrict__ sched,
                                        const float* __restrict__ spheres,
                                        const float* __restrict__ accum,
                                        l2n::PassALanes out,
                                        int32_t* __restrict__ n_alive) {
  extern __shared__ float smem[];
  const l2n::PtParams p =
      l2n::body_options<kBody, kFast, kViewproj>(params);
  const int k = blockIdx.x / p.tile_height;
  const int r = blockIdx.x % p.tile_height;
  const l2n::SceneView scene =
      l2n::stage_culled_scene<pass_table_rows(kBody)>(
          p, spheres, smem, sched[2 * k], sched[2 * k + 1]);
  WarpAppend append{n_alive};
  for (int si = 0; si < p.spp; ++si)
    l2n::wavefront_pass_a_sample<Rng, kBody>(p, scene, k, si, r,
                                      static_cast<int>(threadIdx.x), sched,
                                      accum, out, append);
}

// The slot of this thread's group, G lanes to a ray (the grid covers
// alive * G threads).
template <class Rng, int kBody, int G>
__device__ void pass_b_slot(const l2n::PtParams& p,
                            const l2n::SceneView& scene,
                            const l2n::Sphere4* packed, int next_pair,
                            bool has_spare, int alive,
                            const float* __restrict__ rays,
                            const int32_t* __restrict__ meta,
                            float* __restrict__ back) {
  const int slot = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  if (slot >= alive) return;  // the whole group
  const int g = static_cast<int>(threadIdx.x) % G;
  const unsigned mask = ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const l2n::GroupScene<G> s{scene, packed, g, mask};
  l2n::wavefront_pass_b_slot<Rng, kBody>(p, s, next_pair, has_spare, slot,
                                         l2n::lane_count(p), rays, meta,
                                         p.nee_col, back, g == 0);
}

// Pass B's shared memory, in floats: the first 4 + table rows of the (13, n)
// SoA, then the packed spheres from a 16-byte boundary.
size_t pass_b_floats(int n, int table) {
  return ((4 + table) * static_cast<size_t>(n) + 3) / 4 * 4 +
         4 * static_cast<size_t>(n);
}

// group_threads: the threads against which G is picked (l2n::group_size),
// the card's full complement.
template <class Rng, int kBody, bool kFast>
__global__ void __launch_bounds__(kPassBThreads)
    wavefront_pass_b_kernel(l2n::PtParams params, int next_pair,
                            int has_spare,
                            int group_threads,
                            const int32_t* __restrict__ n_alive,
                            const float* __restrict__ spheres,
                            const float* __restrict__ rays,
                            const int32_t* __restrict__ meta,
                            float* __restrict__ back) {
  const l2n::PtParams p = l2n::body_options<kBody, kFast>(params);
  const int alive = n_alive[0];
  const int g = l2n::group_size(alive, group_threads);
  // A block with no slot exits before staging the scene (uniform per
  // block: no barrier is skipped).
  if (static_cast<long long>(blockIdx.x) * (blockDim.x / g) >= alive) return;
  extern __shared__ float smem[];
  const int n = p.n_scene;
  const int rows = 4 + pass_table_rows(kBody);
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x)
    smem[i] = spheres[i];
  l2n::Sphere4* packed =
      reinterpret_cast<l2n::Sphere4*>(smem + (rows * n + 3) / 4 * 4);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    packed[i] = l2n::Sphere4{spheres[i], spheres[n + i], spheres[2 * n + i],
                             spheres[3 * n + i]};
  __syncthreads();
  const l2n::SceneView scene = l2n::scene_view(smem, n, p.fast_math != 0);
  const bool spare = has_spare != 0;
  if (g == l2n::kMaxGroup)
    pass_b_slot<Rng, kBody, l2n::kMaxGroup>(
        p, scene, packed, next_pair, spare, alive, rays, meta, back);
  else
    pass_b_slot<Rng, kBody, 1>(p, scene, packed, next_pair, spare,
                                    alive, rays, meta, back);
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
  template <class Rng, int kBody, bool kFast, bool kViewproj>
  static int run(l2n::PtParams p, const int32_t* sched, const float* spheres,
                 const float* accum, l2n::PassALanes out, int32_t* n_alive,
                 cudaStream_t stream) {
    const size_t smem = sizeof(float) * l2n::culled_scene_floats(
                                            p.n_scene, pass_table_rows(kBody));
    static size_t opted = 48 * 1024;
    const auto kernel =
        wavefront_pass_a_kernel<Rng, kBody, kFast, kViewproj>;
    cudaError_t rc = l2n::allow_smem(kernel, smem, opted);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaMemsetAsync(n_alive, 0, sizeof(int32_t), stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const dim3 grid(static_cast<unsigned>(p.k * p.tile_height));
    const dim3 block(static_cast<unsigned>(p.tile_width));
    kernel<<<grid, block, smem, stream>>>(
        p, sched, spheres, accum, out, n_alive);
    return static_cast<int>(cudaGetLastError());
  }
};

// Pass B's grid: a thread per lane or the card's full complement of
// threads, whichever is more, so that it never depends on n_alive and holds
// every group; and that complement, against which G is picked: a split
// pays only while the survivors leave threads idle.
cudaError_t pass_b_grid(const l2n::PtParams& p, int& grid,
                        int& group_threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (rc != cudaSuccess) return rc;
  group_threads = sms * per_sm;
  const int lanes = static_cast<int>(
      (l2n::lane_count(p) + kPassBThreads - 1) / kPassBThreads);
  const int full = group_threads / kPassBThreads;
  grid = lanes > full ? lanes : full;
  return cudaSuccess;
}

struct LaunchPassB {
  template <class Rng, int kBody, bool kFast>
  static int run(l2n::PtParams p, int next_pair, int has_spare,
                 const int32_t* n_alive, const float* spheres,
                 const float* rays, const int32_t* meta, float* back,
                 cudaStream_t stream) {
    const size_t smem =
        sizeof(float) * pass_b_floats(p.n_scene, pass_table_rows(kBody));
    static size_t opted = 48 * 1024;
    int grid = 0, group_threads = 0;
    const auto kernel = wavefront_pass_b_kernel<Rng, kBody, kFast>;
    cudaError_t rc = l2n::allow_smem(kernel, smem, opted);
    if (rc == cudaSuccess) rc = pass_b_grid(p, grid, group_threads);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    kernel
        <<<static_cast<unsigned>(grid), kPassBThreads, smem, stream>>>(
            p, next_pair, has_spare, group_threads, n_alive, spheres, rays,
            meta, back);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// The three launchers run on `stream` and return the first CUDA error of
// their calls (0 on success; passes A and B return -1 for a sampler code,
// ip[14], that is not counter-based). ip/fp: host arrays of
// l2n::kIntParams ints and l2n::kFloatParams floats
// (ops/kernels/common.py::step_params). Device pointers: sched (K, 2)
// int32; spheres (13, n) float32; accum (4, Hp, Wp) and output (3, Hp, Wp)
// float32; in wavefront.cuh's layouts, col and back (3, n_lanes) float32
// by lane, rays (9 or 10, n_lanes: wavefront.cuh ray_planes) float32 and
// meta (3, n_lanes) int32 by slot,
// n_alive one int32.

// Stages the camera, (10, 4) float32 (pathtrace.cuh stage_camera), and
// zeroes n_alive (a memset on the stream), then appends the survivors.
extern "C" int l2n_wavefront_pass_a(const int32_t* ip, const float* fp,
                                    const float* camera,
                                    const int32_t* sched,
                                    const float* spheres, const float* accum,
                                    float* col, float* back, float* rays,
                                    int32_t* meta, int32_t* n_alive,
                                    void* stream) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp, camera);
  const cudaError_t rc =
      l2n::stage_camera(camera, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return l2n::dispatch_pass_a<LaunchPassA>(
      p, p, sched, spheres, accum, l2n::PassALanes{col, back, rays, meta},
      n_alive, static_cast<cudaStream_t>(stream));
}

// next_pair/has_spare: the resume point of the sampler's stream after pass A
// (ops/pathtrace.py::wavefront_draw_position). Writes back at the lanes of
// the first *n_alive slots; under NEE also col there (wavefront.cuh
// wavefront_pass_b_slot), which the other bodies never touch (null then).
extern "C" int l2n_wavefront_pass_b(const int32_t* ip, const float* fp,
                                    int next_pair, int has_spare,
                                    const int32_t* n_alive,
                                    const float* spheres, const float* rays,
                                    const int32_t* meta, float* col,
                                    float* back, void* stream) {
  l2n::PtParams p = l2n::params_from_arrays(ip, fp, nullptr);
  p.nee_col = col;
  return l2n::dispatch_pass_b<LaunchPassB>(
      p, p, next_pair, has_spare, n_alive, spheres, rays, meta, back,
      static_cast<cudaStream_t>(stream));
}

extern "C" int l2n_wavefront_pass_c(const int32_t* ip, const float* fp,
                                    const int32_t* sched, const float* col,
                                    const float* back, float* accum,
                                    float* output, void* stream) {
  const l2n::PtParams p = l2n::params_from_arrays(ip, fp, nullptr);
  const dim3 grid(static_cast<unsigned>(p.k * p.tile_height));
  const dim3 block(static_cast<unsigned>(p.tile_width));
  wavefront_pass_c_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p, sched, col, back, accum, output);
  return static_cast<int>(cudaGetLastError());
}
