// Per-pixel path body shared by the path-tracing kernels (csrc/sphere_pt.cu,
// csrc/triangle_pt.cu, csrc/wavefront.cu).
//
// Everything here is `__host__ __device__`: nvcc builds it into the CUDA
// kernels, and the CPU tests build the same headers with g++
// (-ffp-contract=off) to check them against the plain torch path without a
// card. It computes what the JAX package's fused kernels compute for one
// pixel of a scheduled tile, with the same float32 operations in the same
// order (minimax atan2, kernel-form tonemap), but as the reference GLSL's
// divergent per-thread loop: a thread stops when its path dies instead of
// running masked lanes.
//
// The path body is a template on the scene: a scene type provides
//   Hit nearest(ox, oy, oz, dx, dy, dz) const;  // t = -1 on a miss
//   Hit nearest_primary(ox, oy, oz, dx, dy, dz) const;  // the same hit
//   bool anyhit(ox, oy, oz, dx, dy, dz) const;   // == nearest(...).t >= 0
//   bool occluded(ox, oy, oz, dx, dy, dz) const;  // the AO cast:
//       // nearest(...).t >= 0 for a direction of any length
//   static void miss_color(float col[3]);  // the normal AOV's miss colour
//   void bound(i, cx, cy, cz, r2) const;  // object i's (bounding) sphere
//   static constexpr bool kConeLights;  // NEE: cone (meshes) or area
// where nearest_primary serves the primary casts (origin = the camera, the
// direction through a pixel of the thread's tile) and may walk only the
// tile's cone-visible candidates (csrc/cull.cuh),
// and the per-object table indexed by Hit::index: the albedo rows `ar`,
// `ag`, `ab` and, for the materials body, `mat`, the six rows of n floats
// of scene/materials.py MATERIAL_CHANNELS (csrc/sphere_pt.cuh: spheres;
// csrc/triangle_pt.cuh: meshes).
//
// The path body is also a template on the sampler, one type per rng mode
// (rng/sampler.py): ThreefrySampler, PhiloxSampler (rng="tpu_hw"),
// TinyMTSampler and TausLCGSampler. A kernel is instantiated once per
// sampler (and per compile-time setting: the fused kernels' body, fast_math
// and the camera form; body_options), and its host entry point picks the
// instantiation from the codes (dispatch_rng, dispatch_fused,
// dispatch_pass_a, dispatch_pass_b); nothing switches on the mode inside
// the path loop. The body (kBody*): the Lambert path tracer, which is the
// default path and holds no material code; the primary-only AOVs; the
// materials path tracer, which switches at run time on the material mode,
// the bump and the explicit lights (scatter_materials), taken whenever one
// of them is on; the NEE path tracer, the materials body with next event
// estimation and MIS (next_event), taken whenever NEE is on and built for
// the two counter-based samplers only (the config refuses NEE with the
// stateful ones); the fog path tracer (trace_fog), the materials body with
// homogeneous fog, NEE and MIS read at run time, taken whenever fog is on
// and built for the counter-based samplers only as well.
// A sampler provides draw2/draw1 and the per-pixel protocol render_pixel
// uses: load (sample 0 of the step), next_sample, store.
//
// Counter-based draw addresses: pair k of sample s of pixel p is threefry
// at counter (p, s * max_pairs + k), or words 2 (k & 1), 2 (k & 1) + 1 of
// the Philox block at counter (p, s, k >> 1, 0); draw1 caches the second
// word of a pair, which the next draw1 takes however many draw2s come
// between. Replaying the lockstep tracer's call sequence along one path
// gives its addresses; max_pairs is its budget, 2 + 2 max_bounces pairs, 2
// + 4 max_bounces with NEE, max_bounces + 1 more with fog
// (rng/sampler.py max_pairs_per_sample), AOVs included. Pair 0 is the
// jitter. A bounce draws:
//   * Lambert: the hemisphere pair, then the RR draw1. Bounce 0: pair 1,
//     pair 2 word 0; bounce 1: pair 3, pair 2 word 1 (the spare); and so
//     on, a spare pending after every other bounce;
//   * the material modes: the pair, the lobe's draw1, the RR draw1. Bounce
//     0: pair 1, pair 2 words 0 and 1; bounce 1: pairs 3 and 4; no spare
//     pending after a bounce;
//   * Lambert with NEE: the hemisphere pair, the light pick's draw1, the
//     point's pair, the RR draw1. Bounce 0: pair 1, pair 2 word 0, pair 3,
//     pair 2 word 1; no spare pending after a bounce;
//   * the material modes with NEE: the pair, the lobe's and the pick's
//     draw1s, the point's pair, the RR draw1. Bounce 0: pair 1, pair 2
//     words 0 and 1, pair 3, pair 4 word 0, leaving pair 4 word 1 pending:
//     bounce 1's lobe takes it after bounce 1's pair 5, and a spare is
//     pending across the wavefront split (pass B resumes at pair 5 with
//     pair 4's second word, ops/pathtrace.py::wavefront_draw_position).
// The explicit lights draw nothing. The wavefront passes take the resume
// point from that replay, never from this account. Fog adds one draw1 per
// segment, right after its cast (a hit or a miss), before the vertex's
// own draws, and one on the last (any-hit) segment; a fog vertex takes
// every draw a surface vertex of its mode would. Lambert with fog,
// max_bounces 2: the jitter pair 0; the primary's collision pair 1 word 0,
// the hemisphere pair 2, the RR pair 1 word 1; bounce 1's collision pair 3
// word 0, its pair 4, its RR pair 3 word 1; the last segment's collision
// pair 5 word 0 (K = 9).
// The stateful samplers step their pixel's state at every draw, which is
// what the lockstep tracer's masks reproduce: the jitter of every pixel,
// the scatter's draws and the RR draw at diffuse vertices only, nothing at
// an emissive hit, a miss or the last segment.
//
// One loop traces a path (trace_from); it can stop after the first vertex.
// The fused kernels run it whole (trace_sample); the wavefront kernels
// (csrc/wavefront.cu) run the first vertex in pass A (trace_primary) and
// the rest in pass B (trace_continue), with the sampler resumed between.
// The primary-only AOVs (aov_sample) stop at the primary hit, but for the
// ambient-occlusion ray.
//
// The step's settings ride in PtParams: the sky (none, Mandelbrot, sun),
// the camera form (fovy, viewproj), the material mode, the bump, the
// explicit lights, NEE and MIS, and fast_math, which takes rsqrtf at the
// JAX package's sites only: the nearest-sphere sweeps' square root (as x *
// rsqrt(x)) and hit normal, the camera ray's normalize and the procedural
// scatter's frame and normalize. The any-hit sweeps, the AO frame, the
// triangle tests, the bump, the material modes' frames and normalizes and
// everything of NEE stay exact.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define L2N_HD __host__ __device__ __forceinline__
#else
#define L2N_HD inline
#endif

namespace l2n {

constexpr double kPi = 3.14159265358979323846;
constexpr float kBig = 3.0e38f;
constexpr int kMandelbrotIters = 64;

// AOV codes (ops/kernels/common.py::AOV_CODES).
constexpr int kAovPathtracing = 0;
constexpr int kAovTexCoords = 1;
constexpr int kAovParamUv = 2;
constexpr int kAovNormal = 3;
constexpr int kAovHit = 4;
constexpr int kAovAmbientOcclusion = 5;

// Sky codes (ops/kernels/common.py::ENV_CODES).
constexpr int kEnvNone = 0;
constexpr int kEnvMandelbrot = 1;
constexpr int kEnvSun = 2;

// Camera ray forms (ops/kernels/common.py::RAY_GEN_CODES).
constexpr int kRayGenFovy = 0;
constexpr int kRayGenViewproj = 1;

// Sampler codes (ops/kernels/common.py::RNG_CODES).
constexpr int kRngThreefry = 0;
constexpr int kRngPhilox = 1;  // rng="tpu_hw"
constexpr int kRngTinyMT = 2;
constexpr int kRngTausLCG = 3;

// Integer and float parameters of one step, filled by the C entry points
// from the arrays the Python wrappers pass (ops/kernels/common.py::
// step_params keeps the two layouts in step). `cam` points at the packed
// (10, 4) camera block, which the code reads through camera_block.
struct PtParams {
  int32_t tile_height, tile_width;
  int32_t padded_height, padded_width;
  int32_t k;        // scheduled tiles this step
  int32_t n_scene;  // spheres, or meshes
  int32_t spp;
  int32_t max_bounces;
  int32_t max_pairs;
  int32_t emissive_every;
  int32_t env;  // kEnv*
  uint32_t seed, stream;
  int32_t aov;  // kAov*
  int32_t rng;  // kRng*
  int32_t ray_gen;  // kRayGen*
  int32_t fast_math;  // 1: rsqrtf at the fast-math sites
  int32_t material;  // kMaterial* (brdf.cuh)
  int32_t n_point, n_dir;  // explicit lights
  float inv_width, inv_height;  // float32(1 / width), float32(1 / height)
  float rr_ceiling, ray_epsilon, emission_scale, env_scale, gamma;
  // The camera block's 40 floats: on the card the step's device buffer,
  // which the entry point copies into constant memory ahead of the launch
  // (stage_camera), so that a CUDA graph replays whatever camera the buffer
  // holds when it runs; on the host (the CPU tests' build) the block itself.
  const float* cam;
  float normal_map, normal_map_freq;  // the bump: off at normal_map 0
  // The explicit lights' rows, six floats each (ops/lights.py::
  // ExplicitLights.buffer): n_point points (x, y, z, intensity rgb), then
  // n_dir directional lights (wi = -incidentDirection, radiance rgb). A
  // device pointer the entry point sets; null without lights.
  const float* lights;
  // NEE, after the other bodies' fields (their code keeps its parameter
  // offsets): on, with MIS, and its lights, the scene's indices 0, every,
  // ...; its constants, float32 roundings of float64 products as ops/nee.py
  // takes them: emission_scale * n_lights (area), emission_scale / (4 pi)
  // (cone; meshes emit with r^2 = 1).
  int32_t nee, mis, n_lights;
  float nee_scale, nee_le;
  // The wavefront pass B's col lanes under NEE, which it takes over
  // (csrc/wavefront.cuh wavefront_pass_b_slot): a device pointer its entry
  // point sets, here so that the other bodies' pass B keeps its arguments;
  // null elsewhere.
  float* nee_col;
  // Fog, after the other bodies' fields as NEE's: on, and its constants
  // (ops/fog.py): sigma, float32(1 / sigma), the sky shell's distance, the
  // albedo, the directional lights' transmittance float32(exp(-sigma
  // sky)).
  int32_t fog;
  float fog_sigma, fog_inv_sigma, fog_sky, fog_albedo, fog_dir_transmit;
  // The global row of the frame's row 0 when the frame is a slab of a
  // larger one (l2n_tpu_torch/parallel): render_pixel and tile_cone take
  // the pixel index and the camera rays from the global row, while the
  // planes stay slab-local. 0 on one card, and in the wavefront passes,
  // whose wrappers refuse a slab. After the other fields, as fog's.
  int32_t row_offset;
};
constexpr int kIntParams = 25;
constexpr int kFloatParams = 7 + 4 + 5;

#if defined(__CUDACC__)
// The camera block of the launch in flight, one per translation unit (each
// kernel family's own): stage_camera fills it on the launch's stream, so
// launches of one family on two streams at once would share it (the port
// launches each family on one stream). Constant memory, so that its reads
// are constant-cache operands, as the parameters' are.
static __constant__ float c_camera[40];

// Copy the camera block from its device buffer into this translation
// unit's c_camera on `stream`, ahead of the launches that read it: a
// device-to-device copy, which a stream capture records as a graph node.
static inline cudaError_t stage_camera(const float* camera,
                                       cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(c_camera, camera, sizeof(c_camera), 0,
                                 cudaMemcpyDeviceToDevice, stream);
}
#endif

// The packed (10, 4) camera block (camera/camera.py): c_camera on the card,
// the block p.cam points at on the host.
L2N_HD const float* camera_block(const PtParams& p) {
#if defined(__CUDA_ARCH__)
  return c_camera;
#else
  return p.cam;
#endif
}

L2N_HD float bits_to_float(uint32_t u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

// ---------------------------------------------------------------------------
// Threefry-2x32, 20 rounds (rng/threefry.py).
// ---------------------------------------------------------------------------

L2N_HD uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

#define L2N_TF_ROUND(r) \
  x0 += x1;             \
  x1 = rotl32(x1, r);   \
  x1 ^= x0;

L2N_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                         uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  L2N_TF_ROUND(13) L2N_TF_ROUND(15) L2N_TF_ROUND(26) L2N_TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  L2N_TF_ROUND(17) L2N_TF_ROUND(29) L2N_TF_ROUND(16) L2N_TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  L2N_TF_ROUND(13) L2N_TF_ROUND(15) L2N_TF_ROUND(26) L2N_TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  L2N_TF_ROUND(17) L2N_TF_ROUND(29) L2N_TF_ROUND(16) L2N_TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  L2N_TF_ROUND(13) L2N_TF_ROUND(15) L2N_TF_ROUND(26) L2N_TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef L2N_TF_ROUND

// ---------------------------------------------------------------------------
// Philox4x32-10 (rng/philox.py): the card's rng="tpu_hw" generator.
// ---------------------------------------------------------------------------

L2N_HD uint32_t mulhilo32(uint32_t a, uint32_t b, uint32_t& hi) {
#if defined(__CUDA_ARCH__)
  hi = __umulhi(a, b);
  return a * b;
#else
  const uint64_t prod = static_cast<uint64_t>(a) * b;
  hi = static_cast<uint32_t>(prod >> 32);
  return static_cast<uint32_t>(prod);
#endif
}

// Ten rounds over the counter c with the key bumped between rounds
// (Random123; torch's ATen/core/PhiloxRNGEngine.h computes the same).
L2N_HD void philox4x32_10(uint32_t k0, uint32_t k1, uint32_t c[4]) {
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t hi0, hi1;
    const uint32_t lo0 = mulhilo32(0xD2511F53u, c[0], hi0);
    const uint32_t lo1 = mulhilo32(0xCD9E8D57u, c[2], hi1);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// The raw-bits layout (csrc/philox_bits.cu, ops/kernels/philox_bits.py):
// draw i of pixel p is sample 0, pair i >> 1, word i & 1 of the pair, i.e.
// word i & 3 of the block at counter (p, 0, i >> 2, 0). So the block at
// counter (pixel, 0, block, 0) holds draws 4 block .. 4 block + 3, its
// word `word` being draw 4 block + word, stored at `offset` = draw *
// per_draw + pixel, per_draw the h * 128 words of a draw. False (nothing to
// store) for a draw at or past k: the last block of a k that is not a
// multiple of 4 gives fewer words.
L2N_HD bool philox_bits_slot(uint32_t pixel, uint32_t block, uint32_t word,
                             uint32_t k, size_t per_draw, size_t& offset) {
  const uint32_t draw = 4u * block + word;
  if (draw >= k) return false;
  offset = static_cast<size_t>(draw) * per_draw + pixel;
  return true;
}

// Top 23 bits as mantissa, lowest mantissa bit forced: a float in (1, 2).
L2N_HD float uniform_oo(uint32_t bits) {
  return bits_to_float((bits >> 9) | 0x3F800001u) - 1.0f;
}

// ---------------------------------------------------------------------------
// Samplers (rng/sampler.py).
// ---------------------------------------------------------------------------

// Pair `pair` of a sample as two words, per counter-based generator.
struct ThreefryPairs {
  L2N_HD static void words(uint32_t k0, uint32_t k1, uint32_t pixel,
                           uint32_t sample, uint32_t max_pairs, uint32_t pair,
                           uint32_t& a, uint32_t& b) {
    a = pixel;
    b = sample * max_pairs + pair;
    threefry2x32(k0, k1, a, b);
  }
};

struct PhiloxPairs {
  L2N_HD static void words(uint32_t k0, uint32_t k1, uint32_t pixel,
                           uint32_t sample, uint32_t, uint32_t pair,
                           uint32_t& a, uint32_t& b) {
    uint32_t c[4] = {pixel, sample, pair >> 1, 0u};
    philox4x32_10(k0, k1, c);
    a = (pair & 1u) ? c[2] : c[0];
    b = (pair & 1u) ? c[3] : c[1];
  }
};

// A counter-based sampler of one sample of one pixel: draws are addressed,
// so it keeps only its position (the next pair, and the pending second word
// of a draw1).
template <class Pairs>
struct CounterSampler {
  uint32_t k0, k1, pixel, sample, max_pairs;
  uint32_t pair;
  bool has_spare;
  float spare;

  L2N_HD void draw2(float& u1, float& u2) {
    uint32_t a, b;
    Pairs::words(k0, k1, pixel, sample, max_pairs, pair, a, b);
    ++pair;
    u1 = uniform_oo(a);
    u2 = uniform_oo(b);
  }
  L2N_HD float draw1() {
    if (has_spare) {
      has_spare = false;
      return spare;
    }
    float a;
    draw2(a, spare);
    has_spare = true;
    return a;
  }

  // Sample `sample` of pixel `pixel`, at pair 0.
  L2N_HD static CounterSampler at(const PtParams& p, uint32_t pixel,
                                  uint32_t sample) {
    CounterSampler rng;
    rng.k0 = p.seed;
    rng.k1 = p.stream;
    rng.pixel = pixel;
    rng.sample = sample;
    rng.max_pairs = static_cast<uint32_t>(p.max_pairs);
    rng.pair = 0;
    rng.has_spare = false;
    rng.spare = 0.0f;
    return rng;
  }

  // The same sampler in the middle of its sample (rng/sampler.py::
  // _CounterSampler.resumed): the next fresh pair is next_pair and, with
  // has_spare, the second word of pair next_pair - 1 is pending,
  // regenerated.
  L2N_HD static CounterSampler resumed(const PtParams& p, uint32_t pixel,
                                       uint32_t sample, int next_pair,
                                       bool has_spare) {
    CounterSampler rng = at(p, pixel, sample);
    if (has_spare) {
      rng.pair = static_cast<uint32_t>(next_pair - 1);
      float unused;
      rng.draw2(unused, rng.spare);
      rng.has_spare = true;
    } else {
      rng.pair = static_cast<uint32_t>(next_pair);
    }
    return rng;
  }

  // render_pixel's protocol: no state planes, a fresh position per sample.
  L2N_HD static CounterSampler load(const PtParams& p, const uint32_t*,
                                    size_t, size_t, uint32_t pixel,
                                    uint32_t sample) {
    return at(p, pixel, sample);
  }
  L2N_HD void next_sample() {
    ++sample;
    pair = 0;
    has_spare = false;
  }
  L2N_HD void store(uint32_t*, size_t, size_t) const {}
};

using ThreefrySampler = CounterSampler<ThreefryPairs>;
using PhiloxSampler = CounterSampler<PhiloxPairs>;

// TinyMT32 over the pixel's state planes {s0..s3, mat1, mat2, tmat, pad}
// (rng/tinymt.py): one state step and one temper per draw1, draw2 = two
// draw1s. The state chains from sample to sample and is stored once.
struct TinyMTSampler {
  uint32_t s0, s1, s2, s3, mat1, mat2, tmat;

  L2N_HD float draw1() {
    uint32_t y = s3;
    uint32_t x = (s0 & 0x7FFFFFFFu) ^ s1 ^ s2;
    x ^= x << 1;
    y ^= (y >> 1) ^ x;
    const uint32_t m = 0u - (y & 1u);
    s0 = s1;
    s1 = s2 ^ (m & mat1);
    s2 = x ^ (y << 10) ^ (m & mat2);
    s3 = y;
    const uint32_t t1 = s0 + (s2 >> 8);
    const uint32_t t0 = s3 ^ t1;
    return uniform_oo(t0 ^ ((0u - (t1 & 1u)) & tmat));
  }
  L2N_HD void draw2(float& u1, float& u2) {
    u1 = draw1();
    u2 = draw1();
  }

  L2N_HD static TinyMTSampler load(const PtParams&, const uint32_t* st,
                                   size_t plane, size_t pix, uint32_t,
                                   uint32_t) {
    return TinyMTSampler{st[pix],             st[plane + pix],
                         st[2 * plane + pix], st[3 * plane + pix],
                         st[4 * plane + pix], st[5 * plane + pix],
                         st[6 * plane + pix]};
  }
  L2N_HD void next_sample() {}
  L2N_HD void store(uint32_t* st, size_t plane, size_t pix) const {
    st[pix] = s0;
    st[plane + pix] = s1;
    st[2 * plane + pix] = s2;
    st[3 * plane + pix] = s3;
  }
};

// Three Tausworthe steps and one LCG step over the pixel's four state
// planes (rng/tauslcg.py); the XOR of the words, rounded to the nearest
// float32, times 2^-32: a value in [0, 1].
L2N_HD uint32_t taus_step(uint32_t z, int s1, int s2, int s3, uint32_t m) {
  const uint32_t b = ((z << s1) ^ z) >> s2;
  return ((z & m) << s3) ^ b;
}

struct TausLCGSampler {
  uint32_t x, y, z, w;

  L2N_HD float draw1() {
    x = taus_step(x, 13, 19, 12, 4294967294u);
    y = taus_step(y, 2, 25, 4, 4294967288u);
    z = taus_step(z, 3, 11, 17, 4294967280u);
    w = 1664525u * w + 1013904223u;
    return 2.3283064365387e-10f * static_cast<float>(x ^ y ^ z ^ w);
  }
  L2N_HD void draw2(float& u1, float& u2) {
    u1 = draw1();
    u2 = draw1();
  }

  L2N_HD static TausLCGSampler load(const PtParams&, const uint32_t* st,
                                    size_t plane, size_t pix, uint32_t,
                                    uint32_t) {
    return TausLCGSampler{st[pix], st[plane + pix], st[2 * plane + pix],
                          st[3 * plane + pix]};
  }
  L2N_HD void next_sample() {}
  L2N_HD void store(uint32_t* st, size_t plane, size_t pix) const {
    st[pix] = x;
    st[plane + pix] = y;
    st[2 * plane + pix] = z;
    st[3 * plane + pix] = w;
  }
};

// Return F::template run<Rng>(args...) for the sampler type of mode code
// `rng`; -1 for an unknown code. The host entry points launch through it.
template <class F, class... Args>
inline int dispatch_rng(int rng, Args... args) {
  switch (rng) {
    case kRngThreefry:
      return F::template run<ThreefrySampler>(args...);
    case kRngPhilox:
      return F::template run<PhiloxSampler>(args...);
    case kRngTinyMT:
      return F::template run<TinyMTSampler>(args...);
    case kRngTausLCG:
      return F::template run<TausLCGSampler>(args...);
  }
  return -1;
}

// F::template run<Rng, kBody, kFlags...> for the sampler dispatch_rng
// picks: a kernel's instantiation for its body and compile-time settings
// (body_options).
template <class F, int kBody, bool... kFlags>
struct WithBody {
  template <class Rng, class... Args>
  static int run(Args... args) {
    return F::template run<Rng, kBody, kFlags...>(args...);
  }
};

// The fused kernels' bodies (render_pixel): the Lambert path tracer, the
// primary-only AOVs, the materials path tracer, the NEE path tracer (the
// materials body with next event estimation and MIS) and the fog path
// tracer. The wavefront passes take the first three path tracers (the
// config refuses fog with the wavefront split).
constexpr int kBodyLambert = 0;
constexpr int kBodyAovs = 1;
constexpr int kBodyMaterials = 2;
constexpr int kBodyNee = 3;
constexpr int kBodyFog = 4;

// The materials body is taken for a material mode, the bump or explicit
// lights; the empty buffers and the procedural mode take the Lambert body.
L2N_HD bool shades_materials(const PtParams& p) {
  return p.material != 0 || p.normal_map > 0.0f || p.n_point + p.n_dir > 0;
}

// A path tracer's body: NEE whenever it is on, else as shades_materials.
L2N_HD int path_body(const PtParams& p) {
  if (p.nee) return kBodyNee;
  return shades_materials(p) ? kBodyMaterials : kBodyLambert;
}

// The fused kernels' body: the AOVs' for an AOV (fog changes only its
// draw budget), the fog path tracer's whenever fog is on, else path_body.
L2N_HD int fused_body(const PtParams& p) {
  if (p.aov != kAovPathtracing) return kBodyAovs;
  return p.fog ? kBodyFog : path_body(p);
}

// Whether a body reads the material rows of the per-object table.
L2N_HD constexpr bool reads_materials(int body) {
  return body == kBodyMaterials || body == kBodyNee || body == kBodyFog;
}

// The table rows a body reads: the albedo, and the material rows for the
// materials and NEE bodies and for the AOVs' bumped normal.
template <int kBody>
L2N_HD int table_rows(const PtParams& p) {
  return reads_materials(kBody) || (kBody == kBodyAovs && p.normal_map > 0.0f)
             ? 9
             : 3;
}

// The fused kernels' instantiations, twelve per sampler and two more per
// counter-based sampler: F::template run<Rng, kBody, kFast, kViewproj> with
// kBody = fused_body(p), so that the default path tracer's code holds no
// AOV, no material, no NEE and no fog path, kFast = fast_math and
// kViewproj = (ray_gen is viewproj) (with_options). The NEE and fog bodies
// read both at run time (body_options), each instantiated once per
// counter-based sampler (the config refuses NEE and fog with the stateful
// ones).
template <class F, int kBody, class... Args>
inline int dispatch_camera(const PtParams& p, Args... args) {
  const bool vp = p.ray_gen == kRayGenViewproj;
  if (p.fast_math)
    return vp ? dispatch_rng<WithBody<F, kBody, true, true>>(p.rng, args...)
              : dispatch_rng<WithBody<F, kBody, true, false>>(p.rng, args...);
  return vp ? dispatch_rng<WithBody<F, kBody, false, true>>(p.rng, args...)
            : dispatch_rng<WithBody<F, kBody, false, false>>(p.rng, args...);
}

// The same for the counter-based modes only (the wavefront passes, whose
// streams resume across the compaction, and the NEE body); -1 for the
// stateful codes.
template <class F, class... Args>
inline int dispatch_counter_rng(int rng, Args... args) {
  switch (rng) {
    case kRngThreefry:
      return F::template run<ThreefrySampler>(args...);
    case kRngPhilox:
      return F::template run<PhiloxSampler>(args...);
  }
  return -1;
}

template <class F, class... Args>
inline int dispatch_fused(const PtParams& p, Args... args) {
  switch (fused_body(p)) {
    case kBodyAovs:
      return dispatch_camera<F, kBodyAovs>(p, args...);
    case kBodyMaterials:
      return dispatch_camera<F, kBodyMaterials>(p, args...);
    case kBodyNee:
      return dispatch_counter_rng<WithBody<F, kBodyNee, false, false>>(
          p.rng, args...);
    case kBodyFog:
      return dispatch_counter_rng<WithBody<F, kBodyFog, false, false>>(
          p.rng, args...);
  }
  return dispatch_camera<F, kBodyLambert>(p, args...);
}

// The wavefront passes' instantiations, for the counter-based samplers:
// F::template run<Rng, kBody, kFast> (pass B), or F::template run<Rng,
// kBody, kFast, kViewproj> (pass A, which casts the camera rays), with
// kBody = path_body(p) (the split takes no explicit lights); the NEE body
// once per sampler, its options read at run time (body_options).
template <class F, int kBody, class... Args>
inline int dispatch_counter_rng_fast(const PtParams& p, Args... args) {
  return p.fast_math
             ? dispatch_counter_rng<WithBody<F, kBody, true>>(p.rng, args...)
             : dispatch_counter_rng<WithBody<F, kBody, false>>(p.rng, args...);
}

template <class F, class... Args>
inline int dispatch_pass_b(const PtParams& p, Args... args) {
  switch (path_body(p)) {
    case kBodyNee:
      return dispatch_counter_rng<WithBody<F, kBodyNee, false>>(p.rng,
                                                                args...);
    case kBodyMaterials:
      return dispatch_counter_rng_fast<F, kBodyMaterials>(p, args...);
  }
  return dispatch_counter_rng_fast<F, kBodyLambert>(p, args...);
}

template <class F, int kBody, class... Args>
inline int dispatch_counter_rng_camera(const PtParams& p, Args... args) {
  const bool vp = p.ray_gen == kRayGenViewproj;
  if (p.fast_math)
    return vp ? dispatch_counter_rng<WithBody<F, kBody, true, true>>(
                    p.rng, args...)
              : dispatch_counter_rng<WithBody<F, kBody, true, false>>(
                    p.rng, args...);
  return vp ? dispatch_counter_rng<WithBody<F, kBody, false, true>>(
                  p.rng, args...)
            : dispatch_counter_rng<WithBody<F, kBody, false, false>>(
                  p.rng, args...);
}

template <class F, class... Args>
inline int dispatch_pass_a(const PtParams& p, Args... args) {
  switch (path_body(p)) {
    case kBodyNee:
      return dispatch_counter_rng<WithBody<F, kBodyNee, false, false>>(
          p.rng, args...);
    case kBodyMaterials:
      return dispatch_counter_rng_camera<F, kBodyMaterials>(p, args...);
  }
  return dispatch_counter_rng_camera<F, kBodyLambert>(p, args...);
}

// ---------------------------------------------------------------------------
// Math (maths/sampling.py, maths/fastmath.py), float32, JAX operation order.
// ---------------------------------------------------------------------------

// 1 / sqrt(x) of the fast-math sites: the card's rsqrtf (approximate,
// never built with --use_fast_math, so no other site changes). The host
// build has no rsqrtf and takes the correctly rounded 1 / sqrtf(x): that is
// the CPU twin's fast path (maths/sampling.py rsqrt on the CPU), not the
// card's. Both give inf at 0 and NaN below.
L2N_HD float rsqrt_fast(float x) {
#if defined(__CUDA_ARCH__)
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// 1 / |v| for the squared length nn: exact, or rsqrt under fast_math.
L2N_HD float rcp_len(float nn, bool fast) {
  return fast ? rsqrt_fast(nn) : 1.0f / sqrtf(nn);
}

L2N_HD void normalize3(float& x, float& y, float& z, bool fast) {
  const float rcp = rcp_len(x * x + y * y + z * z, fast);
  x = x * rcp;
  y = y * rcp;
  z = z * rcp;
}

L2N_HD float luminance(float r, float g, float b) {
  return 0.212671f * r + 0.715160f * g + 0.072169f * b;
}

// The minimax atan2 of maths/fastmath.py (not atan2f: the sky's escape
// counts are quantized, and another arctangent flips them).
L2N_HD float poly_atan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = ax > ay ? ax : ay;
  const float lo = ax < ay ? ax : ay;
  const float t = lo / (hi > 1e-37f ? hi : 1e-37f);
  const float s = t * t;
  float p = -0.01172120f;
  p = p * s + 0.05265332f;
  p = p * s + -0.11643287f;
  p = p * s + 0.19354346f;
  p = p * s + -0.33262347f;
  p = p * s + 0.99997726f;
  float a = t * p;
  if (ay > ax) a = static_cast<float>(kPi / 2.0) - a;
  if (x < 0.0f) a = static_cast<float>(kPi) - a;
  return y < 0.0f ? -a : a;
}

// Mandelbrot sky (ops/envlight.py): 0 outside the direction box where
// |p| > 2 (exact), else i/64 at the first escape, 0 if bounded. Runs only
// for paths that end on a miss.
L2N_HD float mandelbrot_le(float dx, float dy, float dz) {
  if (!(dx >= fabsf(dy) && dz * dz <= dx * dx + dy * dy)) return 0.0f;
  const float sin_theta = sqrtf(dx * dx + dy * dy);
  const float theta = poly_atan2(sin_theta, dz);
  const float phi = poly_atan2(dy, dx);
  const float u = phi * static_cast<float>(1.0 / kPi);
  const float v = -1.0f + static_cast<float>(2.0 / kPi) * theta;
  const float px = 8.0f * u, py = 4.0f * v;
  float zx = 0.0f, zy = 0.0f, zx2 = 0.0f, zy2 = 0.0f;
  int cnt = 0;
  for (; cnt < kMandelbrotIters; ++cnt) {
    zy = 2.0f * zx * zy + py;
    zx = zx2 - zy2 + px;
    zx2 = zx * zx;
    zy2 = zy * zy;
    if (!(zx2 + zy2 <= 4.0f)) break;
  }
  return cnt < kMandelbrotIters
             ? static_cast<float>(cnt) * (1.0f / kMandelbrotIters)
             : 0.0f;
}

// The sun lobe (ops/envlight.py::sun_le): pow(max(0, dot(s, d)), 128)
// with s = normalize(1, 1, -1), each component float32(1 / sqrt 3), the
// power as 7 squarings.
L2N_HD float sun_le(float dx, float dy, float dz) {
  const float s = 0.57735026918962576f;
  float d = s * dx + s * dy - s * dz;
  d = d < 0.0f ? 0.0f : d;
  for (int i = 0; i < 7; ++i) d = d * d;
  return d;
}

L2N_HD float env_le(const PtParams& p, float dx, float dy, float dz) {
  switch (p.env) {
    case kEnvMandelbrot:
      return mandelbrot_le(dx, dy, dz) * p.env_scale;
    case kEnvSun:
      return sun_le(dx, dy, dz) * p.env_scale;
  }
  return 0.0f;
}

L2N_HD float emit_term(const PtParams& p, float r2) {
  return p.emission_scale /
         (static_cast<float>(4.0 * kPi) * (r2 > 1e-20f ? r2 : 1e-20f));
}

// Resolved hit (ops/pathtrace.py::Hit). Spheres leave the texcoords and
// barycentrics at 0.
struct Hit {
  float t;  // -1 on miss
  float nx, ny, nz;
  int index;  // sphere or mesh index, -1 on miss
  float r2;   // emission radius^2 (1 for meshes)
  float tc_u, tc_v, b_u, b_v;
};

// ---------------------------------------------------------------------------
// One path sample (ops/pathtrace.py::trace_path for the port's config).
// ---------------------------------------------------------------------------

// A tangent frame around the normal z = (zx, zy, zz) (maths/sampling.py
// frame_z): the tangent from the smaller of |z.x|, |z.y|, its length exact
// or, with `fast`, by rsqrt; the bitangent z x t.
struct Frame {
  float zx, zy, zz, tx, ty, tz, bx, by, bz;
};

L2N_HD Frame frame_z(float zx, float zy, float zz, bool fast) {
  Frame f;
  f.zx = zx;
  f.zy = zy;
  f.zz = zz;
  if (fabsf(zy) > fabsf(zx)) {
    const float rcp = rcp_len(zx * zx + zy * zy, fast);
    f.tx = zy * rcp;
    f.ty = -zx * rcp;
    f.tz = 0.0f;
  } else {
    const float rcp = rcp_len(zx * zx + zz * zz, fast);
    f.tx = zz * rcp;
    f.ty = 0.0f;
    f.tz = -zx * rcp;
  }
  f.bx = zy * f.tz - zz * f.ty;
  f.by = zz * f.tx - zx * f.tz;
  f.bz = zx * f.ty - zy * f.tx;
  return f;
}

// The cosine-weighted hemisphere direction of draws (u1, u2) in frame f,
// not normalized (local to world).
L2N_HD void hemisphere_direction(const Frame& f, float u1, float u2,
                                 float& dx, float& dy, float& dz) {
  const float r = sqrtf(u1);
  const float phi = static_cast<float>(2.0 * kPi) * u2;
  const float one_m = 1.0f - u1;
  const float lz = sqrtf(one_m > 0.0f ? one_m : 0.0f);
  const float lx = r * cosf(phi);
  const float ly = r * sinf(phi);
  dx = f.tx * lx + f.bx * ly + f.zx * lz;
  dy = f.ty * lx + f.by * ly + f.zy * lz;
  dz = f.tz * lx + f.bz * ly + f.zz * lz;
}

}  // namespace l2n

#include "brdf.cuh"

namespace l2n {

// Russian roulette on the throughput tp after the scatter: survive with
// p = min(rr_ceiling, luminance(tp)), survivors' tp / p. Returns false when
// the path dies.
template <class Rng>
L2N_HD bool roulette(const PtParams& p, Rng& rng, float tp[3]) {
  const float rr = rng.draw1();
  const float lum = luminance(tp[0], tp[1], tp[2]);
  const float rr_prob = lum < p.rr_ceiling ? lum : p.rr_ceiling;
  if (!(rr < rr_prob)) return false;
  const float rcp_p = 1.0f / (rr_prob > 1e-20f ? rr_prob : 1e-20f);
  tp[0] = tp[0] * rcp_p;
  tp[1] = tp[1] * rcp_p;
  tp[2] = tp[2] * rcp_p;
  return true;
}

// Procedural-Lambert bounce at the diffuse vertex with normal h.n and
// albedo row `h.index`: cosine-sampled new direction d, throughput times
// albedo, Russian roulette. Returns false when the path dies.
template <class Scene, class Rng>
L2N_HD bool scatter_and_roulette(const PtParams& p, const Scene& s, Rng& rng,
                                 const Hit& h, float& dx,
                                 float& dy, float& dz, float tp[3]) {
  const bool fast = p.fast_math != 0;
  const Frame f = frame_z(h.nx, h.ny, h.nz, fast);
  float u1, u2;
  rng.draw2(u1, u2);
  hemisphere_direction(f, u1, u2, dx, dy, dz);
  normalize3(dx, dy, dz, fast);

  tp[0] = tp[0] * s.ar[h.index];
  tp[1] = tp[1] * s.ag[h.index];
  tp[2] = tp[2] * s.ab[h.index];
  return roulette(p, rng, tp);
}

// The explicit lights' direct radiance at the vertex (hx, hy, hz) with the
// shading normal n (normalized here again, ops/lights.py), added to col
// times the throughput tp before the scatter. eval(wi, f) fills f with the
// BSDF for the direction wi. Each light whose cosine is positive casts a
// nearest-hit shadow ray over the whole scene (a light facing away adds
// f I 0 whatever the cast finds, so its cast is skipped). No draws. With
// kFog (the fog body) a point light's term takes the Beer-Lambert factor
// exp(-sigma dist), a directional light's the host's transmittance.
template <bool kFog, class Scene, class Eval>
L2N_HD void explicit_lights(const PtParams& p, const Scene& s, float hx,
                            float hy, float hz, float nx, float ny, float nz,
                            const Eval& eval, const float tp[3],
                            float col[3]) {
  normalize3(nx, ny, nz, false);
  const float eps = p.ray_epsilon;
  float out[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < p.n_point + p.n_dir; ++i) {
    const float* row = p.lights + 6 * i;
    float wi[3], w;
    if (i < p.n_point) {
      wi[0] = row[0] - hx;
      wi[1] = row[1] - hy;
      wi[2] = row[2] - hz;
      const float d2 = wi[0] * wi[0] + wi[1] * wi[1] + wi[2] * wi[2];
      const float dist = sqrtf(max_nan(d2, 1e-20f));
      const float rcp = 1.0f / dist;
      for (int c = 0; c < 3; ++c) wi[c] = wi[c] * rcp;
      const float cos_s = max_nan(nx * wi[0] + ny * wi[1] + nz * wi[2], 0.0f);
      w = cos_s / max_nan(d2, 1e-20f);
      if constexpr (kFog) w = w * expf(-p.fog_sigma * dist);
      if (cos_s != 0.0f) {
        const float t = s.nearest(hx + eps * wi[0], hy + eps * wi[1],
                                  hz + eps * wi[2], wi[0], wi[1], wi[2])
                            .t;
        if (!(t < 0.0f || t >= dist - 2.0f * eps)) w = 0.0f;
      }
    } else {
      wi[0] = row[0];
      wi[1] = row[1];
      wi[2] = row[2];
      const float cos_s = max_nan(nx * wi[0] + ny * wi[1] + nz * wi[2], 0.0f);
      w = cos_s;
      if constexpr (kFog) w = w * p.fog_dir_transmit;
      if (cos_s != 0.0f &&
          !(s.nearest(hx + eps * wi[0], hy + eps * wi[1], hz + eps * wi[2],
                      wi[0], wi[1], wi[2])
                .t < 0.0f))
        w = 0.0f;
    }
    float f[3];
    eval(wi, f);
    for (int c = 0; c < 3; ++c) out[c] = out[c] + f[c] * row[3 + c] * w;
  }
  for (int c = 0; c < 3; ++c) col[c] = col[c] + tp[c] * out[c];
}

// ---------------------------------------------------------------------------
// Next event estimation and MIS (ops/nee.py), float32 in its order. The
// scene type says how its lights are sampled (Scene::kConeLights) and
// gives light i's sphere: the sphere itself, or the mesh's bounding sphere
// (Scene::bound). fast_math reaches none of these sites.
// ---------------------------------------------------------------------------

// The scene index of the light NEE picks with u_pick: e = min(int(u_pick
// E), E - 1) of the E = n_lights lights, index e * emissive_every.
L2N_HD int pick_light(const PtParams& p, float u_pick) {
  int e = static_cast<int>(u_pick * static_cast<float>(p.n_lights));
  e = e < p.n_lights - 1 ? e : p.n_lights - 1;
  return e * p.emissive_every;
}

// Omega = 2 pi (1 - cos_max) of a sphere of squared radius r2 seen from
// squared distance d2; 4 pi (cos_max = -1) from inside it.
L2N_HD float cone_solid_angle(float d2, float r2, float& cos_max) {
  cos_max = sqrtf(max_nan(1.0f - r2 / max_nan(d2, 1e-20f), 0.0f));
  if (d2 <= r2) cos_max = -1.0f;
  return static_cast<float>(2.0 * kPi) * (1.0f - cos_max);
}

// Balance weight w p_nee / (p_nee + p_bsdf).
L2N_HD float balance(float w, float p_nee, float p_bsdf) {
  return w * p_nee / max_nan(p_nee + p_bsdf, 1e-20f);
}

// Add tp f w to col for the light direction l, eval(l, cos_s, f) filling
// f and returning the BSDF's pdf, and `weight(p_bsdf)` the sample's w: the
// shadow ray is cast (visible(), true when it counts) only where w is not
// 0, whose product would be 0 whatever the cast found.
template <class Eval, class Weight, class Visible>
L2N_HD void add_light(const float l[3], float cos_s, const Eval& eval,
                      const Weight& weight, const Visible& visible,
                      const float tp[3], float col[3]) {
  float f[3];
  const float p_bsdf = eval(l, cos_s, f);
  float w = weight(p_bsdf);
  if (w != 0.0f && !visible()) w = 0.0f;
  for (int c = 0; c < 3; ++c) col[c] = col[c] + tp[c] * f[c] * w;
}

// Area NEE (nee_contribution) at the vertex h with shading normal n, taken
// as given: a uniform point on the picked sphere from (ul1, ul2), one
// nearest-hit shadow ray over the whole scene, visible iff the picked
// sphere is the first thing hit. With kFog the sample takes the
// Beer-Lambert factor exp(-sigma d) over its distance d to the point.
template <bool kFog, class Scene, class Eval>
L2N_HD void nee_area(const PtParams& p, const Scene& s, float u_pick,
                     float ul1, float ul2, const float h[3], const float n[3],
                     bool mis, const Eval& eval, const float tp[3],
                     float col[3]) {
  const int li = pick_light(p, u_pick);
  float cx, cy, cz, sr2;
  s.bound(li, cx, cy, cz, sr2);
  const float r = sqrtf(sr2);
  const float z = 1.0f - 2.0f * ul1;
  const float sz = sqrtf(max_nan(1.0f - z * z, 0.0f));
  const float phi = static_cast<float>(2.0 * kPi) * ul2;
  const float wx = sz * cosf(phi), wy = sz * sinf(phi);
  float l[3] = {cx + r * wx - h[0], cy + r * wy - h[1], cz + r * z - h[2]};
  const float d2 = l[0] * l[0] + l[1] * l[1] + l[2] * l[2];
  const float dist = sqrtf(max_nan(d2, 1e-20f));
  const float rcp = 1.0f / dist;
  for (int c = 0; c < 3; ++c) l[c] = l[c] * rcp;
  const float cos_s = max_nan(n[0] * l[0] + n[1] * l[1] + n[2] * l[2], 0.0f);
  const float cos_l = max_nan(-(wx * l[0] + wy * l[1] + z * l[2]), 0.0f);
  const float e = static_cast<float>(p.n_lights);
  add_light(
      l, cos_s, eval,
      [&](float p_bsdf) {
        float w = p.nee_scale * cos_s * cos_l / max_nan(d2, 1e-20f);
        if (mis) {
          const float area =
              static_cast<float>(4.0 * kPi) * max_nan(r * r, 1e-20f);
          const float p_nee = d2 / max_nan(area * cos_l * e, 1e-20f);
          w = balance(w, p_nee, p_bsdf);
        }
        if constexpr (kFog) w = w * expf(-p.fog_sigma * dist);
        return w;
      },
      [&] {
        const float eps = p.ray_epsilon;
        return s.nearest(h[0] + eps * l[0], h[1] + eps * l[1],
                         h[2] + eps * l[2], l[0], l[1], l[2])
                   .index == li;
      },
      tp, col);
}

// Cone NEE (nee_cone_contribution) at the vertex h with shading normal n
// (normalized here): a direction uniform in the cone of the picked mesh's
// bounding sphere, traced through the whole scene, counted iff it hits
// that mesh. With kFog the sample takes the Beer-Lambert factor
// exp(-sigma t) over the traced distance t.
template <bool kFog, class Scene, class Eval>
L2N_HD void nee_cone(const PtParams& p, const Scene& s, float u_pick,
                     float ul1, float ul2, const float h[3], const float n[3],
                     bool mis, const Eval& eval, const float tp[3],
                     float col[3]) {
  const int li = pick_light(p, u_pick);
  float cx, cy, cz, r2;
  s.bound(li, cx, cy, cz, r2);
  float ax = cx - h[0], ay = cy - h[1], az = cz - h[2];
  const float d2 = ax * ax + ay * ay + az * az;
  float cos_max;
  const float omega = cone_solid_angle(d2, r2, cos_max);
  normalize3(ax, ay, az, false);
  const float cos_t = 1.0f - ul1 * (1.0f - cos_max);
  const float sin_t = sqrtf(max_nan(1.0f - cos_t * cos_t, 0.0f));
  const float phi = static_cast<float>(2.0 * kPi) * ul2;
  const Frame f = frame_z(ax, ay, az, false);
  const float lx = sin_t * cosf(phi), ly = sin_t * sinf(phi);
  const float l[3] = {f.tx * lx + f.bx * ly + f.zx * cos_t,
                      f.ty * lx + f.by * ly + f.zy * cos_t,
                      f.tz * lx + f.bz * ly + f.zz * cos_t};
  float nh[3] = {n[0], n[1], n[2]};
  normalize3(nh[0], nh[1], nh[2], false);
  const float cos_s =
      max_nan(nh[0] * l[0] + nh[1] * l[1] + nh[2] * l[2], 0.0f);
  const float e = static_cast<float>(p.n_lights);
  const auto weight = [&](float p_bsdf) {
    const float w = cos_s * p.nee_le * e * omega;
    if (!mis) return w;
    return balance(w, 1.0f / max_nan(e * omega, 1e-20f), p_bsdf);
  };
  const auto cast = [&] {
    const float eps = p.ray_epsilon;
    return s.nearest(h[0] + eps * l[0], h[1] + eps * l[1], h[2] + eps * l[2],
                     l[0], l[1], l[2]);
  };
  if constexpr (kFog) {
    // add_light with the cast's distance in the factor.
    float f[3];
    float w = weight(eval(l, cos_s, f));
    if (w != 0.0f) {
      const Hit sh = cast();
      w = sh.t >= 0.0f && sh.index == li ? w * expf(-p.fog_sigma * sh.t)
                                         : 0.0f;
    }
    for (int c = 0; c < 3; ++c) col[c] = col[c] + tp[c] * f[c] * w;
  } else {
    add_light(
        l, cos_s, eval, weight,
        [&] {
          const Hit sh = cast();
          return sh.t >= 0.0f && sh.index == li;
        },
        tp, col);
  }
}

// NEE at a diffuse vertex of bounce b, after the scatter's draws: draw1 the
// light pick, draw2 the point (or the cone's direction), then the scene's
// sampler (with kFog, fog's transmittance). MIS weighs it but at the last
// bounce, whose BSDF ray collects no emission (the loop truncates there).
template <bool kFog, class Scene, class Rng, class Eval>
L2N_HD void next_event(const PtParams& p, const Scene& s, Rng& rng, int b,
                       const float h[3], const float n[3], const Eval& eval,
                       const float tp[3], float col[3]) {
  const float u_pick = rng.draw1();
  float ul1, ul2;
  rng.draw2(ul1, ul2);
  const bool mis = p.mis != 0 && b + 1 < p.max_bounces;
  if constexpr (Scene::kConeLights)
    nee_cone<kFog>(p, s, u_pick, ul1, ul2, h, n, mis, eval, tp, col);
  else
    nee_area<kFog>(p, s, u_pick, ul1, ul2, h, n, mis, eval, tp, col);
}

// MIS weight (mis_emission_weight) of the emission that a BSDF ray of
// direction d and pdf prev_pdf found at the hit h: prev_pdf / (prev_pdf +
// p_nee), p_nee NEE's pdf of the same direction, over the light's surface
// (area) or over its bound's cone (cone; the bound's centre rebuilt as the
// hit minus the hit normal times the bound's radius).
template <class Scene>
L2N_HD float mis_emission_weight(const PtParams& p, const Scene& s,
                                 float prev_pdf, float dx, float dy, float dz,
                                 const Hit& h) {
  const float e = static_cast<float>(p.n_lights);
  float p_nee;
  if constexpr (Scene::kConeLights) {
    float cx, cy, cz, br2;
    s.bound(h.index, cx, cy, cz, br2);
    const float r = sqrtf(max_nan(br2, 1e-20f));
    const float vx = h.t * dx - h.nx * r;
    const float vy = h.t * dy - h.ny * r;
    const float vz = h.t * dz - h.nz * r;
    float cos_max;
    const float omega =
        cone_solid_angle(vx * vx + vy * vy + vz * vz, br2, cos_max);
    p_nee = 1.0f / max_nan(e * omega, 1e-20f);
  } else {
    float nx = h.nx, ny = h.ny, nz = h.nz;
    normalize3(nx, ny, nz, false);
    const float cos_l = max_nan(-(nx * dx + ny * dy + nz * dz), 0.0f);
    const float area = static_cast<float>(4.0 * kPi) * max_nan(h.r2, 1e-20f);
    p_nee = h.t * h.t / max_nan(area * cos_l * e, 1e-20f);
  }
  return prev_pdf / max_nan(prev_pdf + p_nee, 1e-20f);
}

// What scatter_materials adds at a surface vertex: nothing more (the
// materials body), NEE (the NEE body), or, for the fog body, NEE when
// p.nee is on and fog's transmittance on NEE and the explicit lights.
constexpr int kScatterPlain = 0;
constexpr int kScatterNee = 1;
constexpr int kScatterFog = 2;

// The materials body's bounce at the diffuse vertex (hx, hy, hz) of hit h
// (ops/pathtrace.py::_scatter_and_roulette): the bump of the shading
// normal (normal_map > 0); the procedural Lambert sample as
// scatter_and_roulette draws it, or the material mode's mixture (exact
// frame around the normalized normal, then draw2 for (u1, u2) and draw1
// for the lobe); with NEE (kMode), NEE at bounce b (next_event) and the
// sampled direction's pdf in `pdf` for the next vertex's MIS weight; the
// explicit lights' direct term into col; the throughput update and
// Russian roulette. Returns false when the path dies.
template <int kMode, class Scene, class Rng>
L2N_HD bool scatter_materials(const PtParams& p, const Scene& s, Rng& rng,
                              const Hit& h, float hx, float hy, float hz,
                              int b, float& dx, float& dy, float& dz,
                              float tp[3], float& pdf, float col[3]) {
  const int i = h.index;
  const float kd[3] = {s.ar[i], s.ag[i], s.ab[i]};
  const Material m = material_row(s.mat, s.n, i);
  float nx = h.nx, ny = h.ny, nz = h.nz;
  if (p.normal_map > 0.0f) perturb_normal(p, m.bump, hx, hy, hz, nx, ny, nz);
  float w[3];
  const bool lights = p.n_point + p.n_dir > 0;
  const float hv[3] = {hx, hy, hz};
  const float nv[3] = {nx, ny, nz};
  if (p.material != kMaterialProcedural) {
    float n[3] = {nx, ny, nz};
    normalize3(n[0], n[1], n[2], false);
    const Frame fr = frame_z(n[0], n[1], n[2], false);
    const float wo[3] = {-dx, -dy, -dz};
    float u1, u2;
    rng.draw2(u1, u2);
    const float u_lobe = rng.draw1();
    float wi[3];
    const float pdf_b =
        sample_material(p.material, u_lobe, u1, u2, fr, wo, kd, m, wi, w);
    if constexpr (kMode != kScatterPlain) {
      if (kMode == kScatterNee || p.nee) {
        pdf = pdf_b;
        next_event<kMode == kScatterFog>(
            p, s, rng, b, hv, nv,
            [&](const float* l, float, float* f) {
              return eval_material(p.material, n, wo, l, kd, m, f);
            },
            tp, col);
      }
    }
    if (lights)
      explicit_lights<kMode == kScatterFog>(
          p, s, hx, hy, hz, nx, ny, nz,
          [&](const float* l, float* f) {
            eval_material(p.material, n, wo, l, kd, m, f);
          },
          tp, col);
    dx = wi[0];
    dy = wi[1];
    dz = wi[2];
  } else {
    const bool fast = p.fast_math != 0;
    const Frame f = frame_z(nx, ny, nz, fast);
    float u1, u2;
    rng.draw2(u1, u2);
    if constexpr (kMode != kScatterPlain) {
      if (kMode == kScatterNee || p.nee) {
        const float one_m = 1.0f - u1;
        pdf = sqrtf(one_m > 0.0f ? one_m : 0.0f) * kInvPi;  // local cos / pi
        next_event<kMode == kScatterFog>(
            p, s, rng, b, hv, nv,
            [&](const float*, float cos_s, float* fl) {
              for (int c = 0; c < 3; ++c) fl[c] = kd[c] * kInvPi;
              return cos_s * kInvPi;
            },
            tp, col);
      }
    }
    if (lights)
      explicit_lights<kMode == kScatterFog>(
          p, s, hx, hy, hz, nx, ny, nz,
          [&](const float*, float* fl) {
            for (int c = 0; c < 3; ++c) fl[c] = kd[c] * kInvPi;
          },
          tp, col);
    hemisphere_direction(f, u1, u2, dx, dy, dz);
    normalize3(dx, dy, dz, fast);
    for (int c = 0; c < 3; ++c) w[c] = kd[c];
  }
  for (int c = 0; c < 3; ++c) tp[c] = tp[c] * w[c];
  return roulette(p, rng, tp);
}

// A path's pending cast: origin, direction, throughput and, for the NEE
// body's MIS, the pdf of the sampled direction (the wavefront split's ray
// planes). A path with no cast left has its origin parked at kFar, as the
// lockstep tracer does.
constexpr float kFar = 3.0e30f;
struct Continuation {
  float ox, oy, oz;
  float dx, dy, dz;
  float tp[3];
  float pdf;
};

// Trace a path from its pending cast c at iteration b (b = 0: the primary
// ray, throughput 1), adding the radiance it finds to col. The tri-state
// `dist` of the lockstep tracer (ops/pathtrace.py::trace_path) becomes
// control flow: an emissive hit adds its emission and ends the path, a miss
// adds the sky, Russian roulette ends it silently, and the cast of
// iteration max_bounces - 1 takes an any-hit test, then the sky.
// kFirstVertex stops after iteration b's scatter and returns whether the
// path goes on, with its new cast in c; c keeps the scattered direction and
// throughput of a path that roulette ended. kBody (a path tracer's body,
// path_body) scatters with the Lambert scatter_and_roulette, or with
// scatter_materials, with NEE for kBodyNee. Under NEE the lockstep tracer's
// emission_ok plane is the iteration: every vertex b >= 1 follows one that
// did NEE, so the emission found there is dropped without MIS and weighed
// with it (mis_emission_weight); camera-direct emission (b = 0) is kept.
template <bool kFirstVertex, int kBody, class Scene, class Rng>
L2N_HD bool trace_from(const PtParams& p, const Scene& s, Rng& rng, int b,
                       Continuation& c, float col[3]) {
  // Vertex base: the JAX tracer places vertices 0 and 1 from the cast
  // origin (the camera, then the first cast) and later vertices from the
  // previous vertex (its `box` carry); follow it.
  float bx = c.ox, by = c.oy, bz = c.oz;
  for (;; ++b) {
    if (b == p.max_bounces) {  // last segment: any-hit, then sky
      if (!s.anyhit(c.ox, c.oy, c.oz, c.dx, c.dy, c.dz)) {
        const float le = env_le(p, c.dx, c.dy, c.dz);
        for (int ch = 0; ch < 3; ++ch) col[ch] = col[ch] + c.tp[ch] * le;
      }
      return false;
    }
    // b = 0 is the primary cast: trace_sample and trace_primary start it
    // at the camera.
    const Hit h =
        b == 0 ? s.nearest_primary(c.ox, c.oy, c.oz, c.dx, c.dy, c.dz)
               : s.nearest(c.ox, c.oy, c.oz, c.dx, c.dy, c.dz);
    if (h.t == -1.0f) {
      const float le = env_le(p, c.dx, c.dy, c.dz);
      for (int ch = 0; ch < 3; ++ch) col[ch] = col[ch] + c.tp[ch] * le;
      return false;
    }
    if (h.index % p.emissive_every == 0) {
      float e = emit_term(p, h.r2);
      if constexpr (kBody == kBodyNee) {
        if (b > 0) {
          if (!p.mis) return false;
          e = e * mis_emission_weight(p, s, c.pdf, c.dx, c.dy, c.dz, h);
        }
      }
      for (int ch = 0; ch < 3; ++ch) col[ch] = col[ch] + c.tp[ch] * e;
      return false;
    }
    const float hx = bx + h.t * c.dx, hy = by + h.t * c.dy,
                hz = bz + h.t * c.dz;
    bool alive;
    if constexpr (kBody == kBodyLambert)
      alive = scatter_and_roulette(p, s, rng, h, c.dx, c.dy, c.dz, c.tp);
    else
      alive = scatter_materials<kBody == kBodyNee ? kScatterNee
                                                  : kScatterPlain>(
          p, s, rng, h, hx, hy, hz, b, c.dx, c.dy, c.dz, c.tp, c.pdf, col);
    if (!alive) return false;
    c.ox = hx + p.ray_epsilon * c.dx;
    c.oy = hy + p.ray_epsilon * c.dy;
    c.oz = hz + p.ray_epsilon * c.dz;
    if (b == 0) {
      bx = c.ox;
      by = c.oy;
      bz = c.oz;
    } else {
      bx = hx;
      by = hy;
      bz = hz;
    }
    if (kFirstVertex) return true;
  }
}

// The first vertex of one sample along the primary ray (ox, oy, oz) + t (dx,
// dy, dz) (ops/pathtrace.py::trace_wavefront_primary): col gets the primary
// radiance (emission, or the sky of a miss; at a diffuse hit the NEE
// body's direct light, else 0), c the b=0 scatter's direction, throughput
// and pdf and, for a survivor of Russian roulette, its cast origin; the
// others are parked at kFar. Returns true when the path goes on.
template <int kBody, class Scene, class Rng>
L2N_HD bool trace_primary(const PtParams& p, const Scene& s, Rng& rng,
                          float ox, float oy, float oz, float dx, float dy,
                          float dz, float col[3], Continuation& c) {
  col[0] = col[1] = col[2] = 0.0f;
  c = Continuation{ox, oy, oz, dx, dy, dz, {1.0f, 1.0f, 1.0f}, 1.0f};
  const bool alive = trace_from<true, kBody>(p, s, rng, 0, c, col);
  if (!alive) c.ox = c.oy = c.oz = kFar;
  return alive;
}

// The rest of a path from its first cast c: bounces 1 .. max_bounces-1 and
// the last segment (ops/pathtrace.py::trace_wavefront_continue).
template <int kBody, class Scene, class Rng>
L2N_HD void trace_continue(const PtParams& p, const Scene& s, Rng& rng,
                           Continuation c, float col[3]) {
  trace_from<false, kBody>(p, s, rng, 1, c, col);
}

// Collision sampling (ops/pathtrace.py::_fog_collision): the distance
// -log(u) / sigma to the next collision in the fog, from one draw1.
template <class Rng>
L2N_HD float fog_distance(const PtParams& p, Rng& rng) {
  return -logf(rng.draw1()) * p.fog_inv_sigma;
}

// The fog body's bounce at a fog vertex (ops/pathtrace.py::
// _scatter_and_roulette's medium lanes): every draw a surface vertex of
// the material mode takes (the pair, the lobe's draw1 in the material
// modes, NEE's pick and point with NEE on), the isotropic direction from
// the pair, the weight fog_albedo, and Russian roulette. No NEE, no
// explicit light: it casts nothing. Returns false when the path dies.
template <class Rng>
L2N_HD bool scatter_medium(const PtParams& p, Rng& rng, float& dx, float& dy,
                           float& dz, float tp[3]) {
  float u1, u2, unused;
  rng.draw2(u1, u2);
  if (p.material != kMaterialProcedural) rng.draw1();
  if (p.nee) {
    rng.draw1();
    rng.draw2(unused, unused);
  }
  const float mz = 1.0f - 2.0f * u1;
  const float ms = sqrtf(max_nan(1.0f - mz * mz, 0.0f));
  const float phi = static_cast<float>(2.0 * kPi) * u2;
  dx = ms * cosf(phi);
  dy = ms * sinf(phi);
  dz = mz;
  for (int c = 0; c < 3; ++c) tp[c] = tp[c] * p.fog_albedo;
  return roulette(p, rng, tp);
}

// One sample of the fog body (ops/pathtrace.py::trace_path with
// fog_density > 0), the materials body's path with homogeneous fog. Each
// segment draws its collision right after its cast; one before the
// segment's hit (or, on a miss, before the sky shell) makes a fog vertex
// at t_fog along it, from the vertex base trace_from uses, never
// emissive: it scatters with scatter_medium. A surface vertex scatters
// with scatter_materials, NEE and the explicit lights taking fog's
// transmittance. Emission a BSDF ray finds at b >= 1 under NEE: kept
// whole after a fog vertex (which took no NEE: the lockstep tracer's
// emission_ok 1 without MIS, 2 with it), else dropped without MIS and
// weighed with it. The last segment's any-hit: the sky needs a miss and
// no collision before the sky shell.
template <class Scene, class Rng>
L2N_HD void trace_fog(const PtParams& p, const Scene& s, Rng& rng, float ox,
                      float oy, float oz, float dx, float dy, float dz,
                      float col[3]) {
  col[0] = col[1] = col[2] = 0.0f;
  float tp[3] = {1.0f, 1.0f, 1.0f};
  float pdf = 1.0f;
  bool after_fog = false;
  float bx = ox, by = oy, bz = oz;  // the vertex base, as in trace_from
  for (int b = 0;; ++b) {
    if (b == p.max_bounces) {
      const bool hit = s.anyhit(ox, oy, oz, dx, dy, dz);
      const float t_fog = fog_distance(p, rng);
      if (!hit && !(t_fog < p.fog_sky)) {
        const float le = env_le(p, dx, dy, dz);
        for (int ch = 0; ch < 3; ++ch) col[ch] = col[ch] + tp[ch] * le;
      }
      return;
    }
    const Hit h = b == 0 ? s.nearest_primary(ox, oy, oz, dx, dy, dz)
                         : s.nearest(ox, oy, oz, dx, dy, dz);
    const float t_fog = fog_distance(p, rng);
    const bool medium = t_fog < (h.t >= 0.0f ? h.t : p.fog_sky);
    if (!medium) {
      if (h.t == -1.0f) {
        const float le = env_le(p, dx, dy, dz);
        for (int ch = 0; ch < 3; ++ch) col[ch] = col[ch] + tp[ch] * le;
        return;
      }
      if (h.index % p.emissive_every == 0) {
        float e = emit_term(p, h.r2);
        if (b > 0 && p.nee && !after_fog) {
          if (!p.mis) return;
          e = e * mis_emission_weight(p, s, pdf, dx, dy, dz, h);
        }
        for (int ch = 0; ch < 3; ++ch) col[ch] = col[ch] + tp[ch] * e;
        return;
      }
    }
    const float t = medium ? t_fog : h.t;
    const float hx = bx + t * dx, hy = by + t * dy, hz = bz + t * dz;
    const bool alive =
        medium ? scatter_medium(p, rng, dx, dy, dz, tp)
               : scatter_materials<kScatterFog>(p, s, rng, h, hx, hy, hz, b,
                                                dx, dy, dz, tp, pdf, col);
    if (!alive) return;
    after_fog = medium;
    ox = hx + p.ray_epsilon * dx;
    oy = hy + p.ray_epsilon * dy;
    oz = hz + p.ray_epsilon * dz;
    if (b == 0) {
      bx = ox;
      by = oy;
      bz = oz;
    } else {
      bx = hx;
      by = hy;
      bz = hz;
    }
  }
}

// Radiance of one sample (ops/pathtrace.py::trace_path): the whole path in
// one loop.
template <int kBody, class Scene, class Rng>
L2N_HD void trace_sample(const PtParams& p, const Scene& s, Rng& rng,
                         float ox, float oy, float oz, float dx, float dy,
                         float dz, float col[3]) {
  if constexpr (kBody == kBodyFog) {
    trace_fog(p, s, rng, ox, oy, oz, dx, dy, dz, col);
  } else {
    col[0] = col[1] = col[2] = 0.0f;
    Continuation c{ox, oy, oz, dx, dy, dz, {1.0f, 1.0f, 1.0f}, 1.0f};
    trace_from<false, kBody>(p, s, rng, 0, c, col);
  }
}

// One-bounce white-sky ambient occlusion at the primary hit h of the ray
// (o, d) (ops/pathtrace.py::aov_ambient_occlusion): only a hit draws (a
// stateful sampler's miss lane does not step), a cosine sample around the
// hit's normal in the exact frame (fast_math or not), a nearest-hit cast
// from the hit plus ray_epsilon along the unnormalized sample; 1 where it
// misses.
template <class Scene, class Rng>
L2N_HD float ambient_occlusion(const PtParams& p, const Scene& s, Rng& rng,
                               const Hit& h, float ox, float oy, float oz,
                               float dx, float dy, float dz) {
  if (!(h.t >= 0.0f)) return 0.0f;
  const Frame f = frame_z(h.nx, h.ny, h.nz, false);
  float u1, u2;
  rng.draw2(u1, u2);
  float wx, wy, wz;
  hemisphere_direction(f, u1, u2, wx, wy, wz);
  const float sx = ox + h.t * dx + p.ray_epsilon * wx;
  const float sy = oy + h.t * dy + p.ray_epsilon * wy;
  const float sz = oz + h.t * dz + p.ray_epsilon * wz;
  return s.occluded(sx, sy, sz, wx, wy, wz) ? 0.0f : 1.0f;
}

// The primary-only AOVs (ops/pathtrace.py::aov_*) of one sample: the
// primary hit's normal, bumped at o + t d with normal_map > 0 (a miss is
// Scene::miss_color: black for spheres, magenta for meshes), 1 on a hit,
// ambient occlusion (around the unbumped normal), or (u, v, 0) of the
// texcoords / barycentrics (0 for spheres) with a magenta miss.
template <class Scene, class Rng>
L2N_HD void aov_sample(const PtParams& p, const Scene& s, Rng& rng, float ox,
                       float oy, float oz, float dx, float dy, float dz,
                       float col[3]) {
  const Hit h = s.nearest_primary(ox, oy, oz, dx, dy, dz);
  const bool hit = h.t >= 0.0f;
  if (p.aov == kAovNormal) {
    if (hit) {
      col[0] = h.nx;
      col[1] = h.ny;
      col[2] = h.nz;
      if (p.normal_map > 0.0f)
        perturb_normal(p, material_row(s.mat, s.n, h.index).bump,
                       ox + h.t * dx, oy + h.t * dy, oz + h.t * dz, col[0],
                       col[1], col[2]);
    } else {
      Scene::miss_color(col);
    }
  } else if (p.aov == kAovHit || p.aov == kAovAmbientOcclusion) {
    col[0] = p.aov == kAovHit
                 ? (hit ? 1.0f : 0.0f)
                 : ambient_occlusion(p, s, rng, h, ox, oy, oz, dx, dy, dz);
    col[1] = col[2] = col[0];
  } else if (hit) {
    col[0] = p.aov == kAovTexCoords ? h.tc_u : h.b_u;
    col[1] = p.aov == kAovTexCoords ? h.tc_v : h.b_v;
    col[2] = 0.0f;
  } else {
    col[0] = 1.0f;
    col[1] = 0.0f;
    col[2] = 1.0f;
  }
}

// exp(gamma * log(max(x, 1e-30))), 0 for x <= 0 (ops/kernels/common.py).
L2N_HD float safe_gamma(float x, float gamma) {
  const float safe = x > 1e-30f ? x : 1e-30f;
  return x <= 0.0f ? 0.0f : expf(gamma * logf(safe));
}

// The "fovy" camera ray through float pixel coordinates (px + u1, py + u2)
// (ops/pathtrace.py::generate_rays), normalized; the origin is the camera
// position cam[32..34].
L2N_HD void fovy_direction(const PtParams& p, float px, float py, float u1,
                           float u2, float& dx, float& dy, float& dz) {
  const float* cam = camera_block(p);
  const float sx = (px + u1) * p.inv_width;
  const float sy = (py + u2) * p.inv_height;
  const float ndx = -1.0f + 2.0f * sx;
  const float ndy = -1.0f + 2.0f * sy;
  const float vx = ndx * cam[36] * cam[37];
  const float vy = ndy * cam[37];
  const float vz = -1.0f;
  dx = cam[0] * vx + cam[1] * vy + cam[2] * vz + cam[3] - cam[32];
  dy = cam[4] * vx + cam[5] * vy + cam[6] * vz + cam[7] - cam[33];
  dz = cam[8] * vx + cam[9] * vy + cam[10] * vz + cam[11] - cam[34];
  normalize3(dx, dy, dz, p.fast_math != 0);
}

// The "viewproj" camera ray: NDC on the far plane (z = 1) through the
// inverse view-projection (camera rows 4-7, cam[16..31]), 1 / w and a
// multiply, minus the camera position, normalized.
L2N_HD void viewproj_direction(const PtParams& p, float px, float py,
                               float u1, float u2, float& dx, float& dy,
                               float& dz) {
  const float* cam = camera_block(p);
  const float sx = (px + u1) * p.inv_width;
  const float sy = (py + u2) * p.inv_height;
  const float ndx = -1.0f + 2.0f * sx;
  const float ndy = -1.0f + 2.0f * sy;
  const float vz = 1.0f;
  const float wx = cam[16] * ndx + cam[17] * ndy + cam[18] * vz + cam[19];
  const float wy = cam[20] * ndx + cam[21] * ndy + cam[22] * vz + cam[23];
  const float wz = cam[24] * ndx + cam[25] * ndy + cam[26] * vz + cam[27];
  const float ww = cam[28] * ndx + cam[29] * ndy + cam[30] * vz + cam[31];
  const float rcp_w = 1.0f / ww;
  dx = wx * rcp_w - cam[32];
  dy = wy * rcp_w - cam[33];
  dz = wz * rcp_w - cam[34];
  normalize3(dx, dy, dz, p.fast_math != 0);
}

// The camera ray of the configured form.
L2N_HD void camera_direction(const PtParams& p, float px, float py, float u1,
                             float u2, float& dx, float& dy, float& dz) {
  if (p.ray_gen == kRayGenViewproj)
    viewproj_direction(p, px, py, u1, u2, dx, dy, dz);
  else
    fovy_direction(p, px, py, u1, u2, dx, dy, dz);
}

// Draw the pixel jitter and return the primary ray's direction.
template <class Rng>
L2N_HD void primary_direction(const PtParams& p, Rng& rng, int row, int col,
                              float& dx, float& dy, float& dz) {
  float u1, u2;
  rng.draw2(u1, u2);  // pixel jitter
  camera_direction(p, static_cast<float>(col), static_cast<float>(row), u1,
                   u2, dx, dy, dz);
}

// The pixel (r, c) within its tile of thread t of a tile's `sub`-th block,
// for the fused kernels' grids of tile_height blocks of tile_width threads
// per tile. Where the tile's shape allows, a block covers 4 rows x
// tile_width / 4 columns and a warp 4 rows x 8 columns, so that the paths
// of a warp start close together and their bounce rays walk the same
// bounds; else a block is one row of the tile.
L2N_HD void block_pixel(const PtParams& p, int sub, int t, int& r, int& c) {
  if (p.tile_width % 32 == 0 && p.tile_height % 4 == 0) {
    const int lane = t % 32, warp = t / 32;
    r = (sub / 4) * 4 + lane / 8;
    c = (sub % 4) * (p.tile_width / 4) + warp * 8 + lane % 8;
  } else {
    r = sub;
    c = t;
  }
}

L2N_HD size_t pixel_offset(const PtParams& p, int row, int col) {
  return static_cast<size_t>(row) * static_cast<size_t>(p.padded_width) + col;
}

L2N_HD size_t plane_size(const PtParams& p) {
  return static_cast<size_t>(p.padded_height) *
         static_cast<size_t>(p.padded_width);
}

// Add this step's `spp` samples `sum` to pixel (row, col) of accum (4, Hp,
// Wp) and write its tonemapped output (3, Hp, Wp), in place
// (ops/kernels/common.py::accumulate_and_tonemap).
L2N_HD void accumulate_pixel(const PtParams& p, int row, int col,
                             const float sum[3], float* accum,
                             float* output) {
  const size_t plane = plane_size(p);
  const size_t pix = pixel_offset(p, row, col);
  const float n = accum[3 * plane + pix] + static_cast<float>(p.spp);
  const float inv = 1.0f / n;
  for (int ch = 0; ch < 3; ++ch) {
    const float acc = accum[ch * plane + pix] + sum[ch];
    accum[ch * plane + pix] = acc;
    output[ch * plane + pix] = safe_gamma(acc * inv, p.gamma);
  }
  accum[3 * plane + pix] = n;
}

// Render `spp` samples of pixel (row, col) of the padded framebuffer and
// update accum and output in place; a stateful sampler loads its pixel's
// state planes from rng_state once, steps them through the samples in
// order and stores them once (rng_state is unused by the counter-based
// samplers and may be null for them). kBody: the Lambert path tracer, the
// primary-only AOVs, the materials or the NEE path tracer (dispatch_fused
// picks one, fused_body), so that the default path's code holds none of
// the others. (row, col) is the pixel in the frame's planes; the pixel
// index and the camera ray take its global row, row + p.row_offset.
template <class Rng, int kBody, class Scene>
L2N_HD void render_pixel(const PtParams& p, const Scene& s, int row, int col,
                         float* accum, float* output, uint32_t* rng_state) {
  const size_t plane = plane_size(p);
  const size_t pix = pixel_offset(p, row, col);
  const int global_row = row + p.row_offset;
  const uint32_t pixel_index =
      static_cast<uint32_t>(col + global_row * p.padded_width);
  const uint32_t sample_index =
      static_cast<uint32_t>(static_cast<int32_t>(accum[3 * plane + pix]));
  const float* cam = camera_block(p);

  Rng rng = Rng::load(p, rng_state, plane, pix, pixel_index, sample_index);
  float sum[3] = {0.0f, 0.0f, 0.0f};
  for (int si = 0; si < p.spp; ++si) {
    if (si > 0) rng.next_sample();
    float dx, dy, dz;
    primary_direction(p, rng, global_row, col, dx, dy, dz);
    float c[3];
    if constexpr (kBody == kBodyAovs)
      aov_sample(p, s, rng, cam[32], cam[33], cam[34], dx, dy, dz, c);
    else
      trace_sample<kBody>(p, s, rng, cam[32], cam[33], cam[34], dx, dy, dz,
                          c);
    sum[0] = sum[0] + c[0];
    sum[1] = sum[1] + c[1];
    sum[2] = sum[2] + c[2];
  }
  rng.store(rng_state, plane, pix);
  accumulate_pixel(p, row, col, sum, accum, output);
}

// The step's parameters with fast_math the compile-time kFast and, where
// the kernel casts camera rays, the camera form the compile-time
// kViewproj: a kernel instantiated for them reads its parameters through
// this copy, so that each fast-math site (rcp_len, sweep_t, normalize3)
// and camera_direction fold to one form, and the default path runs no
// branch for the others (measured: a runtime branch at each cost the
// default path up to 5%, PERF.md).
template <bool kFast>
L2N_HD PtParams with_options(PtParams p) {
  p.fast_math = kFast ? 1 : 0;
  return p;
}

template <bool kFast, bool kViewproj>
L2N_HD PtParams with_options(PtParams p) {
  p = with_options<kFast>(p);
  p.ray_gen = kViewproj ? kRayGenViewproj : kRayGenFovy;
  return p;
}

// The parameters an instantiation of body kBody reads: with_options, but
// for the NEE and fog bodies, which read fast_math and the camera form at
// run time and are instantiated once per counter-based sampler (their
// shadow rays and collision draws cost far more than the branches; eight
// instantiations per kernel would cost build time).
template <int kBody, bool kFast>
L2N_HD PtParams body_options(const PtParams& p) {
  if constexpr (kBody == kBodyNee || kBody == kBodyFog)
    return p;
  else
    return with_options<kFast>(p);
}

template <int kBody, bool kFast, bool kViewproj>
L2N_HD PtParams body_options(const PtParams& p) {
  if constexpr (kBody == kBodyNee || kBody == kBodyFog)
    return p;
  else
    return with_options<kFast, kViewproj>(p);
}

// Fill the parameter struct from the wrappers' arrays (layout documented in
// ops/kernels/common.py::step_params) and the camera block `cam` (null
// where the kernel casts no camera ray).
inline PtParams params_from_arrays(const int32_t* ip, const float* fp,
                                   const float* cam) {
  PtParams p;
  p.tile_height = ip[0];
  p.tile_width = ip[1];
  p.padded_height = ip[2];
  p.padded_width = ip[3];
  p.k = ip[4];
  p.n_scene = ip[5];
  p.spp = ip[6];
  p.max_bounces = ip[7];
  p.max_pairs = ip[8];
  p.emissive_every = ip[9];
  p.env = ip[10];
  p.seed = static_cast<uint32_t>(ip[11]);
  p.stream = static_cast<uint32_t>(ip[12]);
  p.aov = ip[13];
  p.rng = ip[14];
  p.ray_gen = ip[15];
  p.fast_math = ip[16];
  p.material = ip[17];
  p.n_point = ip[18];
  p.n_dir = ip[19];
  p.nee = ip[20];
  p.mis = ip[21];
  p.n_lights = ip[22];
  p.fog = ip[23];
  p.row_offset = ip[24];
  p.inv_width = fp[0];
  p.inv_height = fp[1];
  p.rr_ceiling = fp[2];
  p.ray_epsilon = fp[3];
  p.emission_scale = fp[4];
  p.env_scale = fp[5];
  p.gamma = fp[6];
  p.cam = cam;
  p.normal_map = fp[7];
  p.normal_map_freq = fp[8];
  p.nee_scale = fp[9];
  p.nee_le = fp[10];
  p.fog_sigma = fp[11];
  p.fog_inv_sigma = fp[12];
  p.fog_sky = fp[13];
  p.fog_albedo = fp[14];
  p.fog_dir_transmit = fp[15];
  p.lights = nullptr;
  p.nee_col = nullptr;
  return p;
}

}  // namespace l2n
