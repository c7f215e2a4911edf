// Per-pixel body of the sphere path-tracing kernel (csrc/sphere_pt.cu).
//
// Everything here is `__host__ __device__`: nvcc builds it into the CUDA
// kernel, and the CPU tests build the same header with g++
// (-ffp-contract=off) to check it against the plain torch path without a
// card. It computes what l2n_tpu/ops/kernels/sphere_pt.py::_kernel computes
// for one pixel of a scheduled tile, with the same float32 operations in the
// same order (half-b sphere sweep, minimax atan2, kernel-form tonemap), but
// as the reference GLSL's divergent per-thread loop: a thread stops when its
// path dies instead of running masked lanes.
//
// Draw addresses: threefry counter = sample * max_pairs + pair, and draw1
// caches the second word of a pair. Replaying the lockstep tracer's call
// sequence along one path gives its addresses: pair 0 jitter, pair 1
// hemisphere at bounce 0, pair 2 word 0 RR at bounce 0, pair 3 hemisphere
// at bounce 1, pair 2 word 1 RR at bounce 1.

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

// Integer and float parameters of one step, filled by the C entry point
// from the arrays the Python wrapper passes (ops/kernels/sphere_pt.py keeps
// the two layouts in step). `cam` is the packed (10, 4) camera block.
struct SpherePtParams {
  int32_t tile_height, tile_width;
  int32_t padded_height, padded_width;
  int32_t k;  // scheduled tiles this step
  int32_t n_spheres;
  int32_t spp;
  int32_t max_bounces;
  int32_t max_pairs;
  int32_t emissive_every;
  int32_t env_mandelbrot;  // 1 mandelbrot sky, 0 none
  uint32_t seed, stream;
  float inv_width, inv_height;  // float32(1 / width), float32(1 / height)
  float rr_ceiling, ray_epsilon, emission_scale, env_scale, gamma;
  float cam[40];
};
constexpr int kIntParams = 13;
constexpr int kFloatParams = 7 + 40;

// Sphere SoA plus the per-sphere albedo table: rows of a (7, n) buffer.
struct SceneView {
  const float *cx, *cy, *cz, *r2, *ar, *ag, *ab;
  int n;
};

L2N_HD SceneView scene_view(const float* packed, int n) {
  return SceneView{packed, packed + n, packed + 2 * n, packed + 3 * n,
                   packed + 4 * n, packed + 5 * n, packed + 6 * n, n};
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

// Top 23 bits as mantissa, lowest mantissa bit forced: a float in (1, 2).
L2N_HD float uniform_oo(uint32_t bits) {
  return bits_to_float((bits >> 9) | 0x3F800001u) - 1.0f;
}

struct Sampler {
  uint32_t k0, k1, pixel, base;
  uint32_t pair;
  bool has_spare;
  float spare;

  L2N_HD void draw2(float& u1, float& u2) {
    uint32_t a = pixel, b = base + pair;
    ++pair;
    threefry2x32(k0, k1, a, b);
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
};

// ---------------------------------------------------------------------------
// Math (maths/sampling.py, maths/fastmath.py), float32, JAX operation order.
// ---------------------------------------------------------------------------

L2N_HD void normalize3(float& x, float& y, float& z) {
  const float rcp = 1.0f / sqrtf(x * x + y * y + z * z);
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

L2N_HD float env_le(const SpherePtParams& p, float dx, float dy, float dz) {
  return p.env_mandelbrot ? mandelbrot_le(dx, dy, dz) * p.env_scale : 0.0f;
}

L2N_HD float emit_term(const SpherePtParams& p, float r2) {
  return p.emission_scale /
         (static_cast<float>(4.0 * kPi) * (r2 > 1e-20f ? r2 : 1e-20f));
}

// ---------------------------------------------------------------------------
// Sweeps (ops/intersect.py): half-b form. A negative discriminant makes
// sqrtf NaN, and NaN fails every comparison, so the candidate is a miss.
// ---------------------------------------------------------------------------

struct Hit {
  float t;  // -1 on miss
  float nx, ny, nz;
  int index;  // -1 on miss
  float r2;
};

L2N_HD Hit nearest(const SceneView& s, float ox, float oy, float oz, float dx,
                   float dy, float dz) {
  float best = kBig, bcx = 0.0f, bcy = 0.0f, bcz = 0.0f, br2 = 1.0f;
  int bi = -1;
  for (int i = 0; i < s.n; ++i) {
    const float rox = ox - s.cx[i], roy = oy - s.cy[i], roz = oz - s.cz[i];
    const float hb = rox * dx + roy * dy + roz * dz;
    const float c = rox * rox + roy * roy + roz * roz - s.r2[i];
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
      bcx = s.cx[i];
      bcy = s.cy[i];
      bcz = s.cz[i];
      br2 = s.r2[i];
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
  return h;
}

// Any sphere with t >= 0: origin inside (c < 0) or ahead with a real root.
L2N_HD bool anyhit(const SceneView& s, float ox, float oy, float oz, float dx,
                   float dy, float dz) {
  for (int i = 0; i < s.n; ++i) {
    const float rox = ox - s.cx[i], roy = oy - s.cy[i], roz = oz - s.cz[i];
    const float hb = rox * dx + roy * dy + roz * dz;
    const float c = rox * rox + roy * roy + roz * roz - s.r2[i];
    if (c < 0.0f || (hb < 0.0f && hb * hb >= c)) return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// One path sample (ops/pathtrace.py::trace_path for the slice's config).
// ---------------------------------------------------------------------------

// Procedural-Lambert bounce at the diffuse vertex (hx, hy, hz) with normal
// n and sphere `index`: cosine-sampled new direction d, throughput times
// albedo, Russian roulette. Returns false when the path dies.
L2N_HD bool scatter_and_roulette(const SpherePtParams& p, const SceneView& s,
                                 Sampler& rng, const Hit& h, float& dx,
                                 float& dy, float& dz, float tp[3]) {
  // frame_z: tangent from the smaller of |n.x|, |n.y|; bitangent n x t.
  const float zx = h.nx, zy = h.ny, zz = h.nz;
  float tx, ty, tz;
  if (fabsf(zy) > fabsf(zx)) {
    const float rcp = 1.0f / sqrtf(zx * zx + zy * zy);
    tx = zy * rcp;
    ty = -zx * rcp;
    tz = 0.0f;
  } else {
    const float rcp = 1.0f / sqrtf(zx * zx + zz * zz);
    tx = zz * rcp;
    ty = 0.0f;
    tz = -zx * rcp;
  }
  const float bx = zy * tz - zz * ty;
  const float by = zz * tx - zx * tz;
  const float bz = zx * ty - zy * tx;

  float u1, u2;
  rng.draw2(u1, u2);
  const float r = sqrtf(u1);
  const float phi = static_cast<float>(2.0 * kPi) * u2;
  const float one_m = 1.0f - u1;
  const float lz = sqrtf(one_m > 0.0f ? one_m : 0.0f);
  const float lx = r * cosf(phi);
  const float ly = r * sinf(phi);
  dx = tx * lx + bx * ly + zx * lz;
  dy = ty * lx + by * ly + zy * lz;
  dz = tz * lx + bz * ly + zz * lz;
  normalize3(dx, dy, dz);

  tp[0] = tp[0] * s.ar[h.index];
  tp[1] = tp[1] * s.ag[h.index];
  tp[2] = tp[2] * s.ab[h.index];
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

// Radiance of one sample along the primary ray (ox, oy, oz) + t (dx, dy, dz).
// The tri-state `dist` of the lockstep tracer becomes control flow: an
// emissive hit adds its emission and ends the path, a miss adds the sky,
// Russian roulette ends it silently.
L2N_HD void trace_sample(const SpherePtParams& p, const SceneView& s,
                         Sampler& rng, float ox, float oy, float oz, float dx,
                         float dy, float dz, float col[3]) {
  col[0] = col[1] = col[2] = 0.0f;
  Hit h = nearest(s, ox, oy, oz, dx, dy, dz);
  if (h.t == -1.0f) {  // primary miss: sky with throughput 1
    const float le = env_le(p, dx, dy, dz);
    col[0] = col[0] + 1.0f * le;
    col[1] = col[1] + 1.0f * le;
    col[2] = col[2] + 1.0f * le;
    return;
  }
  if (h.index % p.emissive_every == 0) {
    col[0] = col[1] = col[2] = emit_term(p, h.r2);
    return;
  }
  float tp[3] = {1.0f, 1.0f, 1.0f};
  // Vertex base: the JAX tracer places vertex 0 from the camera, vertex 1
  // from the continuation origin, and later vertices from the previous
  // vertex (its `box` carry); follow it exactly.
  float bx = ox, by = oy, bz = oz;
  for (int b = 0; b < p.max_bounces; ++b) {
    const float hx = bx + h.t * dx, hy = by + h.t * dy, hz = bz + h.t * dz;
    if (!scatter_and_roulette(p, s, rng, h, dx, dy, dz, tp)) return;
    const float cx = hx + p.ray_epsilon * dx;
    const float cy = hy + p.ray_epsilon * dy;
    const float cz = hz + p.ray_epsilon * dz;
    if (b + 1 == p.max_bounces) {  // last segment: any-hit, then sky
      if (!anyhit(s, cx, cy, cz, dx, dy, dz)) {
        const float le = env_le(p, dx, dy, dz);
        col[0] = col[0] + tp[0] * le;
        col[1] = col[1] + tp[1] * le;
        col[2] = col[2] + tp[2] * le;
      }
      return;
    }
    h = nearest(s, cx, cy, cz, dx, dy, dz);
    if (h.t == -1.0f) {
      const float le = env_le(p, dx, dy, dz);
      col[0] = col[0] + tp[0] * le;
      col[1] = col[1] + tp[1] * le;
      col[2] = col[2] + tp[2] * le;
      return;
    }
    if (h.index % p.emissive_every == 0) {
      const float e = emit_term(p, h.r2);
      col[0] = col[0] + tp[0] * e;
      col[1] = col[1] + tp[1] * e;
      col[2] = col[2] + tp[2] * e;
      return;
    }
    if (b == 0) {
      bx = cx;
      by = cy;
      bz = cz;
    } else {
      bx = hx;
      by = hy;
      bz = hz;
    }
  }
}

// exp(gamma * log(max(x, 1e-30))), 0 for x <= 0 (ops/kernels/common.py).
L2N_HD float safe_gamma(float x, float gamma) {
  const float safe = x > 1e-30f ? x : 1e-30f;
  return x <= 0.0f ? 0.0f : expf(gamma * logf(safe));
}

// Render `spp` samples of pixel (row, col) of the padded framebuffer and
// update accum (4, Hp, Wp) and output (3, Hp, Wp) in place.
L2N_HD void render_pixel(const SpherePtParams& p, const SceneView& s, int row,
                         int col, float* accum, float* output) {
  const size_t plane =
      static_cast<size_t>(p.padded_height) * static_cast<size_t>(p.padded_width);
  const size_t pix =
      static_cast<size_t>(row) * static_cast<size_t>(p.padded_width) + col;
  const uint32_t pixel_index =
      static_cast<uint32_t>(col + row * p.padded_width);
  const float a3 = accum[3 * plane + pix];
  const uint32_t sample_index =
      static_cast<uint32_t>(static_cast<int32_t>(a3));
  const float* cam = p.cam;
  const float pos_x = cam[32], pos_y = cam[33], pos_z = cam[34];
  const float ratio = cam[36], tan_half = cam[37];

  float sum[3] = {0.0f, 0.0f, 0.0f};
  for (int si = 0; si < p.spp; ++si) {
    Sampler rng;
    rng.k0 = p.seed;
    rng.k1 = p.stream;
    rng.pixel = pixel_index;
    rng.base = (sample_index + static_cast<uint32_t>(si)) *
               static_cast<uint32_t>(p.max_pairs);
    rng.pair = 0;
    rng.has_spare = false;
    rng.spare = 0.0f;

    float u1, u2;
    rng.draw2(u1, u2);  // pixel jitter
    // generate_rays, "fovy" form (ops/pathtrace.py).
    const float sx = (static_cast<float>(col) + u1) * p.inv_width;
    const float sy = (static_cast<float>(row) + u2) * p.inv_height;
    const float ndx = -1.0f + 2.0f * sx;
    const float ndy = -1.0f + 2.0f * sy;
    const float vx = ndx * ratio * tan_half;
    const float vy = ndy * tan_half;
    const float vz = -1.0f;
    float dx = cam[0] * vx + cam[1] * vy + cam[2] * vz + cam[3] - pos_x;
    float dy = cam[4] * vx + cam[5] * vy + cam[6] * vz + cam[7] - pos_y;
    float dz = cam[8] * vx + cam[9] * vy + cam[10] * vz + cam[11] - pos_z;
    normalize3(dx, dy, dz);

    float c[3];
    trace_sample(p, s, rng, pos_x, pos_y, pos_z, dx, dy, dz, c);
    sum[0] = sum[0] + c[0];
    sum[1] = sum[1] + c[1];
    sum[2] = sum[2] + c[2];
  }

  // accumulate + tonemap (ops/kernels/common.py::accumulate_and_tonemap).
  const float n = a3 + static_cast<float>(p.spp);
  const float inv = 1.0f / n;
  for (int ch = 0; ch < 3; ++ch) {
    const float acc = accum[ch * plane + pix] + sum[ch];
    accum[ch * plane + pix] = acc;
    output[ch * plane + pix] = safe_gamma(acc * inv, p.gamma);
  }
  accum[3 * plane + pix] = n;
}

// Fill the parameter struct from the wrapper's arrays (layout documented in
// ops/kernels/sphere_pt.py::_params).
inline SpherePtParams params_from_arrays(const int32_t* ip, const float* fp) {
  SpherePtParams p;
  p.tile_height = ip[0];
  p.tile_width = ip[1];
  p.padded_height = ip[2];
  p.padded_width = ip[3];
  p.k = ip[4];
  p.n_spheres = ip[5];
  p.spp = ip[6];
  p.max_bounces = ip[7];
  p.max_pairs = ip[8];
  p.emissive_every = ip[9];
  p.env_mandelbrot = ip[10];
  p.seed = static_cast<uint32_t>(ip[11]);
  p.stream = static_cast<uint32_t>(ip[12]);
  p.inv_width = fp[0];
  p.inv_height = fp[1];
  p.rr_ceiling = fp[2];
  p.ray_epsilon = fp[3];
  p.emission_scale = fp[4];
  p.env_scale = fp[5];
  p.gamma = fp[6];
  for (int i = 0; i < 40; ++i) p.cam[i] = fp[7 + i];
  return p;
}

}  // namespace l2n
