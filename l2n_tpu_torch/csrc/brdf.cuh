// The material modes' BSDFs and the procedural bump (maths/brdf.py,
// maths/bump.py): the microfacet mixture (Smith-GGX with Schlick Fresnel
// over Lambert, sampled 50/50 cosine / GGX) and the Disney-lite BSDF
// (Burley diffuse with a subsurface blend, sheen, GGX with coloured
// Fresnel, sampled with probability 0.25 + 0.5 metallic for the GGX lobe).
//
// `__host__ __device__` float32 in the JAX package's order of operations,
// as the rest of the path body: nvcc builds it into the kernels
// (-fmad=false), g++ into the CPU tests (-ffp-contract=off). Every
// normalize and frame here is exact: fast_math does not reach the material
// scatter, in the JAX package either. Maxima propagate NaN, as jnp.maximum
// and torch.clamp do (max_nan).
//
// Included by pathtrace.cuh after its math (normalize3, Frame, frame_z,
// hemisphere_direction); not a header of its own.

#pragma once

namespace l2n {

// Material codes (ops/kernels/common.py::MATERIAL_CODES).
constexpr int kMaterialProcedural = 0;
constexpr int kMaterialMicrofacet = 1;
constexpr int kMaterialDisney = 2;

// One object's row of the material table (scene/materials.py
// MATERIAL_CHANNELS): rows of n floats after the albedo rows.
struct Material {
  float rough, metal, spec, sheen, subsurf, bump;
};

L2N_HD Material material_row(const float* mat, int n, int i) {
  return Material{mat[i],         mat[n + i],     mat[2 * n + i],
                  mat[3 * n + i], mat[4 * n + i], mat[5 * n + i]};
}

// max(x, c) with NaN kept (jnp.maximum, torch.clamp(min=c)).
L2N_HD float max_nan(float x, float c) { return x != x ? x : (x > c ? x : c); }

L2N_HD float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

L2N_HD float d_ggx(float n_h, float alpha2) {
  const float d = n_h * n_h * (alpha2 - 1.0f) + 1.0f;
  return alpha2 / max_nan(static_cast<float>(kPi) * d * d, 1e-12f);
}

// Smith height-correlated visibility, the G / (4 n.v n.l) form.
L2N_HD float g_smith(float n_v, float n_l, float alpha2) {
  const float gv = n_l * sqrtf(n_v * n_v * (1.0f - alpha2) + alpha2);
  const float gl = n_v * sqrtf(n_l * n_l * (1.0f - alpha2) + alpha2);
  return 0.5f / max_nan(gv + gl, 1e-12f);
}

L2N_HD float schlick5(float x) {
  const float one_m = max_nan(1.0f - x, 0.0f);
  const float m2 = one_m * one_m;
  return m2 * m2 * one_m;
}

// n.v, n.l, n.h and v.h of the half vector normalize(wo + wi), clamped.
struct HalfTerms {
  float n_v, n_l, n_h, v_h;
};

L2N_HD HalfTerms half_terms(const float n[3], const float wo[3],
                            const float wi[3]) {
  HalfTerms t;
  t.n_v = max_nan(dot3(n, wo), 1e-6f);
  t.n_l = max_nan(dot3(n, wi), 0.0f);
  float h[3] = {wo[0] + wi[0], wo[1] + wi[1], wo[2] + wi[2]};
  normalize3(h[0], h[1], h[2], false);
  t.n_h = max_nan(dot3(n, h), 0.0f);
  t.v_h = max_nan(dot3(wo, h), 1e-6f);
  return t;
}

constexpr float kInvPi = static_cast<float>(1.0 / kPi);

// f (rgb) and the mixture pdf of the microfacet BSDF; below the horizon
// (n.l not > 0) both are 0. n unit, wo toward the viewer, wi toward the
// light.
L2N_HD float eval_brdf(const float n[3], const float wo[3], const float wi[3],
                       const float kd[3], const Material& m, float f[3]) {
  const float alpha = m.rough * m.rough;
  const float alpha2 = alpha * alpha;
  const HalfTerms t = half_terms(n, wo, wi);
  const float d = d_ggx(t.n_h, alpha2);
  const float vis = g_smith(t.n_v, t.n_l, alpha2);
  const float fr = 0.04f + static_cast<float>(1.0 - 0.04) * schlick5(t.v_h);
  const float spec = d * vis * fr;
  const float kdiff = kInvPi * (1.0f - fr);
  for (int c = 0; c < 3; ++c) f[c] = kd[c] * kdiff + spec;
  const float pdf_cos = t.n_l * kInvPi;
  const float pdf_ggx = d * t.n_h / max_nan(4.0f * t.v_h, 1e-6f);
  const float pdf = 0.5f * (pdf_cos + pdf_ggx);
  if (t.n_l > 0.0f) return pdf;
  f[0] = f[1] = f[2] = 0.0f;
  return 0.0f;
}

// f and the metallic-weighted mixture pdf of the Disney-lite BSDF.
L2N_HD float eval_disney(const float n[3], const float wo[3],
                         const float wi[3], const float base[3],
                         const Material& m, float f[3]) {
  const float alpha = m.rough * m.rough;
  const float alpha2 = alpha * alpha;
  const HalfTerms t = half_terms(n, wo, wi);
  const float d = d_ggx(t.n_h, alpha2);
  const float vis = g_smith(t.n_v, t.n_l, alpha2);
  const float s5 = schlick5(t.v_h);
  const float f0_d = 0.08f * m.spec;
  const float dv = d * vis;
  const float sl = schlick5(t.n_l);
  const float sv = schlick5(t.n_v);
  const float fd90 = 0.5f + 2.0f * m.rough * t.v_h * t.v_h;
  const float fd = (1.0f + (fd90 - 1.0f) * sl) * (1.0f + (fd90 - 1.0f) * sv);
  const float fss90 = m.rough * t.v_h * t.v_h;
  const float fss =
      (1.0f + (fss90 - 1.0f) * sl) * (1.0f + (fss90 - 1.0f) * sv);
  const float ss =
      1.25f * (fss * (1.0f / max_nan(t.n_l + t.n_v, 1e-6f) - 0.5f) + 0.5f);
  const float kdiff =
      kInvPi * (fd + (ss - fd) * m.subsurf) * (1.0f - m.metal);
  const float fsheen = m.sheen * schlick5(t.v_h) * (1.0f - m.metal);
  for (int c = 0; c < 3; ++c) {
    const float f0 = f0_d + (base[c] - f0_d) * m.metal;
    const float spec = dv * (f0 + (1.0f - f0) * s5);
    f[c] = base[c] * kdiff + fsheen + spec;
  }
  const float p_spec = 0.25f + 0.5f * m.metal;
  const float pdf_cos = t.n_l * kInvPi;
  const float pdf_ggx = d * t.n_h / max_nan(4.0f * t.v_h, 1e-6f);
  const float pdf = p_spec * pdf_ggx + (1.0f - p_spec) * pdf_cos;
  if (t.n_l > 0.0f) return pdf;
  f[0] = f[1] = f[2] = 0.0f;
  return 0.0f;
}

L2N_HD float eval_material(int mode, const float n[3], const float wo[3],
                           const float wi[3], const float kd[3],
                           const Material& m, float f[3]) {
  return mode == kMaterialDisney ? eval_disney(n, wo, wi, kd, m, f)
                                 : eval_brdf(n, wo, wi, kd, m, f);
}

// One direction wi of the active mode's mixture from draws (u_lobe, u1,
// u2) in the exact frame fr around the unit normal (fr.z*): the cosine
// lobe's direction or the reflection of wo about the GGX half vector,
// normalized; w = f n.l / pdf (0 where pdf is 0). Returns the pdf.
L2N_HD float sample_material(int mode, float u_lobe, float u1, float u2,
                             const Frame& fr, const float wo[3],
                             const float kd[3], const Material& m,
                             float wi[3], float w[3]) {
  const float n[3] = {fr.zx, fr.zy, fr.zz};
  const float alpha = m.rough * m.rough;
  const float alpha2 = alpha * alpha;
  float a[3];
  hemisphere_direction(fr, u1, u2, a[0], a[1], a[2]);
  const float cos_h = sqrtf(max_nan(
      (1.0f - u1) / max_nan(1.0f + (alpha2 - 1.0f) * u1, 1e-12f), 0.0f));
  const float sin_h = sqrtf(max_nan(1.0f - cos_h * cos_h, 0.0f));
  const float phi = static_cast<float>(2.0 * kPi) * u2;
  const float lx = sin_h * cosf(phi), ly = sin_h * sinf(phi);
  const float h[3] = {fr.tx * lx + fr.bx * ly + fr.zx * cos_h,
                      fr.ty * lx + fr.by * ly + fr.zy * cos_h,
                      fr.tz * lx + fr.bz * ly + fr.zz * cos_h};
  const float v_h = dot3(wo, h);
  const float p_spec =
      mode == kMaterialDisney ? 0.25f + 0.5f * m.metal : 0.5f;
  const bool pick_spec = u_lobe < p_spec;
  for (int c = 0; c < 3; ++c)
    wi[c] = pick_spec ? 2.0f * v_h * h[c] - wo[c] : a[c];
  normalize3(wi[0], wi[1], wi[2], false);
  float f[3];
  const float pdf = eval_material(mode, n, wo, wi, kd, m, f);
  const float n_l = max_nan(dot3(n, wi), 0.0f);
  const float scale = n_l / max_nan(pdf, 1e-12f);
  for (int c = 0; c < 3; ++c) w[c] = pdf > 0.0f ? f[c] * scale : 0.0f;
  return pdf;
}

// The unit shading normal (nx, ny, nz), of any length on entry, perturbed
// by the bump field at (px, py, pz) with the object's amplitude `bump`
// (maths/bump.py::perturb_normal).
L2N_HD void perturb_normal(const PtParams& p, float bump, float px, float py,
                           float pz, float& nx, float& ny, float& nz) {
  normalize3(nx, ny, nz, false);
  const float amp = p.normal_map * bump;
  const float freq = p.normal_map_freq;
  const float gx = amp * cosf(freq * px);
  const float gy = amp * cosf(freq * py);
  const float gz = amp * cosf(freq * pz);
  const float g_n = gx * nx + gy * ny + gz * nz;
  nx = nx - (gx - g_n * nx);
  ny = ny - (gy - g_n * ny);
  nz = nz - (gz - g_n * nz);
  normalize3(nx, ny, nz, false);
}

}  // namespace l2n
