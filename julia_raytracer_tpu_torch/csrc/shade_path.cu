// Path shading of one wavefront bounce: everything render/integrator.py
// `eager_bounce` does before and after its intersect, for the path
// sampler, in one pass, one thread a lane. The intersect stays the route's own
// (ops/traversal.py Intersector.hit), launched after this kernel on the
// next ray it writes.
//
// Replaces no TPU kernel: the JAX package shades in jnp inside its loop
// body (julia_raytracer_tpu/render/integrator.py), and so does the port's
// eager bounce, some 800 ATen launches a body on the card, each reading
// and writing its lane arrays through HBM. That eager code is this
// kernel's plain version (integrator.shade_plain).
//
// Where it runs (integrator.shade_route): the while loop of the path
// sampler, unsorted, on scenes without environments, volumes, opacity,
// textures, normal maps or vertex normals, without nocaustics, with at
// most lights.EXACT_ELEMS emissive elements (so the light pdf is the exact
// sweep, which needs the new ray and not its hit) and only matte and
// glossy materials (no delta lobe on any lane). There every part of the
// weight update depends on nothing the intersect returns, so the whole
// bounce shades before the intersect.
//
// Semantics (identical to shade_plain on the card, bit for bit, on every
// lane, dead ones included):
//   - each ATen op of the eager bounce is one rounded operation here, in
//     its order: built with -fmad=false, IEEE division and square root,
//     the same sinf, cosf and atanf; a Python constant is the float32 ATen
//     rounds it to, and a division by one is a product with its float32
//     reciprocal, as ATen divides a tensor by a scalar on the card;
//   - every (a * b).sum(-1), and the light pdf's sum of a slab of k <= 16
//     elements, adds as ATen's reduce kernel adds a contiguous last axis
//     on the card (slab_sum and sum3 below; for k = 3, two threads an
//     output, thread 0 adding terms 0 and 2), its identity 0 included,
//     which turns a -0 into +0 (tests/test_torch_cuda.py holds ATen to
//     this order for k = 1-16);
//   - the eager bounce evaluates every lobe and light term on every lane
//     and selects; here a lane computes only what it selects (its own
//     lobe, the direction its r_half picks, the weight of a surface lane,
//     the triangle terms of a light element it hits), which gives the
//     same values;
//   - torch.where is a select, clamp, minimum and amax keep NaN;
//   - the random draws are the lanes' PCG steps (utils/rng.py) in the
//     bounce's order: r_half, rnl, rn (2), with lights rl_pick, rl_el and
//     rl_uv (2), then r_rr after the weight update;
//   - tmax is F32_MAX on the lanes alive after the zero-direction break
//     and -1 elsewhere, taken before the weight's zero and non-finite
//     break and Russian roulette, as the eager bounce passes it to the
//     intersect; tmin is RAY_EPS.
//
// What bounds it on an H100: bytes. A lane reads its ray direction, hit
// record, radiance, weight, RNG state, bounce, flags and first-hit AOVs
// (111 B) and writes the next ray, tmin, tmax, radiance, weight, RNG state,
// bounce, flags and AOVs (90 B); the material rows and the light elements
// are a few hundred bytes that every lane reads through L1/L2. The
// arithmetic (some 125 fp32 operations a matte lane, twice that a glossy
// one, and two triangle tests a light element, each division and square
// root IEEE-rounded) takes about as long on scenes of a few light
// elements, and sets the pace past some ten.

#include <cuda_runtime.h>
#include <stdint.h>

// the kernel's arguments (ops/shade_path.py _Args), by value
struct ShadeArgs {
  // the lane state the bounce reads (TraceVars fields)
  const float* rd;
  const uint8_t* isec_hit;
  const int* isec_prim;
  const float* isec_u;
  const float* isec_v;
  const float* isec_pos;
  const float* isec_gn;
  const int* isec_inst;
  const float* radiance;
  const float* weight;
  const int* rng;
  const int* bounce;
  const uint8_t* alive;
  const uint8_t* hit_flag;
  const float* hit_albedo;
  const float* hit_normal;
  // the scene: shape colours, curve attributes, materials, lights
  const int* prim_vidx;      // [n_prim, 4]
  const int* prim_flags;     // [n_prim]
  const float* vert_colors;  // [n_verts, 4]
  const float* line_attr;    // [n_lines, 2, 9]
  const float* point_attr;   // [n_points, 9]
  const float* inst_mat_dense;  // [n_inst, 21] or null
  const int* inst_material;  // [n_inst] (the table route)
  const int* mat_type;       // [n_mats]
  const float* mat_emission;  // [n_mats, 3]
  const float* mat_color;    // [n_mats, 3]
  const float* mat_roughness;  // [n_mats]
  const float* mat_ior;      // [n_mats]
  const float* light_cdf;    // [cdf_len]
  const int* light_offset;   // [n_lights]
  const int* light_count;    // [n_lights]
  const float* elem_verts;   // [elem_rows, 12]
  const uint8_t* elem_is_tri;  // [elem_rows]
  const float* elem_area;    // [elem_rows]
  // outputs
  float* ro_out;
  float* rd_out;
  float* tmin_out;
  float* tmax_out;
  float* radiance_out;
  float* weight_out;
  int* rng_out;
  int* bounce_out;
  uint8_t* alive_out;
  uint8_t* hit_flag_out;
  float* hit_albedo_out;
  float* hit_normal_out;
  // sizes and options
  int n;
  int n_prim;
  int n_inst;
  int n_verts;
  int has_colors;
  int n_lines;
  int n_points;
  int n_mats;
  int n_lights;
  int cdf_len;
  int elem_rows;
  int n_elems;
  int search_iters;
  int bounces;
  int lobes;  // bit t: material type t is present
  float inv_lights;  // float32(1.0 / n_lights)
};

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // lights.ELEM_PDF_CHUNK
// float32 of the eager code's Python constants, as ATen rounds them
constexpr float kF32Max = 0x1.fffffep+127f;     // geometry.F32_MAX
constexpr float kRayEps = 0x1.a36e2ep-14f;      // geometry.RAY_EPS, 1e-4
constexpr float kPi = 0x1.921fb6p+1f;           // math.pi
constexpr float kTwoPi = 0x1.921fb6p+2f;        // 2.0 * math.pi
constexpr float kInvPi = 0x1.45f306p-2f;        // 1.0f / float(math.pi)
constexpr float kMinRoughness = 0x1.d7dbf4p-11f;  // 0.03 * 0.03
constexpr float kTiny = 0x1.4484cp-100f;        // 1e-30
constexpr float kCdfEps = 0x1.4f8b58p-17f;      // 1e-5
constexpr float kRrMax = 0x1.fae148p-1f;        // 0.99
constexpr int kMatte = 0, kGlossy = 1, kReflective = 2, kTransparent = 3,
              kRefractive = 4, kVolumetric = 6, kGltfPbr = 7;
constexpr int kHasColors = 4;  // scene/flatten.py FLAG_HAS_COLORS

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 zero3() { return {0.0f, 0.0f, 0.0f}; }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ V3 load3(const float* p, int64_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* p, int64_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// ATen's float sum of a contiguous last axis of three on the card
// (slab_sum below): ((x0 + x2) + 0) + (x1 + 0), which is ((x0 + x2) + x1)
// + 0
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return ((x0 + x2) + x1) + 0.0f;
}

// vecmath.dot: (a * b).sum(-1)
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}

// torch.clamp and clamp(min=) with a scalar: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
// torch.minimum: NaN wins
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}
// amax over three: NaN wins
__device__ __forceinline__ float amax3(V3 a) {
  float m = a.x;
  m = (m != m || m > a.y) ? m : a.y;
  m = (m != m || m > a.z) ? m : a.z;
  return m;
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

// vecmath.length / normalize / orthonormalize / cross
__device__ __forceinline__ V3 normalize(V3 a) {
  const float d = dot(a, a);
  const float l = d > 0.0f ? sqrtf(d) : 0.0f;
  if (l != 0.0f) {
    const float s = l == 0.0f ? 1.0f : l;
    return {a.x / s, a.y / s, a.z / s};
  }
  return a;
}
__device__ __forceinline__ V3 orthonormalize(V3 a, V3 b) {
  return normalize(sub(a, scale(b, dot(a, b))));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// bsdf._safe_sqrt, _safe_div
__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}
__device__ __forceinline__ float safe_div(float a, float b) {
  return a / (b == 0.0f ? 1.0f : b);
}

// geometry.interpolate_triangle / interpolate_quad
__device__ __forceinline__ V3 interp_tri(V3 p1, V3 p2, V3 p3, float u,
                                         float v) {
  const float w = (1.0f - u) - v;
  return add(add(scale(p1, w), scale(p2, u)), scale(p3, v));
}
__device__ __forceinline__ V3 interp_quad(V3 p1, V3 p2, V3 p3, V3 p4,
                                          float u, float v) {
  const V3 a = interp_tri(p1, p2, p4, u, v);
  const V3 b = interp_tri(p3, p4, p2, 1.0f - u, 1.0f - v);
  return sel(u + v <= 1.0f, a, b);
}

// vecmath.basis_fromz: rows x, y, z
struct Basis {
  V3 x, y, z;
};
__device__ __forceinline__ Basis basis_fromz(V3 v) {
  const V3 z = normalize(v);
  const float sign = z.z >= 0.0f ? 1.0f : -1.0f;
  // -1.0 / t is t.reciprocal() * -1.0 in PyTorch
  const float a = (1.0f / (sign + z.z)) * -1.0f;
  const float b = (z.x * z.y) * a;
  return {{1.0f + ((sign * z.x) * z.x) * a, sign * b, (-sign) * z.x},
          {b, sign + (z.y * z.y) * a, -z.y},
          z};
}
// vecmath.transform_direction
__device__ __forceinline__ V3 transform_direction(const Basis& m, V3 v) {
  return normalize(add(add(scale(m.x, v.x), scale(m.y, v.y)), scale(m.z, v.z)));
}

// ---- bsdf.py lobes (matte, glossy). A lane's lobe terms that its sample,
// eval and pdf share are computed once: `up` (bsdf._up_normal), the
// glossy lobe's Fresnel term at `up` and its halfway vector's terms, which
// the eager lobes each compute again from the same operands.

__device__ __forceinline__ V3 up_normal(V3 n, V3 o) {
  return sel(dot(n, o) <= 0.0f, neg(n), n);
}
__device__ __forceinline__ bool same_strict(V3 n, V3 o, V3 i) {
  return dot(n, i) * dot(n, o) > 0.0f;
}
__device__ __forceinline__ V3 sample_hemisphere_cos(const Basis& m, float r0,
                                                    float r1) {
  const float z = safe_sqrt(r1);
  const float r = safe_sqrt(1.0f - z * z);
  const float phi = kTwoPi * r0;
  return transform_direction(m, {r * cosf(phi), r * sinf(phi), z});
}
__device__ __forceinline__ float sample_hemisphere_cos_pdf(V3 n, V3 d) {
  const float cosw = dot(n, d);
  return cosw <= 0.0f ? 0.0f : cosw * kInvPi;
}
__device__ __forceinline__ float fresnel_dielectric(float eta, V3 n, V3 o) {
  const float cosw = fabsf(dot(n, o));
  const float sin2 = 1.0f - cosw * cosw;
  const float eta2 = eta * eta;
  const float cos2t = 1.0f - safe_div(sin2, eta2);
  const float t0 = safe_sqrt(cos2t);
  const float t1 = eta * t0;
  const float t2 = eta * cosw;
  const float rs = safe_div(cosw - t1, cosw + t1);
  const float rp = safe_div(t0 - t2, t0 + t2);
  const float f = (rs * rs + rp * rp) * 0.5f;
  return cos2t < 0.0f ? 1.0f : f;
}
__device__ __forceinline__ float microfacet_distribution(float r, V3 n,
                                                         V3 h) {
  const float cosine = dot(n, h);
  const float r2 = r * r;
  const float c2 = cosine * cosine;
  const float denom = (c2 * r2 + 1.0f) - c2;
  const float d = safe_div(r2, (kPi * denom) * denom);
  return cosine <= 0.0f ? 0.0f : d;
}
__device__ __forceinline__ float shadowing1(float r, V3 n, V3 h, V3 dir) {
  const float cosine = dot(n, dir);
  const float cosineh = dot(h, dir);
  const float r2 = r * r;
  const float c2 = cosine * cosine;
  const float g = safe_div(2.0f * fabsf(cosine),
                           fabsf(cosine) + safe_sqrt((c2 - r2 * c2) + r2));
  return cosine * cosineh <= 0.0f ? 0.0f : g;
}

struct Material {
  int type;
  V3 emission, color;
  float roughness, ior;
};

// the lane's lobe among the present ones (dispatch._sel): one present lobe
// is taken on every lane; with none or both, the lane's own type's, and
// none (a zero result) for another type
__device__ __forceinline__ int lane_lobe(int lobes, int type) {
  if (lobes == 1 << kMatte) return kMatte;
  if (lobes == 1 << kGlossy) return kGlossy;
  if (type == kMatte && (lobes & 1 << kMatte)) return kMatte;
  if (type == kGlossy && (lobes & 1 << kGlossy)) return kGlossy;
  return -1;
}

struct Lobe {
  int kind;  // kMatte, kGlossy or -1
  V3 up;
  float f1;  // glossy: fresnel_dielectric(ior, up, outgoing)
};

__device__ __forceinline__ Lobe make_lobe(int lobes, const Material& m, V3 n,
                                          V3 o) {
  Lobe l;
  l.kind = lane_lobe(lobes, m.type);
  l.up = up_normal(n, o);
  l.f1 = l.kind == kGlossy ? fresnel_dielectric(m.ior, l.up, o) : 0.0f;
  return l;
}

// dispatch.sample_bsdfcos: sample_matte or sample_glossy; zero where
// roughness == 0
__device__ __forceinline__ V3 sample_bsdfcos(const Lobe& l, const Material& m,
                                             V3 o, float rnl, float r0,
                                             float r1) {
  V3 out = zero3();
  if (l.kind >= 0) {
    const Basis frame = basis_fromz(l.up);
    const V3 diff = sample_hemisphere_cos(frame, r0, r1);
    out = diff;
    if (l.kind == kGlossy) {
      // bsdf.sample_microfacet, then _reflect_or_zero: vecmath.reflect(o,
      // h), kept in up's hemisphere
      const float phi = kTwoPi * r0;
      const float theta =
          atanf(m.roughness * safe_sqrt(safe_div(r1, 1.0f - r1)));
      const float st = sinf(theta), ct = cosf(theta);
      const V3 h =
          transform_direction(frame, {cosf(phi) * st, sinf(phi) * st, ct});
      const V3 refl = add(neg(o), scale(h, 2.0f * dot(h, o)));
      const V3 keep =
          sel(dot(l.up, o) * dot(l.up, refl) >= 0.0f, refl, zero3());
      out = sel(rnl < l.f1, keep, diff);
    }
  }
  return sel(m.roughness == 0.0f, zero3(), out);
}

// dispatch.eval_bsdfcos and sample_bsdfcos_pdf of incoming `i`: (the
// lobe's value, its pdf); zero where roughness == 0
__device__ __forceinline__ float eval_pdf(const Lobe& l, const Material& m,
                                          V3 n, V3 o, V3 i, V3& f_out) {
  V3 f = zero3();
  float pdf = 0.0f;
  const bool strict = same_strict(n, o, i);
  if (l.kind == kMatte) {
    f = sel(strict, scale(scale(m.color, kInvPi), fabsf(dot(n, i))), zero3());
    pdf = strict ? sample_hemisphere_cos_pdf(l.up, i) : 0.0f;
  } else if (l.kind == kGlossy) {
    const float r = m.roughness;
    const V3 h = normalize(add(i, o));
    const float fh = fresnel_dielectric(m.ior, h, i);
    const float d = microfacet_distribution(r, l.up, h);
    const float g = shadowing1(r, l.up, h, o) * shadowing1(r, l.up, h, i);
    const float cos_i = dot(l.up, i);
    const float cos_o = dot(l.up, o);
    const V3 diffuse =
        scale(scale(scale(m.color, 1.0f - l.f1), kInvPi), fabsf(cos_i));
    const float spec =
        safe_div((fh * d) * g, (4.0f * cos_o) * cos_i) * fabsf(cos_i);
    f = sel(strict, V3{diffuse.x + spec, diffuse.y + spec, diffuse.z + spec},
            zero3());
    // bsdf.sample_glossy_pdf: the microfacet reflection's pdf and the
    // hemisphere's, by Fresnel
    const float cosine = dot(l.up, h);
    const float mpdf = cosine < 0.0f ? 0.0f : d * cosine;
    const float reflect_pdf = safe_div(mpdf, 4.0f * fabsf(dot(o, h)));
    pdf = strict ? l.f1 * reflect_pdf +
                       (1.0f - l.f1) * sample_hemisphere_cos_pdf(l.up, i)
                 : 0.0f;
  }
  f_out = sel(m.roughness == 0.0f, zero3(), f);
  return m.roughness == 0.0f ? 0.0f : pdf;
}

// ---- utils/rng.py: PCG-RXS-M-XS on the lane's 32-bit state

__device__ __forceinline__ float rand1f(uint32_t& state) {
  state = state * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28) + 4)) ^ state) * 277803737u;
  return static_cast<float>(((word >> 22) ^ word) >> 8) * 0x1p-24f;
}



__device__ __forceinline__ V3 elem_corner(const ShadeArgs& a, int e, int k) {
  return load3(a.elem_verts, static_cast<int64_t>(e) * 4 + k);
}

// lights.sample_lights over the area lights: a light by rl_pick, an
// element by its cdf (sample_discrete), a point by rl_uv
__device__ V3 sample_lights(const ShadeArgs& a, V3 position, float rl,
                            float rel, float ruv0, float ruv1) {
  const int L = a.n_lights;
  const int lid = clampi(static_cast<int>(rl * static_cast<float>(L)), 0,
                         L - 1);
  const int li = clampi(lid, 0, L - 1);
  const int off = a.light_offset[li];
  const int count = max(a.light_count[li], 1);
  const float total = a.light_cdf[clampi(off + count - 1, 0, a.cdf_len - 1)];
  const float limit = minimum(clamp_min(rel * total, 0.0f), total - kCdfEps);
  int lo = 0, hi = count;
  for (int it = 0; it < a.search_iters; ++it) {
    const int mid = (lo + hi) / 2;
    const bool go = lo < hi;
    const bool pred =
        a.light_cdf[clampi(off + mid, 0, a.cdf_len - 1)] > limit;
    const int nhi = go && pred ? mid : hi;
    lo = go && !pred ? mid + 1 : lo;
    hi = nhi;
  }
  const int elem = min(max(lo, 0), count - 1);
  const int eg = clampi(off + elem, 0, a.elem_rows - 1);
  float u = ruv0, v = ruv1;
  if (a.elem_is_tri[eg]) {  // lights.sample_triangle_uv
    const float s = sqrtf(ruv0);
    u = 1.0f - s;
    v = ruv1 * s;
  }
  const V3 lpos = interp_quad(elem_corner(a, eg, 0), elem_corner(a, eg, 1),
                              elem_corner(a, eg, 2), elem_corner(a, eg, 3),
                              u, v);
  return normalize(sub(lpos, position));
}

// lights._lex_less
__device__ __forceinline__ bool lex_less(V3 p, V3 q) {
  return p.x != q.x ? p.x < q.x : p.y != q.y ? p.y < q.y : p.z < q.z;
}

// lights.area_lights_pdf_exact's tri_contrib for one element triangle
__device__ __forceinline__ float tri_contrib(V3 ro, V3 rd, V3 a, V3 b, V3 c,
                                             float area) {
  const V3 edge1 = sub(b, a);
  const V3 edge2 = sub(c, a);
  const V3 pvec = cross(rd, edge2);
  const float det = dot(edge1, pvec);
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  const V3 tvec = sub(ro, a);
  const float u = dot(tvec, pvec) * inv_det;
  const V3 qvec = cross(tvec, edge1);
  const float v = dot(rd, qvec) * inv_det;
  const float t = dot(edge2, qvec) * inv_det;
  const float uv = u + v;
  const bool hit = det != 0.0f && (v > 0.0f || (v == 0.0f && lex_less(a, b))) &&
                   (u > 0.0f || (u == 0.0f && lex_less(c, a))) &&
                   (uv < 1.0f || (uv == 1.0f && lex_less(b, c))) &&
                   t >= kRayEps;
  if (!(hit && area > 0.0f)) return 0.0f;
  const V3 nrm = normalize(cross(sub(b, a), sub(c, a)));
  const float cosine = fabsf(dot(nrm, rd));
  return (t * t) / clamp_min(cosine * area, kTiny);
}

// the contribution of element e's first triangle (p1, p2, p4) or its
// second (p3, p4, p2)
__device__ __forceinline__ float elem_contrib(const ShadeArgs& a, int e,
                                              bool second, V3 ro, V3 rd) {
  return tri_contrib(ro, rd, elem_corner(a, e, second ? 2 : 0),
                     elem_corner(a, e, second ? 3 : 1),
                     elem_corner(a, e, second ? 1 : 3), a.elem_area[e]);
}

// ATen's float sum on the card (ATen/native/cuda/Reduce.cuh) of the
// contributions of one slab's k (1 <= k <= ELEM_PDF_CHUNK) first or second
// triangles, from element s on: block_width W = last_pow2(k) threads an
// output; thread t folds terms t and t + W into accumulators that start
// at the identity 0 and are combined with two more identities, which
// leaves the slot (c_t + c_t+W) + 0 (a -0 turned +0); then the threads add
// in a tree over halving offsets W/2, ..., 1: the pairwise sum of the slots
// in bit-reversed order, kept here as a binary counter of partial sums.
__device__ float slab_sum(const ShadeArgs& a, int s, int k, bool second,
                          V3 ro, V3 rd) {
  int bits = 0;
  while ((2 << bits) <= k) ++bits;
  const int w = 1 << bits;
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f, x = 0.0f;
#pragma unroll 1
  for (int i = 0; i < w; ++i) {
    const int t = bits ? static_cast<int>(__brev(i) >> (32 - bits)) : 0;
    x = elem_contrib(a, s + t, second, ro, rd);
    if (t + w < k) x = x + elem_contrib(a, s + t + w, second, ro, rd);
    x = x + 0.0f;
    if (!(i & 1)) {
      p0 = x;
      continue;
    }
    x = p0 + x;
    if (!(i & 2)) {
      p1 = x;
      continue;
    }
    x = p1 + x;
    if (!(i & 4)) {
      p2 = x;
      continue;
    }
    x = p2 + x;
    if (!(i & 8)) {
      p3 = x;
      continue;
    }
    x = p3 + x;
  }
  return x;
}

// lights.sample_lights_pdf at most EXACT_ELEMS elements: the exact sweep
// in slabs of ELEM_PDF_CHUNK elements, each slab's first triangles summed,
// then its second ones, over L
__device__ float lights_pdf(const ShadeArgs& a, V3 ro, V3 rd) {
  float pdf = 0.0f;
  for (int s = 0; s < a.n_elems; s += kChunk) {
    const int k = min(a.n_elems - s, kChunk);
    pdf = pdf + slab_sum(a, s, k, false, ro, rd);
    pdf = pdf + slab_sum(a, s, k, true, ro, rd);
  }
  return pdf * a.inv_lights;
}

__global__ void __launch_bounds__(kThreads)
    shade_path_kernel(const ShadeArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;

  const bool alive0 = a.alive[i] != 0;
  const int bounce = alive0 ? a.bounce[i] + 1 : a.bounce[i];
  uint32_t state = static_cast<uint32_t>(a.rng[i]);
  V3 radiance = load3(a.radiance, i);
  V3 weight = load3(a.weight, i);
  const V3 outgoing = neg(load3(a.rd, i));
  const bool hit = a.isec_hit[i] != 0;
  bool alive = alive0 && hit;
  bool surf = alive;
  const int iprim = a.isec_prim[i];
  const int inst = clampi(a.isec_inst[i], 0, a.n_inst - 1);
  const V3 position = load3(a.isec_pos, i);
  const V3 gn = load3(a.isec_gn, i);

  // the shape's colour (eval.eval_color_attr), the curves' overrides
  V3 shp = {1.0f, 1.0f, 1.0f};
  if (a.has_colors) {
    const int prim = clampi(iprim, 0, max(a.n_prim - 1, 0));
    const float u = a.isec_u[i], v = a.isec_v[i];
    V3 c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int vi = a.prim_vidx[4 * prim + k];
      vi = vi < 0 ? vi + a.n_verts : vi;
      const float* row = a.vert_colors + 4 * static_cast<int64_t>(vi);
      c[k] = {row[0], row[1], row[2]};
    }
    const V3 col = interp_quad(c[0], c[1], c[2], c[3], u, v);
    shp = sel((a.prim_flags[prim] & kHasColors) != 0, col, shp);
  }
  bool is_line = false, is_point = false;
  if (a.n_lines > 0) {
    is_line = hit && iprim >= a.n_prim && iprim < a.n_prim + a.n_lines;
    const float* lat =
        a.line_attr + 18 * static_cast<int64_t>(
                               clampi(iprim - a.n_prim, 0, a.n_lines - 1));
    const float wu = a.isec_u[i];
    const float wl = 1.0f - wu;
    const V3 lcol = {lat[5] * wl + lat[14] * wu, lat[6] * wl + lat[15] * wu,
                     lat[7] * wl + lat[16] * wu};
    shp = sel(is_line, lcol, shp);
  }
  if (a.n_points > 0) {
    is_point = hit && iprim >= a.n_prim + a.n_lines;
    const float* pat =
        a.point_attr +
        9 * static_cast<int64_t>(
                clampi(iprim - a.n_prim - a.n_lines, 0, a.n_points - 1));
    shp = sel(is_point, V3{pat[5], pat[6], pat[7]}, shp);
  }

  // the material (eval_material_dense or eval_material without textures,
  // then eval._material_point's roughness)
  Material m;
  float r;
  if (a.inst_mat_dense != nullptr) {
    const float* row = a.inst_mat_dense + 21 * static_cast<int64_t>(inst);
    m.type = static_cast<int>(row[0]);
    m.emission = {row[1], row[2], row[3]};
    m.color = mul(V3{row[4], row[5], row[6]}, shp);
    r = row[7];
    m.ior = row[9];
  } else {
    int mid = a.inst_material[inst];
    mid = mid < 0 ? mid + a.n_mats : mid;
    m.type = a.mat_type[mid];
    m.emission = scale(load3(a.mat_emission, mid), 1.0f);
    m.color = mul(scale(load3(a.mat_color, mid), 1.0f), shp);
    r = a.mat_roughness[mid] * 1.0f;
    m.ior = a.mat_ior[mid];
  }
  {
    const float r2 = r * r;
    const bool clamped =
        m.type == kMatte || m.type == kGltfPbr || m.type == kGlossy;
    m.roughness = clamped ? clamp(r2, kMinRoughness, 1.0f)
                  : m.type == kVolumetric ? 0.0f
                  : r2 < kMinRoughness    ? 0.0f
                                          : r2;
  }

  // the shading normal (eval_shading_normal, element normal faced), the
  // curves' normals
  V3 normal = sel(dot(gn, outgoing) >= 0.0f, gn, neg(gn));
  if (a.n_lines > 0) {
    normal = sel(is_line, orthonormalize(outgoing, gn), normal);
  }
  if (a.n_points > 0) normal = sel(is_point, outgoing, normal);

  // first-hit AOVs, emission
  const bool first = surf && bounce == 0;
  a.hit_flag_out[i] = (a.hit_flag[i] != 0 || first) ? 1 : 0;
  store3(a.hit_albedo_out, i, sel(first, m.color, load3(a.hit_albedo, i)));
  store3(a.hit_normal_out, i, sel(first, normal, load3(a.hit_normal, i)));
  const V3 emission =
      sel(dot(normal, outgoing) >= 0.0f, m.emission, zero3());
  radiance = add(radiance, sel(surf, mul(weight, emission), zero3()));

  // direction sampling
  const float r_half = rand1f(state);
  const float rnl = rand1f(state);
  const float rn0 = rand1f(state);
  const float rn1 = rand1f(state);
  const bool has_lights = a.n_lights > 0;
  float rl_pick = 0.0f, rl_el = 0.0f, ruv0 = 0.0f, ruv1 = 0.0f;
  if (has_lights) {
    rl_pick = rand1f(state);
    rl_el = rand1f(state);
    ruv0 = rand1f(state);
    ruv1 = rand1f(state);
  }
  const bool delta = ((m.type == kReflective || m.type == kRefractive ||
                       m.type == kTransparent) &&
                      m.roughness == 0.0f) ||
                     m.type == kVolumetric;
  // the bsdf's direction or the lights' (zero without lights); no delta
  // lobe is present, so a delta lane's direction (sample_delta) is zero
  const Lobe lobe = make_lobe(a.lobes, m, normal, outgoing);
  V3 incoming = zero3();
  if (!delta && r_half < 0.5f) {
    incoming = sample_bsdfcos(lobe, m, outgoing, rnl, rn0, rn1);
  } else if (!delta && has_lights) {
    incoming = sample_lights(a, position, rl_pick, rl_el, ruv0, ruv1);
  }
  const bool zero_inc = surf && fabsf(incoming.x) == 0.0f &&
                        fabsf(incoming.y) == 0.0f && fabsf(incoming.z) == 0.0f;
  alive = alive && !zero_inc;
  surf = surf && !zero_inc;

  // the next ray and the intersect's bounds
  store3(a.ro_out, i, position);
  store3(a.rd_out, i, incoming);
  a.tmin_out[i] = kRayEps;
  a.tmax_out[i] = alive ? kF32Max : -1.0f;

  // the weight of a surface lane: one-sample MIS
  if (surf) {
    const float lpdf = has_lights ? lights_pdf(a, position, incoming) : 0.0f;
    V3 f_nd;
    const float pdf_b = eval_pdf(lobe, m, normal, outgoing, incoming, f_nd);
    const float denom = clamp_min(0.5f * pdf_b + 0.5f * lpdf, kTiny);
    const V3 w_nd = {f_nd.x / denom, f_nd.y / denom, f_nd.z / denom};
    // eval_delta and sample_delta_pdf are zero: w_d = 0 / 1e-30
    const float w_d = 0.0f / kTiny;
    weight = mul(weight, sel(delta, V3{w_d, w_d, w_d}, w_nd));
  }

  // the weight's zero and non-finite break, Russian roulette, the limit
  const bool stepped = surf && alive;
  const bool w_zero = fabsf(weight.x) == 0.0f && fabsf(weight.y) == 0.0f &&
                      fabsf(weight.z) == 0.0f;
  const bool w_bad =
      !(isfinite(weight.x) && isfinite(weight.y) && isfinite(weight.z));
  alive = alive && !(stepped && (w_zero || w_bad));
  const float r_rr = rand1f(state);
  const bool rr_lane = stepped && alive && bounce > 3;
  const float rr_prob = clamp_max(amax3(weight), kRrMax);
  const bool rr_die = rr_lane && r_rr >= rr_prob;
  alive = alive && !rr_die;
  if (rr_lane && !rr_die) {
    const float p = clamp_min(rr_prob, kTiny);
    weight = {weight.x / p, weight.y / p, weight.z / p};
  }
  alive = alive && bounce < a.bounces;

  store3(a.radiance_out, i, radiance);
  store3(a.weight_out, i, weight);
  a.rng_out[i] = static_cast<int>(state);
  a.bounce_out[i] = bounce;
  a.alive_out[i] = alive ? 1 : 0;
}

}  // namespace

extern "C" int shade_path_launch(const ShadeArgs* args, cudaStream_t stream) {
  const ShadeArgs& a = *args;
  if (a.n < 0 || a.n_inst < 1 || a.bounces < 0 || a.n_elems < 0 ||
      (a.n_lights > 0 && (a.n_elems < 1 || a.elem_rows < a.n_elems ||
                          a.cdf_len < 1 || a.search_iters < 1)) ||
      (a.inst_mat_dense == nullptr && a.n_mats < 1) ||
      (a.has_colors && (a.n_prim < 1 || a.n_verts < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.n == 0) return 0;
  const int blocks = (a.n + kThreads - 1) / kThreads;
  shade_path_kernel<<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
