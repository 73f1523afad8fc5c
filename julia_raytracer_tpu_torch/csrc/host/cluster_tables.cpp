// Host-side (C++/OpenMP) builders of the port's scene set-up, the port's
// own copy of the JAX package's C++ table builder (ops/native.py there).
//
// build_cluster_tables computes, per 64-quad cluster, the unit-triangle
// affine transforms (2 triangles per quad), averaged unit normals, and
// cluster bboxes that the intersect kernels consume: the same math as the
// numpy builder in julia_raytracer_tpu_torch/ops/cluster_tables.py
// (_tri_transforms_batch / build_cluster_tables), in double precision per
// prim with f32 stores. world_expand_permute is the hybrid build's world
// expansion (scene/instanced.py build_world_flat).
//
// Build: g++ -O3 -fopenmp -shared -fPIC -o <lib>.so cluster_tables.cpp
// (julia_raytracer_tpu_torch/ops/native.py compiles on first use into
// csrc/_build/ and loads the library with ctypes).

#include <cmath>
#include <cstdint>
#include <cstring>

#include <omp.h>

namespace {

constexpr int PRIMS_PER_CLUSTER = 64;
constexpr int TRIS = 2 * PRIMS_PER_CLUSTER;
constexpr float NOHIT = 3e38f;

struct V3 {
  double x, y, z;
};

inline V3 sub(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 add(const V3& a, const V3& b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 cross(const V3& a, const V3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 scale(const V3& a, double s) { return {a.x * s, a.y * s, a.z * s}; }

// 3x4 affine world->barycentric transform for triangle (a, b, c);
// out[12] = (m_u, m_v, n_hat, t_u, t_v, t_w). Degenerate -> never-hit
// (all zero except t_w = 1: o'_w = 1, d'_w = 0 fails the dpz != 0 test).
inline void tri_transform(const V3& a, const V3& b, const V3& c, double* out) {
  V3 e1 = sub(b, a);
  V3 e2 = sub(c, a);
  V3 n = cross(e1, e2);
  double det = dot(n, n);
  if (!(det > 0.0) || !std::isfinite(det)) {
    for (int k = 0; k < 12; k++) out[k] = 0.0;
    out[11] = 1.0;
    return;
  }
  double inv = 1.0 / det;
  V3 nhat = scale(n, 1.0 / std::sqrt(det));
  V3 m0 = scale(cross(e2, n), inv);
  V3 m1 = scale(cross(n, e1), inv);
  out[0] = m0.x; out[1] = m0.y; out[2] = m0.z;
  out[3] = m1.x; out[4] = m1.y; out[5] = m1.z;
  out[6] = nhat.x; out[7] = nhat.y; out[8] = nhat.z;
  out[9] = -dot(m0, a);
  out[10] = -dot(m1, a);
  out[11] = -dot(nhat, a);
}

inline V3 unit_tri_normal(const V3& a, const V3& b, const V3& c) {
  V3 n = cross(sub(b, a), sub(c, a));
  double l = std::sqrt(dot(n, n));
  return l > 0.0 ? scale(n, 1.0 / l) : V3{0, 0, 0};
}

}  // namespace

extern "C" {

// The threads an OpenMP loop of this library runs on.
int native_threads() { return omp_get_max_threads(); }

// pv: f32 [q, 4, 3] quad verts; c = ceil(q / 64) clusters.
// tfm: f32 [c, 12, TRIS]; nrm: f32 [c, 4, TRIS] (rows 0..2 written, row
// 3 — the instance-id row — left untouched); bbox: f32 [c, 8].
void build_cluster_tables(const float* pv, int64_t q, int64_t c,
                          float* tfm, float* nrm, float* bbox) {
#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t ci = 0; ci < c; ci++) {
    float* tf = tfm + ci * 12 * TRIS;
    float* nr = nrm + ci * 4 * TRIS;
    float* bb = bbox + ci * 8;
    double lo[3] = {1e300, 1e300, 1e300};
    double hi[3] = {-1e300, -1e300, -1e300};
    bool any_real = false;
    for (int t = 0; t < PRIMS_PER_CLUSTER; t++) {
      int64_t p = ci * PRIMS_PER_CLUSTER + t;
      V3 p1{0, 0, 0}, p2{0, 0, 0}, p3{0, 0, 0}, p4{0, 0, 0};
      if (p < q) {
        const float* v = pv + p * 12;
        p1 = {v[0], v[1], v[2]};
        p2 = {v[3], v[4], v[5]};
        p3 = {v[6], v[7], v[8]};
        p4 = {v[9], v[10], v[11]};
        any_real = true;
        const V3 vs[4] = {p1, p2, p3, p4};
        for (const V3& vv : vs) {
          if (vv.x < lo[0]) lo[0] = vv.x;
          if (vv.y < lo[1]) lo[1] = vv.y;
          if (vv.z < lo[2]) lo[2] = vv.z;
          if (vv.x > hi[0]) hi[0] = vv.x;
          if (vv.y > hi[1]) hi[1] = vv.y;
          if (vv.z > hi[2]) hi[2] = vv.z;
        }
      }
      double t0[12], t1[12];
      tri_transform(p1, p2, p4, t0);
      tri_transform(p3, p4, p2, t1);
      // layout [12, TRIS]: row k, tris (2t, 2t+1)
      for (int k = 0; k < 12; k++) {
        tf[k * TRIS + 2 * t] = static_cast<float>(t0[k]);
        tf[k * TRIS + 2 * t + 1] = static_cast<float>(t1[k]);
      }
      V3 en = add(unit_tri_normal(p1, p2, p4), unit_tri_normal(p3, p4, p2));
      double l = std::sqrt(dot(en, en));
      if (l > 0.0) en = scale(en, 1.0 / l);
      const double enc[3] = {en.x, en.y, en.z};
      for (int k = 0; k < 3; k++) {
        nr[k * TRIS + 2 * t] = static_cast<float>(enc[k]);
        nr[k * TRIS + 2 * t + 1] = static_cast<float>(enc[k]);
      }
    }
    for (int k = 0; k < 3; k++) {
      bb[k] = any_real ? static_cast<float>(lo[k]) : NOHIT;
      bb[3 + k] = any_real ? static_cast<float>(hi[k]) : NOHIT;
    }
    bb[6] = 0.0f;
    bb[7] = 0.0f;
  }
}

// Fused hybrid-instancing world expansion (scene/instanced.py
// build_world_flat): out[k] = shape_verts[src_prim[k]] @ rot[src_inst[k]]
// + org[src_inst[k]] for every flattened world prim, written directly in
// the morton-permuted order — no [Pf,4,3] intermediates, one streaming
// pass. verts layout [*, 4, 3] f32 (world = v @ R + t, row-vector
// convention like scene/flatten.py); frames [I, 4, 3]: rows 0..2 = R,
// row 3 = t.
void world_expand_permute(const float* shape_verts, const float* frames,
                          const int32_t* src_prim, const int32_t* src_inst,
                          int64_t n_out, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t k = 0; k < n_out; k++) {
    const float* v = shape_verts + static_cast<int64_t>(src_prim[k]) * 12;
    const float* f = frames + static_cast<int64_t>(src_inst[k]) * 12;
    float* o = out + k * 12;
    for (int c = 0; c < 4; c++) {
      const float x = v[c * 3], y = v[c * 3 + 1], z = v[c * 3 + 2];
      o[c * 3 + 0] = x * f[0] + y * f[3] + z * f[6] + f[9];
      o[c * 3 + 1] = x * f[1] + y * f[4] + z * f[7] + f[10];
      o[c * 3 + 2] = x * f[2] + y * f[5] + z * f[8] + f[11];
    }
  }
}

}  // extern "C"
