// The two tests every cluster intersector of the port shares: the slab test
// of a ray against a cluster box (cluster_cull, on slab_enter_exit, which
// the candidate cull of candidate_cull.cu also uses) and the affine
// unit-triangle test of a ray against one triangle of a cluster table
// (tri_test_k, on the triangle's 12 coefficients). Included through
// warp_walk.cuh by worklist_intersect.cu, instanced_intersect.cu,
// regroup_intersect.cu and cluster_intersect.cu; the plain PyTorch
// versions are _cluster_cull and _tri_tests in ops/worklist_intersect.py,
// which repeat this arithmetic in the same order (bit for bit when the
// kernels are built with -fmad=false).
//
// min/max propagate NaN as torch.minimum/maximum do (the sm_80+ min.NaN /
// max.NaN instructions), so a NaN ray never enters a box in either version.
// They may differ from torch's in the sign of a zero or in a NaN's payload,
// which no result depends on: every use ends in a compare, or in the cull's
// max(entry, 0).

#pragma once

constexpr int kTris = 128;  // triangles per cluster
constexpr int kRows = 16;   // table rows per cluster
constexpr float kSlack = 1.00000024f;
constexpr float kTinyDir = 1e-30f;

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;  // 1 / d, with 1e-30 in place of a zero component
  float tmin;
};

__device__ __forceinline__ void set_inverse_dir(Ray& r) {
  r.ix = 1.0f / (r.dx == 0.0f ? kTinyDir : r.dx);
  r.iy = 1.0f / (r.dy == 0.0f ? kTinyDir : r.dy);
  r.iz = 1.0f / (r.dz == 0.0f ? kTinyDir : r.dz);
}

// Slab test of a ray (origin o, inverse direction i) against a box [min
// xyz, max xyz], clipped to [tmin, tlim]: its entry and exit t. The ray
// enters the box if enter <= exit * kSlack.
__device__ __forceinline__ void slab_enter_exit(float ox, float oy, float oz,
                                                float ix, float iy, float iz,
                                                const float* box, float tmin,
                                                float tlim, float& enter,
                                                float& exit) {
  float t0 = (box[0] - ox) * ix;
  float t1 = (box[3] - ox) * ix;
  enter = min_nan(t0, t1);
  exit = max_nan(t0, t1);
  t0 = (box[1] - oy) * iy;
  t1 = (box[4] - oy) * iy;
  enter = max_nan(enter, min_nan(t0, t1));
  exit = min_nan(exit, max_nan(t0, t1));
  t0 = (box[2] - oz) * iz;
  t1 = (box[5] - oz) * iz;
  enter = max_nan(enter, min_nan(t0, t1));
  exit = min_nan(exit, max_nan(t0, t1));
  enter = max_nan(enter, tmin);
  exit = min_nan(exit, tlim);
}

// Slab test of one ray against one cluster box, clipped to [tmin, tlim];
// the cull of the cluster kernels (pallas_cluster.py row_slab / cull).
__device__ __forceinline__ bool cluster_cull(const Ray& r, float tlim,
                                             const float* box) {
  float enter, exit;
  slab_enter_exit(r.ox, r.oy, r.oz, r.ix, r.iy, r.iz, box, r.tmin, tlim,
                  enter, exit);
  return enter <= exit * kSlack;
}

// Affine unit-triangle test of one triangle given by its 12 coefficients
// k (table rows 0-11: m_u, m_v, n_hat, then t_u t_v t_w). Returns true on
// a hit closer than `best`, with its t, u, v.
__device__ __forceinline__ bool tri_test_k(const Ray& r, const float* k,
                                           float best, float& t, float& u,
                                           float& v) {
  const float opx = ((k[0] * r.ox + k[1] * r.oy) + k[2] * r.oz) + k[9];
  const float opy = ((k[3] * r.ox + k[4] * r.oy) + k[5] * r.oz) + k[10];
  const float opz = ((k[6] * r.ox + k[7] * r.oy) + k[8] * r.oz) + k[11];
  const float dpx = (k[0] * r.dx + k[1] * r.dy) + k[2] * r.dz;
  const float dpy = (k[3] * r.dx + k[4] * r.dy) + k[5] * r.dz;
  const float dpz = (k[6] * r.dx + k[7] * r.dy) + k[8] * r.dz;
  t = -opz / (dpz == 0.0f ? kTinyDir : dpz);
  u = opx + t * dpx;
  v = opy + t * dpy;
  return (dpz != 0.0f) && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
         (u + v <= 1.0f) && (t >= r.tmin) && (t < best);
}
