// The two tests every cluster intersector of the port shares: the slab test
// of a ray against a cluster box (cluster_cull) and the affine
// unit-triangle test of a ray against one triangle of a cluster table
// (tri_test). Included by worklist_intersect.cu and regroup_intersect.cu;
// the plain PyTorch versions are _cluster_cull and _tri_tests in
// ops/worklist_intersect.py, which repeat this arithmetic in the same
// order (bit for bit when the kernels are built with -fmad=false).
//
// min/max propagate NaN as torch.minimum/maximum do, so a NaN ray never
// enters a box in either version.

#pragma once

constexpr int kTris = 128;  // triangles per cluster
constexpr int kRows = 16;   // table rows per cluster
constexpr float kSlack = 1.00000024f;
constexpr float kTinyDir = 1e-30f;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
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

// Slab test of one ray against one cluster box [min xyz, max xyz], clipped
// to [tmin, tlim]; the cull of the cluster kernels (pallas_cluster.py
// row_slab / cull).
__device__ __forceinline__ bool cluster_cull(const Ray& r, float tlim,
                                             const float* box) {
  float t0 = (box[0] - r.ox) * r.ix;
  float t1 = (box[3] - r.ox) * r.ix;
  float enter = min_nan(t0, t1);
  float exit = max_nan(t0, t1);
  t0 = (box[1] - r.oy) * r.iy;
  t1 = (box[4] - r.oy) * r.iy;
  enter = max_nan(enter, min_nan(t0, t1));
  exit = min_nan(exit, max_nan(t0, t1));
  t0 = (box[2] - r.oz) * r.iz;
  t1 = (box[5] - r.oz) * r.iz;
  enter = max_nan(enter, min_nan(t0, t1));
  exit = min_nan(exit, max_nan(t0, t1));
  enter = max_nan(enter, r.tmin);
  exit = min_nan(exit, tlim);
  return enter <= exit * kSlack;
}

// Affine unit-triangle test of triangle j of a cluster table `tab` laid out
// [16][128]. Returns true on a hit closer than `best`, with its t, u, v.
__device__ __forceinline__ bool tri_test(const Ray& r, const float* tab,
                                         int j, float best, float& t,
                                         float& u, float& v) {
  const float* c = tab + j;
  const float opx = ((c[0 * kTris] * r.ox + c[1 * kTris] * r.oy) +
                     c[2 * kTris] * r.oz) + c[9 * kTris];
  const float opy = ((c[3 * kTris] * r.ox + c[4 * kTris] * r.oy) +
                     c[5 * kTris] * r.oz) + c[10 * kTris];
  const float opz = ((c[6 * kTris] * r.ox + c[7 * kTris] * r.oy) +
                     c[8 * kTris] * r.oz) + c[11 * kTris];
  const float dpx = (c[0 * kTris] * r.dx + c[1 * kTris] * r.dy) +
                    c[2 * kTris] * r.dz;
  const float dpy = (c[3 * kTris] * r.dx + c[4 * kTris] * r.dy) +
                    c[5 * kTris] * r.dz;
  const float dpz = (c[6 * kTris] * r.dx + c[7 * kTris] * r.dy) +
                    c[8 * kTris] * r.dz;
  t = -opz / (dpz == 0.0f ? kTinyDir : dpz);
  u = opx + t * dpx;
  v = opy + t * dpy;
  return (dpz != 0.0f) && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
         (u + v <= 1.0f) && (t >= r.tmin) && (t < best);
}
