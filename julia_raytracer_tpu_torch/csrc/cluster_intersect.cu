// Cluster intersectors without a work list: closest hit of each ray over
// every cluster of a quad soup, one CTA per 1024-ray block, one thread per
// ray. Two kernels:
//
//   - cluster_sweep_kernel replaces the Pallas TPU kernel
//     julia_raytracer_tpu/ops/pallas_cluster.py _make_kernel (built by
//     make_cluster_intersect): the block sweeps all C clusters in index
//     order, each ray culling each cluster box against [tmin, tmax];
//   - cluster_streamed_kernel replaces _make_kernel_streamed (built by
//     make_cluster_intersect_hbm): the block walks the superclusters of 64
//     clusters in index order, culls each ray against the supercluster box
//     and then, inside a supercluster some ray enters, each cluster box,
//     both against [tmin, tmax]. The TPU kernel streams one supercluster's
//     tables per grid step and carries the block's best hit in VMEM scratch
//     across steps; here the loop over superclusters is inside the CTA and
//     the best hit stays in registers.
//
// Inputs (ops/cluster_intersect.py packs them, as ops/worklist_intersect.py
// does with 64 clusters per supercluster): tab [S*64, 16, 128] f32 (rows
// 0-11 the triangles' affine transforms, 12-14 the element normal, 15 the
// instance id as f32), bbox [S*64, 8] f32 (padding at +3e38), sbbox [S, 8]
// f32.
//
// Semantics (identical to the plain PyTorch versions, bit for bit when
// built with -fmad=false): the cull uses the ray's tmax as the TPU kernels
// do (not its running best); a wanted cluster's 128 triangles are tested
// in index order with a strict `<` against the running best (closest_tri);
// out: prim = best triangle / 2 (-1 on a miss or at or above q), t = best
// t (tmax on a miss), position = o + t d, the element normal and the
// instance of the hit (0 on a miss). The TPU kernels cull per block
// (phase A of _make_kernel) or per 128-lane row (_make_kernel_streamed) and
// test every ray of a wanted row; these cull per ray, which changes no
// closest hit.
//
// What bounds them on an H100: the triangle tests (128 tests of 40 fp32
// operations per (ray, cluster) pair that passes the cull), as for the
// worklist kernel. A cluster's table is staged in shared memory only when
// some ray of the CTA wants it (__syncthreads_or); the streamed kernel
// also skips a supercluster no ray enters after one vote.

#include <cuda_runtime.h>

#include "cluster_test.cuh"

namespace {

constexpr int kBlock = 1024;  // rays per block = threads per CTA
constexpr int kSuper = 64;    // clusters per supercluster

struct Best {
  float t, u, v, nx, ny, nz, inst;
  int tri;
};

__device__ __forceinline__ void load_ray(const float* ro, const float* rd,
                                         const float* tmin_in,
                                         const float* tmax_in, int i,
                                         bool live, Ray& r, float& tmax) {
  r = Ray{};
  tmax = 0.0f;
  if (!live) return;
  r.ox = ro[3 * i];
  r.oy = ro[3 * i + 1];
  r.oz = ro[3 * i + 2];
  r.dx = rd[3 * i];
  r.dy = rd[3 * i + 1];
  r.dz = rd[3 * i + 2];
  set_inverse_dir(r);
  r.tmin = tmin_in[i];
  tmax = tmax_in[i];
}

// Stage cluster `cl`'s table in `tile` (the caller fenced the old one) and,
// for a ray that wants it, test its triangles.
__device__ __forceinline__ void test_cluster(const Ray& r, bool want,
                                             const float* tab, int cl,
                                             float* tile, Best& b) {
  const float4* src =
      reinterpret_cast<const float4*>(tab + static_cast<size_t>(cl) * kRows * kTris);
  float4* dst = reinterpret_cast<float4*>(tile);
  for (int e = threadIdx.x; e < kRows * kTris / 4; e += kBlock) dst[e] = src[e];
  __syncthreads();
  if (!want) return;
  const int arg = closest_tri(r, tile, b.t, b.u, b.v);
  if (arg >= 0) {
    b.nx = tile[12 * kTris + arg];
    b.ny = tile[13 * kTris + arg];
    b.nz = tile[14 * kTris + arg];
    b.inst = tile[15 * kTris + arg];
    b.tri = cl * kTris + arg;
  }
}

__device__ __forceinline__ void store_hit(const Ray& r, float tmax, int q,
                                          const Best& b, int i, int* prim_out,
                                          float* u_out, float* v_out,
                                          float* t_out, float* pos_out,
                                          float* nrm_out, int* inst_out) {
  int prim = b.tri >= 0 ? b.tri / 2 : -1;
  if (prim >= q) prim = -1;
  const float t = prim >= 0 ? b.t : tmax;
  prim_out[i] = prim;
  u_out[i] = b.u;
  v_out[i] = b.v;
  t_out[i] = t;
  pos_out[3 * i] = r.ox + t * r.dx;
  pos_out[3 * i + 1] = r.oy + t * r.dy;
  pos_out[3 * i + 2] = r.oz + t * r.dz;
  nrm_out[3 * i] = b.nx;
  nrm_out[3 * i + 1] = b.ny;
  nrm_out[3 * i + 2] = b.nz;
  inst_out[i] = static_cast<int>(b.inst + 0.5f);
}

__global__ void __launch_bounds__(kBlock) cluster_sweep_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int n, const float* __restrict__ tab, const float* __restrict__ bbox,
    int n_clusters, int q, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    float* __restrict__ t_out, float* __restrict__ pos_out,
    float* __restrict__ nrm_out, int* __restrict__ inst_out) {
  __shared__ __align__(16) float tile[kRows * kTris];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  Ray r;
  float tmax;
  load_ray(ro, rd, tmin_in, tmax_in, i, live, r, tmax);
  Best b = {tmax, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1};
  for (int cl = 0; cl < n_clusters; ++cl) {
    const bool want = live && cluster_cull(r, tmax, bbox + cl * 8);
    if (!__syncthreads_or(want)) continue;  // also fences the old tile
    test_cluster(r, want, tab, cl, tile, b);
  }
  if (live) {
    store_hit(r, tmax, q, b, i, prim_out, u_out, v_out, t_out, pos_out,
              nrm_out, inst_out);
  }
}

__global__ void __launch_bounds__(kBlock) cluster_streamed_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int n, const float* __restrict__ tab, const float* __restrict__ bbox,
    const float* __restrict__ sbbox, int n_super, int q,
    int* __restrict__ prim_out, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ t_out,
    float* __restrict__ pos_out, float* __restrict__ nrm_out,
    int* __restrict__ inst_out) {
  __shared__ __align__(16) float tile[kRows * kTris];
  __shared__ float boxes[kSuper * 8];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  Ray r;
  float tmax;
  load_ray(ro, rd, tmin_in, tmax_in, i, live, r, tmax);
  Best b = {tmax, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1};
  for (int s = 0; s < n_super; ++s) {
    const bool in_super = live && cluster_cull(r, tmax, sbbox + s * 8);
    // the vote also fences the previous supercluster's boxes
    if (!__syncthreads_or(in_super)) continue;
    for (int e = threadIdx.x; e < kSuper * 8; e += kBlock) {
      boxes[e] = bbox[static_cast<size_t>(s) * kSuper * 8 + e];
    }
    __syncthreads();
    for (int ci = 0; ci < kSuper; ++ci) {
      const bool want = in_super && cluster_cull(r, tmax, boxes + ci * 8);
      if (!__syncthreads_or(want)) continue;  // also fences the old tile
      test_cluster(r, want, tab, s * kSuper + ci, tile, b);
    }
  }
  if (live) {
    store_hit(r, tmax, q, b, i, prim_out, u_out, v_out, t_out, pos_out,
              nrm_out, inst_out);
  }
}

int blocks_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" int cluster_sweep_launch(
    const float* ro, const float* rd, const float* tmin, const float* tmax,
    int n, const float* tab, const float* bbox, int n_clusters, int q,
    int* prim, float* u, float* v, float* t, float* pos, float* nrm,
    int* inst, cudaStream_t stream) {
  if (n < 0 || n_clusters < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cluster_sweep_kernel<<<blocks_for(n), kBlock, 0, stream>>>(
      ro, rd, tmin, tmax, n, tab, bbox, n_clusters, q, prim, u, v, t, pos,
      nrm, inst);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cluster_streamed_launch(
    const float* ro, const float* rd, const float* tmin, const float* tmax,
    int n, const float* tab, const float* bbox, const float* sbbox,
    int n_super, int q, int* prim, float* u, float* v, float* t, float* pos,
    float* nrm, int* inst, cudaStream_t stream) {
  if (n < 0 || n_super < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cluster_streamed_kernel<<<blocks_for(n), kBlock, 0, stream>>>(
      ro, rd, tmin, tmax, n, tab, bbox, sbbox, n_super, q, prim, u, v, t, pos,
      nrm, inst);
  return static_cast<int>(cudaGetLastError());
}
