// Cluster intersectors without a work list: closest hit of each ray over
// every cluster of a quad soup, one thread per ray, each warp of 32 rays
// walking the clusters on its own (warp_walk.cuh). Two kernels:
//
//   - cluster_sweep_kernel replaces the Pallas TPU kernel
//     julia_raytracer_tpu/ops/pallas_cluster.py _make_kernel (built by
//     make_cluster_intersect): the warp sweeps all C clusters in index
//     order, in steps of up to 128, each ray culling each cluster box
//     against [tmin, tmax];
//   - cluster_streamed_kernel replaces _make_kernel_streamed (built by
//     make_cluster_intersect_hbm): the warp walks the superclusters of 64
//     clusters in index order, one step each; each ray culls the
//     supercluster box and then, inside one it enters, each cluster box,
//     both against [tmin, tmax], and a warp none of whose rays enters it
//     skips the supercluster after one vote (the TPU kernel's `pl.when`).
//     The TPU kernel streams one supercluster's tables per grid step and
//     carries the block's best hit in VMEM scratch across steps; here the
//     loop over superclusters is inside the warp and the best hit stays in
//     registers.
//
// Inputs (ops/cluster_intersect.py packs them, as ops/worklist_intersect.py
// does with 64 clusters per supercluster): tab [S*64, 16, 128] f32 (rows
// 0-11 the triangles' affine transforms, 12-14 the element normal, 15 the
// instance id as f32), bbox [S*64, 8] f32 (padding at +3e38), sbbox [S, 8]
// f32.
//
// Semantics (identical to the plain PyTorch versions, bit for bit when
// built with -fmad=false): the cull uses the ray's tmax as the TPU kernels
// do (not its running best: warp_super_step<false, false>, no re-cull); a
// wanted cluster's 128 triangles are tested against the running best and
// the first minimum in index order wins, as a strict `<` finds it
// (_closest_tri of ops/worklist_intersect.py); out: prim = best triangle
// / 2 (-1 on a miss or at or above q), t = best t (tmax on a miss),
// position = o + t d, the element normal and the instance of the hit (0
// on a miss), read at the end from the winning cluster's rows 12-15. The
// TPU kernels cull per block (phase A of _make_kernel) or per 128-lane row
// (_make_kernel_streamed) and test every ray of a wanted row; these cull
// per ray, which changes no closest hit.
//
// What bounded the old design on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md section 6, the sphere grid's 262,144 bounce rays, 1,601
// clusters in 26 superclusters): 28.837 ms (sweep) and 29.343 ms
// (streamed), about 290x the 0.0989 ms bound. One 1024-thread CTA per
// 1024-ray block (256 CTAs, one per SM, two waves on 132 SMs) walked all
// 1,601 clusters with a block-wide vote, a synchronous 8 KB table copy
// into shared memory and a second barrier per cluster, each wanting ray
// then running the 128 tests alone while the rest of the block waited:
// every block wanted every cluster, at about 4 rays a (block, cluster).
//
// What bounds this design: 128-thread CTAs of 4 independent warps, no
// shared memory, no block-wide barrier. A (warp, cluster) pair with a
// wanting ray costs one load of the table's 12 transform rows (6 KB,
// through L2: the 13.6 MB table fits in the 50 MB L2) into registers; its
// wanting rays are tested one after another on all 32 lanes. The sweep
// also pays n x C box culls that no hierarchy prunes in this function
// (262,144 x 1,601, about 4.2e8 slab tests on the sphere grid); the
// streamed kernel prunes them by the supercluster boxes. The count of
// table loads is the plain versions' `loads`. Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md section 6) on those rays: 1.906 ms (sweep)
// and 1.416 ms (streamed), 19x and 14x the bound, in turns 15x and 21x
// faster than the old design; 645,174 table loads at 2.51 rays a load
// (3.96 GB from L2, 2.8 TB/s in the streamed kernel's time), 114 and
// 111 registers (4 CTAs of 128 threads an SM).

#include <cuda_runtime.h>

#include "warp_walk.cuh"

namespace {

constexpr int kThreads = 128;               // 4 independent warps per CTA
constexpr int kSuper = 64;                  // clusters per supercluster
constexpr int kStep = kMaskWords * kWarp;   // clusters per sweep step

__device__ __forceinline__ void load_ray(const float* __restrict__ ro,
                                         const float* __restrict__ rd,
                                         const float* __restrict__ tmin_in,
                                         const float* __restrict__ tmax_in,
                                         int i, Ray& r, float& tmax) {
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

__device__ __forceinline__ void store_hit(const Ray& r, float tmax, int q,
                                          const Best& b,
                                          const float* __restrict__ tab,
                                          int i, int* prim_out, float* u_out,
                                          float* v_out, float* t_out,
                                          float* pos_out, float* nrm_out,
                                          int* inst_out) {
  int prim = -1;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, inst = 0.0f;
  if (b.cluster >= 0) {
    prim = (b.cluster * kTris + b.arg) / 2;
    const float* attr =
        tab + static_cast<size_t>(b.cluster) * kRows * kTris + b.arg;
    nx = attr[12 * kTris];
    ny = attr[13 * kTris];
    nz = attr[14 * kTris];
    inst = attr[15 * kTris];
  }
  if (prim >= q) prim = -1;
  const float t = prim >= 0 ? b.t : tmax;
  prim_out[i] = prim;
  u_out[i] = b.u;
  v_out[i] = b.v;
  t_out[i] = t;
  pos_out[3 * i] = r.ox + t * r.dx;
  pos_out[3 * i + 1] = r.oy + t * r.dy;
  pos_out[3 * i + 2] = r.oz + t * r.dz;
  nrm_out[3 * i] = nx;
  nrm_out[3 * i + 1] = ny;
  nrm_out[3 * i + 2] = nz;
  inst_out[i] = static_cast<int>(inst + 0.5f);
}

__global__ void __launch_bounds__(kThreads) cluster_sweep_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int n, const float* __restrict__ tab, const float* __restrict__ bbox,
    int n_clusters, int q, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    float* __restrict__ t_out, float* __restrict__ pos_out,
    float* __restrict__ nrm_out, int* __restrict__ inst_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if ((i & ~(kWarp - 1)) >= n) return;  // the whole warp: no lane is a ray
  const bool live = i < n;  // the other lanes still vote and shuffle
  Ray r = {};
  float tmax = 0.0f;
  if (live) load_ray(ro, rd, tmin_in, tmax_in, i, r, tmax);
  Best b = {tmax, 0.0f, 0.0f, -1, 0, 0};
  for (int c0 = 0; c0 < n_clusters; c0 += kStep) {
    warp_super_step<false, false>(
        r, tmax, live, b, bbox + static_cast<size_t>(c0) * 8,
        tab + static_cast<size_t>(c0) * kRows * kTris,
        min(kStep, n_clusters - c0), c0, 0);
  }
  if (live) {
    store_hit(r, tmax, q, b, tab, i, prim_out, u_out, v_out, t_out, pos_out,
              nrm_out, inst_out);
  }
}

__global__ void __launch_bounds__(kThreads) cluster_streamed_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int n, const float* __restrict__ tab, const float* __restrict__ bbox,
    const float* __restrict__ sbbox, int n_super, int q,
    int* __restrict__ prim_out, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ t_out,
    float* __restrict__ pos_out, float* __restrict__ nrm_out,
    int* __restrict__ inst_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if ((i & ~(kWarp - 1)) >= n) return;
  const bool live = i < n;
  Ray r = {};
  float tmax = 0.0f;
  if (live) load_ray(ro, rd, tmin_in, tmax_in, i, r, tmax);
  Best b = {tmax, 0.0f, 0.0f, -1, 0, 0};
  for (int s = 0; s < n_super; ++s) {
    float sbox[8];
    load_box(sbbox + static_cast<size_t>(s) * 8, sbox);
    const bool enter = live && cluster_cull(r, tmax, sbox);
    if (!__any_sync(kFullMask, enter)) continue;
    warp_super_step<false, false>(
        r, tmax, enter, b, bbox + static_cast<size_t>(s) * kSuper * 8,
        tab + static_cast<size_t>(s) * kSuper * kRows * kTris, kSuper,
        s * kSuper, 0);
  }
  if (live) {
    store_hit(r, tmax, q, b, tab, i, prim_out, u_out, v_out, t_out, pos_out,
              nrm_out, inst_out);
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int cluster_sweep_launch(
    const float* ro, const float* rd, const float* tmin, const float* tmax,
    int n, const float* tab, const float* bbox, int n_clusters, int q,
    int* prim, float* u, float* v, float* t, float* pos, float* nrm,
    int* inst, cudaStream_t stream) {
  if (n < 0 || n_clusters < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cluster_sweep_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
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
  cluster_streamed_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      ro, rd, tmin, tmax, n, tab, bbox, sbbox, n_super, q, prim, u, v, t, pos,
      nrm, inst);
  return static_cast<int>(cudaGetLastError());
}
