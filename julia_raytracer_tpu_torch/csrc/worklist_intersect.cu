// Worklist cluster intersector: closest hit of each ray over all quads of a
// mid-size scene (113 to ~150k quads), one CTA per 1024-ray block, one
// thread per ray.
//
// Replaces the Pallas TPU kernel julia_raytracer_tpu/ops/pallas_cluster.py
// (_make_kernel_worklist, built by make_cluster_intersect_worklist; both its
// rectangular and its flat grid). The TPU kernel walks a sequential grid
// over (ray block, supercluster) steps and keeps the block's best hit in
// VMEM scratch across steps; here the CTA walks its block's work list in a
// loop and keeps each ray's best hit in registers.
//
// Inputs (ops/worklist_intersect.py builds them):
//   - tab [S*sup, 16, 128] f32: per cluster of 64 quads, rows 0-11 are the
//     128 triangles' affine world -> unit-triangle transforms (m_u, m_v,
//     n_hat, then t_u t_v t_w), rows 12-14 the quad's element normal, row 15
//     the owning instance id as f32;
//   - bbox [S*sup, 8] f32 cluster boxes (min xyz, max xyz, 2 pad); padding
//     clusters sit at +3e38 and are never entered;
//   - order [nb, S] i32 / cnt [nb] i32: each ray block's superclusters
//     front to back (the precull in plain PyTorch), live count first.
//
// Semantics (identical to the plain PyTorch version in
// ops/worklist_intersect.py, bit for bit when built with -fmad=false):
//   - superclusters in list order, their clusters in index order;
//   - each ray slab-tests each cluster box against [tmin, min(tmax, best_t)]
//     with the 1.00000024 slack of the TPU kernel (cluster_cull), and tests
//     the 128 triangles of a cluster it wants in index order with a strict
//     `<` against its running best t (tri_test), so the first minimum wins;
//   - triangle 2i is (p1, p2, p4) of quad i, triangle 2i+1 is (p3, p4, p2)
//     with its uv flipped;
//   - out: prim = best triangle / 2 (-1 on a miss), t = best t (tmax on a
//     miss), position = o + t d, the element normal and instance of the hit
//     (0 on a miss).
// The cull and the triangle test are cluster_cull and tri_test of
// cluster_test.cuh, shared with regroup_intersect.cu.
//
// What bounds it on an H100: the triangle tests. Each (ray, cluster) pair
// that passes the cull costs 128 tests of 40 fp32 operations; the bytes are
// the rays (32 B in, 44 B out each) and the table read once (8 KB per
// cluster; 13.6 MB for the 102,406-quad sphere scene, which fits in the
// 50 MB L2). So it is bound by operations at 67 TFLOP/s fp32 (no tensor
// cores: the hit test is a divide and compares, and the TPU's bf16 split3
// matmul workaround has no purpose here). The design: a cluster is loaded
// into shared memory (8 KB) only when some ray of the CTA wants it
// (__syncthreads_or), every thread then reads the same triangle at once
// (shared-memory broadcast), and groups of 8 culled clusters are skipped
// after one vote, as the TPU kernel's G8 groups are. wgmma, TMA, persistent
// CTAs and smaller ray blocks are later work.

#include <cuda_runtime.h>

#include "cluster_test.cuh"

namespace {

constexpr int kBlock = 1024;  // rays per block = threads per CTA
constexpr int kMaxSup = 128;  // clusters per supercluster (upper limit)

__global__ void __launch_bounds__(kBlock) worklist_intersect_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int n, const float* __restrict__ tab, const float* __restrict__ bbox,
    const int* __restrict__ order, const int* __restrict__ cnt, int n_super,
    int sup, int q, int* __restrict__ prim_out, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ t_out,
    float* __restrict__ pos_out, float* __restrict__ nrm_out,
    int* __restrict__ inst_out) {
  __shared__ __align__(16) float tile[kRows * kTris];  // one cluster, 8 KB
  __shared__ float boxes[kMaxSup * 8];                  // one supercluster

  const int b = blockIdx.x;
  const int i = b * kBlock + threadIdx.x;
  const bool live = i < n;
  Ray r = {};
  float tmax = 0.0f;
  if (live) {
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
  float best = tmax;
  int best_tri = -1;
  float bu = 0.0f, bv = 0.0f, bnx = 0.0f, bny = 0.0f, bnz = 0.0f, binst = 0.0f;

  const int group = sup < 8 ? sup : 8;  // cluster-skip granularity (G8)
  const int count = cnt[b];
  for (int k = 0; k < count; ++k) {
    const int sc = order[b * n_super + k];
    __syncthreads();  // every thread is done with the previous boxes
    for (int e = threadIdx.x; e < sup * 8; e += kBlock) {
      boxes[e] = bbox[static_cast<size_t>(sc) * sup * 8 + e];
    }
    __syncthreads();
    for (int g = 0; g < sup; g += group) {
      unsigned wants = 0u;
      if (live) {
        const float tlim = min_nan(tmax, best);
        for (int j = 0; j < group; ++j) {
          if (cluster_cull(r, tlim, boxes + (g + j) * 8)) wants |= 1u << j;
        }
      }
      if (!__syncthreads_or(wants != 0u)) continue;
      for (int j = 0; j < group; ++j) {
        const int cl = g + j;
        // best only shrinks, so a box culled at the group's start stays
        // culled: the group vote skips nothing the per-cluster test keeps
        const bool want = ((wants >> j) & 1u) &&
                          cluster_cull(r, min_nan(tmax, best), boxes + cl * 8);
        if (!__syncthreads_or(want)) continue;  // also fences the old tile
        const float4* src = reinterpret_cast<const float4*>(
            tab + (static_cast<size_t>(sc) * sup + cl) * kRows * kTris);
        float4* dst = reinterpret_cast<float4*>(tile);
        for (int e = threadIdx.x; e < kRows * kTris / 4; e += kBlock) {
          dst[e] = src[e];
        }
        __syncthreads();
        if (want) {
          int arg = -1;
          float cu = 0.0f, cv = 0.0f;
          for (int j2 = 0; j2 < kTris; ++j2) {
            float t, u, v;
            if (tri_test(r, tile, j2, best, t, u, v)) {
              best = t;
              cu = u;
              cv = v;
              arg = j2;
            }
          }
          if (arg >= 0) {
            const bool odd = (arg & 1) != 0;
            bu = odd ? 1.0f - cu : cu;
            bv = odd ? 1.0f - cv : cv;
            bnx = tile[12 * kTris + arg];
            bny = tile[13 * kTris + arg];
            bnz = tile[14 * kTris + arg];
            binst = tile[15 * kTris + arg];
            best_tri = (sc * sup + cl) * kTris + arg;
          }
        }
      }
    }
  }

  if (!live) return;
  int prim = best_tri >= 0 ? best_tri / 2 : -1;
  if (prim >= q) prim = -1;
  const float t = prim >= 0 ? best : tmax;
  prim_out[i] = prim;
  u_out[i] = bu;
  v_out[i] = bv;
  t_out[i] = t;
  pos_out[3 * i] = r.ox + t * r.dx;
  pos_out[3 * i + 1] = r.oy + t * r.dy;
  pos_out[3 * i + 2] = r.oz + t * r.dz;
  nrm_out[3 * i] = bnx;
  nrm_out[3 * i + 1] = bny;
  nrm_out[3 * i + 2] = bnz;
  inst_out[i] = static_cast<int>(binst + 0.5f);
}

}  // namespace

extern "C" int worklist_intersect_launch(
    const float* ro, const float* rd, const float* tmin, const float* tmax,
    int n, const float* tab, const float* bbox, const int* order,
    const int* cnt, int n_super, int sup, int q, int* prim, float* u,
    float* v, float* t, float* pos, float* nrm, int* inst,
    cudaStream_t stream) {
  if (n < 0 || n_super < 1 || sup < 1 || sup > kMaxSup ||
      (sup > 8 && sup % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int blocks = (n + kBlock - 1) / kBlock;
  worklist_intersect_kernel<<<blocks, kBlock, 0, stream>>>(
      ro, rd, tmin, tmax, n, tab, bbox, order, cnt, n_super, sup, q, prim, u,
      v, t, pos, nrm, inst);
  return static_cast<int>(cudaGetLastError());
}
