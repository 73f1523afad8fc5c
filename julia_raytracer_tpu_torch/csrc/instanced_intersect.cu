// Two-level instanced intersector: closest hit of each ray over the
// (instance, supercluster) work items of an instanced scene, one CTA per
// 1024-ray block, one thread per ray.
//
// Replaces the Pallas TPU kernel julia_raytracer_tpu/ops/pallas_cluster.py
// _make_kernel_instanced (built by make_cluster_intersect_instanced), both
// its dispatch forms: the K-item rounds under lax.while_loop and the flat
// grid of one step per live (block, item) pair. Here the CTA walks its
// block's whole candidate list in one launch.
//
// Inputs (ops/instanced_intersect.py builds them):
//   - tab [total_sup*sup, 16, 128] f32: each shape's cluster tables in
//     shape space, rows 0-11 the 128 triangles' affine transforms, rows
//     12-14 the element normal, row 15 zeros; bbox [total_sup*sup, 8] f32
//     cluster boxes (padding at +3e38, never entered);
//   - inst_rows [I, 24] f32: [0:9] inverse rotation Ri (obj = world Ri +
//     oi), [9:12] oi, [12:21] forward rotation R (n_w = n_s R);
//   - wi_sup / wi_inst [items] i32: each work item's supercluster and
//     instance;
//   - order [nb, items] i32, tlow [nb, items] f32, cnt [nb] i32: each ray
//     block's candidate items by the slab test of its rays against the
//     items' world boxes (the precull, plain PyTorch), sorted by t_low, the
//     nearest entry of any of the block's rays, with the count first.
//
// Semantics (identical to the plain PyTorch version, bit for bit when
// built with -fmad=false):
//   - the CTA takes its candidates in t_low order and stops before item k
//     once no ray's best t exceeds tlow[k] (__syncthreads_and): the
//     stopping rule of the TPU kernel's rounds, checked per item;
//   - per item, each ray moves into shape space in the JAX arithmetic order
//     (directions not renormalised, so t stays the world t), culls each of
//     the supercluster's clusters against [tmin, min(tmax, best)]
//     (cluster_cull) and tests the 128 triangles of a cluster it wants
//     (closest_tri: index order, strict `<`, uv flipped on odd triangles);
//   - on a hit the element normal is rotated by the instance's forward rows
//     (normalised outside the kernel), the instance is the item's;
//   - out: prim = ((sc * sup + ci) * 128 + j) / 2 in the padded shape-space
//     eval layout (-1 on a miss or at or above q), t = best t (tmax on a
//     miss), position = o + t d in world space, the rotated normal and the
//     instance (0 on a miss).
// The TPU kernel culls per 128-lane row; this one culls per ray, which
// changes no closest hit.
//
// What bounds it on an H100: the triangle tests, as in the worklist kernel:
// each (ray, cluster) pair that passes the cull costs 128 tests of 40 fp32
// operations; the bytes are the rays (32 B in, 44 B out), the candidate
// lists and each touched cluster's 8 KB table. The design: a cluster's table
// is staged in shared memory only when some ray of the CTA wants it
// (__syncthreads_or), and every thread then reads the same triangle at once
// (shared-memory broadcast). wgmma, TMA and a persistent grid are later work.
// Measured on an H100 (PERF.md): the walk, not the tests, sets its time:
// every candidate item costs a box load, a ray transform and one
// block-wide vote per cluster, wanted or not.

#include <cuda_runtime.h>

#include "cluster_test.cuh"

namespace {

constexpr int kBlock = 1024;  // rays per block = threads per CTA
constexpr int kMaxSup = 128;  // clusters per supercluster (upper limit)
constexpr int kRowFloats = 24;

__global__ void __launch_bounds__(kBlock) instanced_intersect_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int n, const float* __restrict__ tab, const float* __restrict__ bbox,
    const float* __restrict__ inst_rows, const int* __restrict__ wi_sup,
    const int* __restrict__ wi_inst, const int* __restrict__ order,
    const float* __restrict__ tlow, const int* __restrict__ cnt, int n_items,
    int sup, int q, int* __restrict__ prim_out, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ t_out,
    float* __restrict__ pos_out, float* __restrict__ nrm_out,
    int* __restrict__ inst_out) {
  __shared__ __align__(16) float tile[kRows * kTris];  // one cluster, 8 KB
  __shared__ float boxes[kMaxSup * 8];                  // one supercluster
  __shared__ float xf[kRowFloats];                      // one instance

  const int b = blockIdx.x;
  const int i = b * kBlock + threadIdx.x;
  const bool live = i < n;
  float wox = 0.0f, woy = 0.0f, woz = 0.0f, wdx = 0.0f, wdy = 0.0f,
        wdz = 0.0f, tmin = 0.0f, tmax = 0.0f;
  if (live) {
    wox = ro[3 * i];
    woy = ro[3 * i + 1];
    woz = ro[3 * i + 2];
    wdx = rd[3 * i];
    wdy = rd[3 * i + 1];
    wdz = rd[3 * i + 2];
    tmin = tmin_in[i];
    tmax = tmax_in[i];
  }
  float best = tmax;
  int best_tri = -1;
  int binst = 0;
  float bu = 0.0f, bv = 0.0f, bnx = 0.0f, bny = 0.0f, bnz = 0.0f;

  const int count = cnt[b];
  const size_t row = static_cast<size_t>(b) * n_items;
  for (int k = 0; k < count; ++k) {
    // stop once no ray can improve on the next item's nearest entry; the
    // barrier also fences the previous item's boxes, row and tile
    if (__syncthreads_and(!live || !(best > tlow[row + k]))) break;
    const int item = order[row + k];
    const int sc = wi_sup[item];
    const int inst = wi_inst[item];
    for (int e = threadIdx.x; e < sup * 8; e += kBlock) {
      boxes[e] = bbox[static_cast<size_t>(sc) * sup * 8 + e];
    }
    if (threadIdx.x < kRowFloats) {
      xf[threadIdx.x] = inst_rows[static_cast<size_t>(inst) * kRowFloats +
                                  threadIdx.x];
    }
    __syncthreads();
    // world -> shape space: obj = world Ri + oi
    Ray r;
    r.ox = ((wox * xf[0] + woy * xf[3]) + woz * xf[6]) + xf[9];
    r.oy = ((wox * xf[1] + woy * xf[4]) + woz * xf[7]) + xf[10];
    r.oz = ((wox * xf[2] + woy * xf[5]) + woz * xf[8]) + xf[11];
    r.dx = (wdx * xf[0] + wdy * xf[3]) + wdz * xf[6];
    r.dy = (wdx * xf[1] + wdy * xf[4]) + wdz * xf[7];
    r.dz = (wdx * xf[2] + wdy * xf[5]) + wdz * xf[8];
    set_inverse_dir(r);
    r.tmin = tmin;
    for (int ci = 0; ci < sup; ++ci) {
      const bool want =
          live && cluster_cull(r, min_nan(tmax, best), boxes + ci * 8);
      if (!__syncthreads_or(want)) continue;  // also fences the old tile
      const float4* src = reinterpret_cast<const float4*>(
          tab + (static_cast<size_t>(sc) * sup + ci) * kRows * kTris);
      float4* dst = reinterpret_cast<float4*>(tile);
      for (int e = threadIdx.x; e < kRows * kTris / 4; e += kBlock) {
        dst[e] = src[e];
      }
      __syncthreads();
      if (want) {
        const int arg = closest_tri(r, tile, best, bu, bv);
        if (arg >= 0) {
          // shape -> world normal: n_w = n_s R
          const float nx = tile[12 * kTris + arg];
          const float ny = tile[13 * kTris + arg];
          const float nz = tile[14 * kTris + arg];
          bnx = (nx * xf[12] + ny * xf[15]) + nz * xf[18];
          bny = (nx * xf[13] + ny * xf[16]) + nz * xf[19];
          bnz = (nx * xf[14] + ny * xf[17]) + nz * xf[20];
          binst = inst;
          best_tri = (sc * sup + ci) * kTris + arg;
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
  pos_out[3 * i] = wox + t * wdx;
  pos_out[3 * i + 1] = woy + t * wdy;
  pos_out[3 * i + 2] = woz + t * wdz;
  nrm_out[3 * i] = bnx;
  nrm_out[3 * i + 1] = bny;
  nrm_out[3 * i + 2] = bnz;
  inst_out[i] = binst;
}

}  // namespace

extern "C" int instanced_intersect_launch(
    const float* ro, const float* rd, const float* tmin, const float* tmax,
    int n, const float* tab, const float* bbox, const float* inst_rows,
    const int* wi_sup, const int* wi_inst, const int* order,
    const float* tlow, const int* cnt, int n_items, int sup, int q, int* prim,
    float* u, float* v, float* t, float* pos, float* nrm, int* inst,
    cudaStream_t stream) {
  if (n < 0 || n_items < 1 || sup < 1 || sup > kMaxSup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int blocks = (n + kBlock - 1) / kBlock;
  instanced_intersect_kernel<<<blocks, kBlock, 0, stream>>>(
      ro, rd, tmin, tmax, n, tab, bbox, inst_rows, wi_sup, wi_inst, order,
      tlow, cnt, n_items, sup, q, prim, u, v, t, pos, nrm, inst);
  return static_cast<int>(cudaGetLastError());
}
