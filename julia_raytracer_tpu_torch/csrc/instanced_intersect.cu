// Two-level instanced intersector: closest hit of each ray over the
// (instance, supercluster) work items of an instanced scene, one thread per
// ray, each warp walking its own candidate list.
//
// Replaces the Pallas TPU kernel julia_raytracer_tpu/ops/pallas_cluster.py
// _make_kernel_instanced (built by make_cluster_intersect_instanced), both
// its dispatch forms: the K-item rounds under lax.while_loop and the flat
// grid of one step per live (block, item) pair. Here each warp walks its
// group's whole candidate list in one launch.
//
// Inputs (ops/instanced_intersect.py builds them):
//   - tab [total_sup*sup, 16, 128] f32: each shape's cluster tables in
//     shape space, rows 0-11 the 128 triangles' affine transforms, rows
//     12-14 the element normal, row 15 zeros; bbox [total_sup*sup, 8] f32
//     cluster boxes (padding at +3e38, never entered);
//   - inst_rows [I, 24] f32: [0:9] inverse rotation Ri (obj = world Ri +
//     oi), [9:12] oi, [12:21] forward rotation R (n_w = n_s R);
//   - wi_sup / wi_inst [items] i32: each work item's supercluster and
//     instance; wi_bbox [items, 6] f32 its world box;
//   - order [ng, items] i32, tlow [ng, items] f32, cnt [ng] i32: each group
//     of `group` rays' (256 by default, a multiple of the warp) candidate
//     items by the slab test of its rays against the items' world boxes
//     (the candidate cull, candidate_cull.cu), sorted by t_low, the nearest
//     entry of any of the group's rays, with the count first.
//
// Semantics (identical to the plain PyTorch version, bit for bit when
// built with -fmad=false):
//   - each warp takes its group's candidates in t_low order and stops before
//     item k once none of its rays' best t exceeds tlow[k] (a warp vote: the
//     stopping rule of the TPU kernel's rounds, per item and per warp);
//   - a ray enters item k if it passes the slab test of the item's world box
//     against [tmin, min(tmax, best)] (cluster_cull); a warp none of whose
//     rays enters it skips the item after that vote (the world boxes are
//     rounded outward from float64 corners by scene/instanced.py, so each
//     holds its supercluster's box and this per-ray test drops no hit);
//   - the rays move into shape space in the JAX arithmetic order
//     (directions not renormalised, so t stays the world t) and take the
//     item's supercluster through warp_super_step (warp_walk.cuh): each ray
//     that entered culls every cluster against its best into a mask, one
//     mask vote, then the clusters in index order, each ray's closest hit
//     among a wanted cluster's 128 triangles the first minimum below its
//     running best;
//   - on a hit the element normal is rotated by the instance's forward rows
//     (normalised outside the kernel), the instance is the item's;
//   - out: prim = ((sc * sup + ci) * 128 + j) / 2 in the padded shape-space
//     eval layout (-1 on a miss or at or above q), t = best t (tmax on a
//     miss), position = o + t d in world space, the rotated normal and the
//     instance (0 on a miss).
// The TPU kernel culls per 128-lane row; this one per ray, which changes no
// closest hit.
//
// What bounds it on an H100: the triangle tests, as in the worklist kernel:
// each (ray, cluster) pair that passes the cull costs 128 tests of 40 fp32
// operations; the bytes are the rays (32 B in, 44 B out), the list entries
// walked and each touched cluster's 8 KB table. The old design (one
// 1024-thread CTA per ray block walking the block's list, a box load and
// ray transform per item and one block-wide vote per cluster, wanted or
// not, stopping only when all 1,024 rays were done) walked 803 items per
// block and stopped early in none: 142.294 ms on the instanced scene's
// bounce rays, 2,770x its bound (PERF.md, H100 80GB HBM3, 700 W). This
// design walks per warp: a list and a stop of its own, one entry vote and
// one mask vote per (warp, item), the item's boxes, instance row and
// tables read through the read-only path, no shared memory and no
// block-wide barrier, several CTAs per SM (128 registers: 4 CTAs, 16
// warps). Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section
// 6): 2.032 ms on the same rays, 40x its 0.0503 ms bound, with lists per
// 256 rays: 2,420,557 (warp, item) steps, 296,250 of them with an
// entering ray and a mask vote, 2.24 rays per table load, 49% of the
// triangle loop's lane slots on real triangles (the room's and small
// meshes' clusters are mostly padding); the steps and the per-item
// cluster culls set its time (1.815 ms with lists per 128 rays).

#include <cuda_runtime.h>

#include "warp_walk.cuh"

namespace {

constexpr int kThreads = 128;  // 4 independent warps per CTA
constexpr int kMaxSup = kMaskWords * kWarp;
constexpr int kRowFloats = 24;

__global__ void __launch_bounds__(kThreads) instanced_intersect_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int n, const float* __restrict__ tab, const float* __restrict__ bbox,
    const float* __restrict__ inst_rows, const int* __restrict__ wi_sup,
    const int* __restrict__ wi_inst, const float* __restrict__ wi_bbox,
    const int* __restrict__ order, const float* __restrict__ tlow,
    const int* __restrict__ cnt, int n_items, int sup, int group, int q,
    int* __restrict__ prim_out, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ t_out,
    float* __restrict__ pos_out, float* __restrict__ nrm_out,
    int* __restrict__ inst_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int first = i & ~(kWarp - 1);
  if (first >= n) return;  // the whole warp: no lane of it is a ray
  const bool live = i < n;  // the other lanes still vote and shuffle
  Ray w = {};  // the world ray
  float tmax = 0.0f;
  if (live) {
    w.ox = ro[3 * i];
    w.oy = ro[3 * i + 1];
    w.oz = ro[3 * i + 2];
    w.dx = rd[3 * i];
    w.dy = rd[3 * i + 1];
    w.dz = rd[3 * i + 2];
    set_inverse_dir(w);
    w.tmin = tmin_in[i];
    tmax = tmax_in[i];
  }
  Best b = {tmax, 0.0f, 0.0f, -1, 0, 0};

  const int g = first / group;
  const int count = cnt[g];
  const size_t row = static_cast<size_t>(g) * n_items;
  for (int k = 0; k < count; ++k) {
    // stop once no ray can improve on the next item's nearest entry
    if (!__any_sync(kFullMask, live && b.t > __ldg(tlow + row + k))) break;
    const int item = __ldg(order + row + k);
    float box[8];
    const float* wb = wi_bbox + static_cast<size_t>(item) * 6;
#pragma unroll
    for (int e = 0; e < 6; ++e) box[e] = __ldg(wb + e);
    const bool enter = live && cluster_cull(w, min_nan(tmax, b.t), box);
    if (!__any_sync(kFullMask, enter)) continue;
    const int sc = __ldg(wi_sup + item);
    const int inst = __ldg(wi_inst + item);
    const float4* xp = reinterpret_cast<const float4*>(
        inst_rows + static_cast<size_t>(inst) * kRowFloats);
    const float4 x0 = __ldg(xp), x1 = __ldg(xp + 1), x2 = __ldg(xp + 2);
    const float xf[12] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y,
                          x1.z, x1.w, x2.x, x2.y, x2.z, x2.w};
    // world -> shape space: obj = world Ri + oi
    Ray r;
    r.ox = ((w.ox * xf[0] + w.oy * xf[3]) + w.oz * xf[6]) + xf[9];
    r.oy = ((w.ox * xf[1] + w.oy * xf[4]) + w.oz * xf[7]) + xf[10];
    r.oz = ((w.ox * xf[2] + w.oy * xf[5]) + w.oz * xf[8]) + xf[11];
    r.dx = (w.dx * xf[0] + w.dy * xf[3]) + w.dz * xf[6];
    r.dy = (w.dx * xf[1] + w.dy * xf[4]) + w.dz * xf[7];
    r.dz = (w.dx * xf[2] + w.dy * xf[5]) + w.dz * xf[8];
    set_inverse_dir(r);
    r.tmin = w.tmin;
    warp_super_step(r, tmax, enter, b,
                    bbox + static_cast<size_t>(sc) * sup * 8,
                    tab + static_cast<size_t>(sc) * sup * kRows * kTris, sup,
                    sc * sup, inst);
  }

  if (!live) return;
  int prim = -1;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (b.cluster >= 0) {
    prim = (b.cluster * kTris + b.arg) / 2;
    // shape -> world normal: n_w = n_s R
    const float* attr =
        tab + static_cast<size_t>(b.cluster) * kRows * kTris + b.arg;
    const float sx = attr[12 * kTris];
    const float sy = attr[13 * kTris];
    const float sz = attr[14 * kTris];
    const float* f = inst_rows + static_cast<size_t>(b.tag) * kRowFloats;
    nx = (sx * f[12] + sy * f[15]) + sz * f[18];
    ny = (sx * f[13] + sy * f[16]) + sz * f[19];
    nz = (sx * f[14] + sy * f[17]) + sz * f[20];
  }
  if (prim >= q) prim = -1;
  const float t = prim >= 0 ? b.t : tmax;
  prim_out[i] = prim;
  u_out[i] = b.u;
  v_out[i] = b.v;
  t_out[i] = t;
  pos_out[3 * i] = w.ox + t * w.dx;
  pos_out[3 * i + 1] = w.oy + t * w.dy;
  pos_out[3 * i + 2] = w.oz + t * w.dz;
  nrm_out[3 * i] = nx;
  nrm_out[3 * i + 1] = ny;
  nrm_out[3 * i + 2] = nz;
  inst_out[i] = b.cluster >= 0 ? b.tag : 0;
}

}  // namespace

extern "C" int instanced_intersect_launch(
    const float* ro, const float* rd, const float* tmin, const float* tmax,
    int n, const float* tab, const float* bbox, const float* inst_rows,
    const int* wi_sup, const int* wi_inst, const float* wi_bbox,
    const int* order, const float* tlow, const int* cnt, int n_items, int sup,
    int group, int q, int* prim, float* u, float* v, float* t, float* pos,
    float* nrm, int* inst, cudaStream_t stream) {
  if (n < 0 || n_items < 1 || sup < 1 || sup > kMaxSup || group < kWarp ||
      group % kWarp != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  instanced_intersect_kernel<<<blocks, kThreads, 0, stream>>>(
      ro, rd, tmin, tmax, n, tab, bbox, inst_rows, wi_sup, wi_inst, wi_bbox,
      order, tlow, cnt, n_items, sup, group, q, prim, u, v, t, pos, nrm, inst);
  return static_cast<int>(cudaGetLastError());
}
