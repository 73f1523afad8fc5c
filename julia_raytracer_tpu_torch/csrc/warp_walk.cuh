// The inner step that the worklist kernel (worklist_intersect.cu), the
// work-item kernel (instanced_intersect.cu), the regroup tri-test
// (regroup_intersect.cu) and the two cluster kernels without a work list
// (cluster_intersect.cu) share: one warp of 32 rays against the clusters
// of one supercluster (or one step of up to 128 clusters), with no
// block-wide barrier.
//
//   1. Each ray slab-tests every cluster box of the step against
//      [tmin, min(tmax, best)] (cluster_cull, best at the step's start)
//      into a mask of up to 128 bits; a ray that does not enter the step
//      (`enter` false) keeps an empty mask. The template parameter
//      kCullToBest (true unless a caller asks otherwise) picks that limit;
//      the cluster kernels turn it off and cull against tmax alone, as
//      their TPU kernels do.
//   2. The warp ORs the masks once (__reduce_or_sync): the mask vote.
//   3. For each set cluster in index order, each ray whose bit is set
//      culls the cluster again against its running best (best only
//      shrinks, so this keeps no cluster the step-start cull dropped; the
//      template parameter kRecull, true unless a caller asks otherwise);
//      the rays that still want it are the ballot. The regroup tri-test
//      (regroup_intersect.cu) and the cluster kernels turn the re-cull
//      off: their rays test every cluster their tmax lets in, as the TPU
//      kernels do.
//   4. If any does, the warp loads the cluster's 12 transform rows through
//      the read-only path, 4 triangles a lane (one coalesced float4 per row
//      and lane), and tests the wanting rays one after another: the ray's
//      fields are broadcast by shuffles, every lane tests its 4 triangles
//      against that ray's best, and a shuffle min over (t, index) finds
//      the first minimum. Each lane tests against the ray's best at the
//      cluster's start, so this is the hit the serial strict `<` over the
//      128 triangles in index order finds (_closest_tri of
//      ops/worklist_intersect.py), bit for bit.
//
// So the triangle tests of a (ray, cluster) pair keep all 32 lanes busy,
// whatever the number of rays in the warp that want the cluster (a lane
// slot that holds a padding or degenerate triangle runs the never-hit
// transform: the plain versions count the real ones, `tri_slots`), and a
// table is loaded once per (warp, cluster) that some ray wants. The plain
// PyTorch versions of the kernels take the clusters of a step in the same
// order against the same running best.

#pragma once

#include "cluster_test.cuh"

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaskWords = 4;  // up to 128 clusters per supercluster
constexpr int kNoTri = kTris;  // the shuffle min's "no hit" index

// A ray's best hit so far: t (tmax until a hit), u and v (flipped on odd
// triangles), the global cluster id and the triangle (-1 / 0: no hit) and
// a tag the caller attaches to the step (the instance, or 0).
struct Best {
  float t, u, v;
  int cluster, arg, tag;
};

__device__ __forceinline__ void load_box(const float* __restrict__ p,
                                         float (&box)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  box[0] = a.x; box[1] = a.y; box[2] = a.z; box[3] = a.w;
  box[4] = b.x; box[5] = b.y; box[6] = b.z; box[7] = b.w;
}

template <int M>
__device__ __forceinline__ float component(const float4& a) {
  return M == 0 ? a.x : (M == 1 ? a.y : (M == 2 ? a.z : a.w));
}

// Lane l's triangles 4l .. 4l+3 of the cluster table `tab` ([16][128]):
// rows 0-11, one float4 per row.
__device__ __forceinline__ void load_lane_tris(const float* __restrict__ tab,
                                               float4 (&c)[12]) {
  const float4* p =
      reinterpret_cast<const float4*>(tab) + (threadIdx.x & (kWarp - 1));
#pragma unroll
  for (int q = 0; q < 12; ++q) c[q] = __ldg(p + q * (kTris / 4));
}

template <int M>
__device__ __forceinline__ void lane_test(const Ray& r, const float4 (&c)[12],
                                          int lane, float& bt, int& bi,
                                          float& bu, float& bv) {
  float k[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) k[q] = component<M>(c[q]);
  float t, u, v;
  if (tri_test_k(r, k, bt, t, u, v)) {
    bt = t;
    bi = 4 * lane + M;
    bu = u;
    bv = v;
  }
}

// Closest hit of ray r (the same on every lane) below `best` among the 128
// triangles held 4 a lane in c: the first minimum in index order. Returns
// the triangle (the same on every lane) or -1; on a hit t, u and v (not
// flipped) are the winner's on every lane.
__device__ __forceinline__ int warp_closest(const Ray& r, float best,
                                            const float4 (&c)[12], float& t,
                                            float& u, float& v) {
  const int lane = threadIdx.x & (kWarp - 1);
  float bt = best, bu = 0.0f, bv = 0.0f;
  int bi = kNoTri;
  lane_test<0>(r, c, lane, bt, bi, bu, bv);
  lane_test<1>(r, c, lane, bt, bi, bu, bv);
  lane_test<2>(r, c, lane, bt, bi, bu, bv);
  lane_test<3>(r, c, lane, bt, bi, bu, bv);
  // (t, index) lexicographic min: a hit has t < best, and no t is NaN
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(kFullMask, bt, off);
    const int oi = __shfl_xor_sync(kFullMask, bi, off);
    if (ot < bt || (ot == bt && oi < bi)) {
      bt = ot;
      bi = oi;
    }
  }
  if (bi == kNoTri) return -1;
  t = bt;
  u = __shfl_sync(kFullMask, bu, bi >> 2);
  v = __shfl_sync(kFullMask, bv, bi >> 2);
  return bi;
}

// One warp's rays against one supercluster (the steps in this file's head
// note). boxes: its `sup` cluster boxes [sup][8]; tab: its tables
// [sup][16][128]; cluster0: the global id of its first cluster; tag: kept
// with a hit found here. Every lane of the warp must call it.
template <bool kRecull = true, bool kCullToBest = true>
__device__ __forceinline__ void warp_super_step(
    const Ray& r, float tmax, bool enter, Best& b,
    const float* __restrict__ boxes, const float* __restrict__ tab, int sup,
    int cluster0, int tag) {
  const int lane = threadIdx.x & (kWarp - 1);
  unsigned mask[kMaskWords];
  const float tlim = kCullToBest ? min_nan(tmax, b.t) : tmax;
#pragma unroll
  for (int w = 0; w < kMaskWords; ++w) {
    unsigned m = 0u;
    if (enter) {
      const int j1 = min(sup, (w + 1) * kWarp);
      for (int j = w * kWarp; j < j1; ++j) {
        float box[8];
        load_box(boxes + j * 8, box);
        if (cluster_cull(r, tlim, box)) m |= 1u << (j - w * kWarp);
      }
    }
    mask[w] = m;
  }
#pragma unroll
  for (int w = 0; w < kMaskWords; ++w) {
    unsigned bits = __reduce_or_sync(kFullMask, mask[w]);  // the mask vote
    while (bits != 0u) {
      const int jj = __ffs(bits) - 1;
      bits &= bits - 1u;
      const int j = w * kWarp + jj;
      bool want = (mask[w] >> jj) & 1u;
      if (kRecull && want) {
        float box[8];
        load_box(boxes + j * 8, box);
        want = cluster_cull(r, min_nan(tmax, b.t), box);
      }
      unsigned who = __ballot_sync(kFullMask, want);
      if (who == 0u) continue;
      float4 c[12];
      load_lane_tris(tab + static_cast<size_t>(j) * kRows * kTris, c);
      while (who != 0u) {
        const int src = __ffs(who) - 1;
        who &= who - 1u;
        Ray rs;
        rs.ox = __shfl_sync(kFullMask, r.ox, src);
        rs.oy = __shfl_sync(kFullMask, r.oy, src);
        rs.oz = __shfl_sync(kFullMask, r.oz, src);
        rs.dx = __shfl_sync(kFullMask, r.dx, src);
        rs.dy = __shfl_sync(kFullMask, r.dy, src);
        rs.dz = __shfl_sync(kFullMask, r.dz, src);
        rs.tmin = __shfl_sync(kFullMask, r.tmin, src);
        const float best = __shfl_sync(kFullMask, b.t, src);
        float t, u, v;
        const int arg = warp_closest(rs, best, c, t, u, v);
        if (arg >= 0 && lane == src) {
          const bool odd = (arg & 1) != 0;
          b.t = t;
          b.u = odd ? 1.0f - u : u;
          b.v = odd ? 1.0f - v : v;
          b.cluster = cluster0 + j;
          b.arg = arg;
          b.tag = tag;
        }
      }
    }
  }
}
