// Regroup cluster intersector of heavy scenes (>= 150,000 quads): bounce
// rays are regrouped by supercluster, so that each 1024-slot group is
// tested against the tables of ONE supercluster, and the per-slot hits are
// min-merged back into ray order. Three kernels:
//
//   regroup_pack    replaces julia_raytracer_tpu/ops/pallas_regroup.py
//                   _make_pack_kernel (pallas_call at :666);
//   regroup_tritest replaces _make_tritest_kernel (pallas_call at :739);
//   regroup_unpack  replaces _make_unpack_kernel (pallas_call at :701).
//
// The count stage before them and the merge after them are plain PyTorch
// (ops/regroup_intersect.py, XLA code in the JAX package). They give:
//   - bits [T, S, 1024] u8: ray (tile t, lane l) enters supercluster s;
//   - cnt_ts [T, S] i32: the set bits of each (tile, super) pair;
//   - base_ts [T, S] i32: the slot of the pair's first ray, = seg_base[s] +
//     the set bits of (t' < t, s): segments are super-major, and inside a
//     segment rays keep (tile, lane) order;
//   - seg_base / cnt_s [S] i32: each super's segment, padded to whole
//     1024-slot groups; grp_super [G] i32: the super of each group.
//
// The TPU kernels rank lanes with one-hot matmuls on the MXU, move the
// payload as 4 x 8-bit planes through bf16 dots, DMA 9-block windows into
// slack-separated segments and carry residual blocks from step to step:
// all of that exists because the TPU has no scatter, no warp vote and a
// sequential grid. Here the rank of a lane among the set lanes of its tile
// is a warp ballot + popc plus an exclusive scan of the 32 warp counts (as
// in lane_compact.cu), each (tile, super) pair writes its rays straight to
// their slots, and segments need no slack.
//
// Semantics (each kernel identical to its plain PyTorch version in
// ops/regroup_intersect.py, bit for bit when built with -fmad=false):
//   pack:    packed[base_ts[t, s] + rank] = the lane's 8 floats (ox oy oz dx
//            dy dz tmin tmax); the padding slots of each segment get zeros
//            and tmax = -1, so no cull passes them;
//   tritest: per slot, the super's clusters in index order, each culled
//            with the slot's own tmax (not its running best, as the TPU
//            kernel culls, pallas_regroup.py:452-461), the 128 triangles of
//            a cluster it wants in index order with a strict `<` against
//            its running best (cluster_test.cuh); out (tri, t bits), tri =
//            -1 and t = tmax on a miss (:544-553);
//   unpack:  per ray, supers in index order, (tri, t) of its slot merged
//            where t > 0 and t < best (strict, :368-372); best starts at
//            +inf and tri at -1; out (tri, t bits).
//
// What bounds them on an H100: pack and unpack move bytes (the bits once,
// 32 B in and out per set bit for pack, 8 B per set bit for unpack), the
// tri-test does operations (128 triangle tests of 40 fp32 operations per
// (slot, cluster) pair that passes the cull). The tri-test keeps one
// super's 128 boxes (4 KB) and one cluster's table (8 KB) in shared memory,
// loads a cluster only when a slot of the group wants it
// (__syncthreads_or), and every thread reads the same triangle at once
// (shared-memory broadcast), as worklist_intersect.cu does. TMA, warp
// specialisation and persistent CTAs are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_test.cuh"

namespace {

constexpr int kTile = 1024;  // rays per tile = slots per group = threads
constexpr int kWarps = kTile / 32;
constexpr int kMaxSup = 128;  // clusters per supercluster (upper limit)
constexpr unsigned kFull = 0xffffffffu;

// Exclusive rank of `flag` among the CTA's 1024 threads, in thread order.
// Every thread of the CTA must call it.
__device__ __forceinline__ int block_rank(bool flag, int* warp_off) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, flag);
  if (lane == 0) warp_off[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    // exclusive scan of the 32 warp counts
    const int c = warp_off[lane];
    int inc = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    warp_off[lane] = inc - c;
  }
  __syncthreads();
  const int rank = warp_off[warp] + __popc(ballot & ((1u << lane) - 1u));
  __syncthreads();  // warp_off is rewritten by the next call
  return rank;
}

// grid (tiles, supers): one CTA per (tile, super) pair, one thread per lane.
__global__ void __launch_bounds__(kTile) pack_kernel(
    const uint8_t* __restrict__ bits, const float* __restrict__ rays,
    const int* __restrict__ cnt_ts, const int* __restrict__ base_ts,
    const int* __restrict__ seg_base, const int* __restrict__ cnt_s,
    int n_super, float* __restrict__ packed) {
  __shared__ int warp_off[kWarps];
  const int t = blockIdx.x, s = blockIdx.y;
  const int pair = t * n_super + s;
  if (cnt_ts[pair] > 0) {  // the same for the whole CTA
    const bool set = bits[static_cast<size_t>(pair) * kTile + threadIdx.x] != 0;
    const int rank = block_rank(set, warp_off);
    if (set) {
      const float4* src = reinterpret_cast<const float4*>(
          rays + (static_cast<size_t>(t) * kTile + threadIdx.x) * 8);
      float4* dst = reinterpret_cast<float4*>(
          packed + static_cast<size_t>(base_ts[pair] + rank) * 8);
      dst[0] = src[0];
      dst[1] = src[1];
    }
  }
  if (t == static_cast<int>(gridDim.x) - 1) {
    // the last tile's CTA fills the segment's padding (< 1024 slots)
    const int count = cnt_s[s];
    const int end = seg_base[s] + (count + kTile - 1) / kTile * kTile;
    const int slot = seg_base[s] + count + threadIdx.x;
    if (slot < end) {
      float4* dst = reinterpret_cast<float4*>(
          packed + static_cast<size_t>(slot) * 8);
      dst[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dst[1] = make_float4(0.0f, 0.0f, 0.0f, -1.0f);
    }
  }
}

// grid (groups): one CTA per 1024 packed slots of one super, one thread per
// slot.
__global__ void __launch_bounds__(kTile) tritest_kernel(
    const float* __restrict__ packed, const float* __restrict__ tab,
    const float* __restrict__ bbox, const int* __restrict__ grp_super,
    int sup, int q, int* __restrict__ out) {
  __shared__ __align__(16) float tile[kRows * kTris];  // one cluster, 8 KB
  __shared__ float boxes[kMaxSup * 8];                  // one supercluster

  const int s = grp_super[blockIdx.x];
  const size_t slot = static_cast<size_t>(blockIdx.x) * kTile + threadIdx.x;
  for (int e = threadIdx.x; e < sup * 8; e += kTile) {
    boxes[e] = bbox[static_cast<size_t>(s) * sup * 8 + e];
  }
  const float4* p = reinterpret_cast<const float4*>(packed + slot * 8);
  const float4 a = p[0], b = p[1];
  Ray r;
  r.ox = a.x;
  r.oy = a.y;
  r.oz = a.z;
  r.dx = a.w;
  r.dy = b.x;
  r.dz = b.y;
  r.tmin = b.z;
  set_inverse_dir(r);
  const float tmax = b.w;
  float best = tmax;
  int best_tri = -1;
  __syncthreads();  // boxes

  for (int ci = 0; ci < sup; ++ci) {
    const bool want = cluster_cull(r, tmax, boxes + ci * 8);
    if (!__syncthreads_or(want)) continue;  // also fences the old tile
    const int cl = s * sup + ci;
    const float4* src = reinterpret_cast<const float4*>(
        tab + static_cast<size_t>(cl) * kRows * kTris);
    float4* dst = reinterpret_cast<float4*>(tile);
    for (int e = threadIdx.x; e < kRows * kTris / 4; e += kTile) {
      dst[e] = src[e];
    }
    __syncthreads();
    if (want) {
      int arg = -1;
      for (int j = 0; j < kTris; ++j) {
        float t, u, v;
        if (tri_test(r, tile, j, best, t, u, v)) {
          best = t;
          arg = j;
        }
      }
      if (arg >= 0) best_tri = cl * kTris + arg;
    }
  }
  const bool valid = best_tri >= 0 && best_tri < 2 * q;
  out[2 * slot] = valid ? best_tri : -1;
  out[2 * slot + 1] = __float_as_int(valid ? best : tmax);
}

// grid (tiles): one CTA per 1024-ray tile, one thread per ray.
__global__ void __launch_bounds__(kTile) unpack_kernel(
    const uint8_t* __restrict__ bits, const int* __restrict__ cnt_ts,
    const int* __restrict__ base_ts, const int* __restrict__ trires,
    int n_super, int* __restrict__ out) {
  __shared__ int warp_off[kWarps];
  const int t = blockIdx.x;
  float best = __int_as_float(0x7f800000);  // +inf
  int best_tri = -1;
  for (int s = 0; s < n_super; ++s) {
    const int pair = t * n_super + s;
    if (cnt_ts[pair] == 0) continue;  // the same for the whole CTA
    const bool set = bits[static_cast<size_t>(pair) * kTile + threadIdx.x] != 0;
    const int rank = block_rank(set, warp_off);
    if (set) {
      const int2 res = reinterpret_cast<const int2*>(trires)[base_ts[pair] + rank];
      const float tt = __int_as_float(res.y);
      if (tt > 0.0f && tt < best) {
        best = tt;
        best_tri = res.x;
      }
    }
  }
  const size_t i = static_cast<size_t>(t) * kTile + threadIdx.x;
  out[2 * i] = best_tri;
  out[2 * i + 1] = __float_as_int(best);
}

}  // namespace

// bits [tiles, n_super, 1024] u8, rays [tiles * 1024, 8] f32, cnt_ts /
// base_ts [tiles, n_super] i32, seg_base / cnt_s [n_super] i32 -> packed
// [slots, 8] f32 (every slot written).
extern "C" int regroup_pack_launch(const uint8_t* bits, const float* rays,
                                   const int* cnt_ts, const int* base_ts,
                                   const int* seg_base, const int* cnt_s,
                                   int tiles, int n_super, float* packed,
                                   cudaStream_t stream) {
  if (tiles < 0 || n_super < 1 || n_super > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return 0;
  pack_kernel<<<dim3(tiles, n_super), kTile, 0, stream>>>(
      bits, rays, cnt_ts, base_ts, seg_base, cnt_s, n_super, packed);
  return static_cast<int>(cudaGetLastError());
}

// packed [groups * 1024, 8] f32, tab [S * sup, 16, 128] f32, bbox [S * sup,
// 8] f32, grp_super [groups] i32 -> out [groups * 1024, 2] i32.
extern "C" int regroup_tritest_launch(const float* packed, const float* tab,
                                      const float* bbox, const int* grp_super,
                                      int groups, int sup, int q, int* out,
                                      cudaStream_t stream) {
  if (groups < 0 || sup < 1 || sup > kMaxSup || q < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (groups == 0) return 0;
  tritest_kernel<<<groups, kTile, 0, stream>>>(packed, tab, bbox, grp_super,
                                               sup, q, out);
  return static_cast<int>(cudaGetLastError());
}

// bits / cnt_ts / base_ts as for pack, trires [slots, 2] i32 -> out
// [tiles * 1024, 2] i32.
extern "C" int regroup_unpack_launch(const uint8_t* bits, const int* cnt_ts,
                                     const int* base_ts, const int* trires,
                                     int tiles, int n_super, int* out,
                                     cudaStream_t stream) {
  if (tiles < 0 || n_super < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return 0;
  unpack_kernel<<<tiles, kTile, 0, stream>>>(bits, cnt_ts, base_ts, trires,
                                             n_super, out);
  return static_cast<int>(cudaGetLastError());
}
