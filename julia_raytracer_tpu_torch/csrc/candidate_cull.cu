// Candidate cull of the work-item intersector: for each group of `group`
// rays and each work item, the nearest entry of any of the group's rays
// into the item's world box (+inf when none enters it).
//
// Replaces the fused jnp of the JAX package's beam_precull
// (julia_raytracer_tpu/ops/pallas_cluster.py:1786, inside
// make_cluster_intersect_instanced): not a pallas_call, but on the TPU XLA
// fuses its ~20 operations x rays x items into one pass that keeps the
// [rays, items] intermediates out of memory. Eager PyTorch cannot: the
// plain version (ops/instanced_intersect.py _group_keys) writes [rays,
// items] float tensors through device memory several times, 101.53 ms for
// one call on the instanced scene's bounce rays (PERF.md, H100 80GB HBM3,
// 700 W).
//
// Semantics (identical to _group_keys, bit for bit when built with
// -fmad=false): rays are padded to whole groups with zeros (tmin = tmax =
// 0), as the JAX package pads them; per (ray, item) the slab test of
// _group_keys in its arithmetic order (1 / d with 1e-30 for a zero
// component, per axis (lo - o) / d and (hi - o) / d, NaN-propagating
// min/max, clipped to [tmin, tmax], entered if enter <= exit * 1.00000024);
// the entry of a ray that enters is max(enter, 0) (+0 for a zero), else
// +inf; the key is the minimum over the group. keys [ng, items] f32.
//
// What bounds it on an H100: the operations, rays x items x 28 fp32
// operations (6 subtracts, 6 multiplies, 6 min/max, 4 for the entry and
// exit, 2 clips, the slack, the compare, the clamp and the group min) at
// 67 TFLOP/s, against the rays, the boxes and the keys (4 B per group and
// item) at 3.35 TB/s. The design: a CTA takes 128 items, one per thread,
// with the item's box in registers, and a tile of 256 rays staged in
// shared memory with their inverse directions (read as broadcasts); each
// thread folds the tile's rays into its running group minimum and writes a
// key at each group's end, coalesced across the CTA's items. Nothing of
// size [rays, items] goes to device memory. The slab test is the shared
// slab_enter_exit of cluster_test.cuh. Measured on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md section 6): 1.393 ms for 262,144 rays x 4,036
// items in groups of 256, 3.1x its 0.442 ms bound (operations); the
// precull with the keys' stable sort (torch.argsort) takes 1.668 ms.

#include <cuda_runtime.h>

#include "cluster_test.cuh"

namespace {

constexpr int kThreads = 128;  // items per CTA, one per thread
constexpr int kTile = 256;     // rays staged in shared memory at a time

// Rays [r0, r0 + tiles * kTile) (zeros past n) against item blockIdx.x *
// kThreads + threadIdx.x; the CTA covers whole groups (kTile % group == 0,
// or group % kTile == 0 and tiles = group / kTile).
__global__ void __launch_bounds__(kThreads) candidate_cull_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int n, const float* __restrict__ boxes, int box_stride, int n_items,
    int group, int n_groups, int tiles, float* __restrict__ keys) {
  __shared__ float4 s_o[kTile];  // origin, tmin
  __shared__ float4 s_i[kTile];  // inverse direction, tmax
  const int item = blockIdx.x * kThreads + threadIdx.x;
  const bool has_item = item < n_items;
  float box[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (has_item) {
    const float* bx = boxes + static_cast<size_t>(item) * box_stride;
#pragma unroll
    for (int e = 0; e < 6; ++e) box[e] = __ldg(bx + e);
  }
  const float inf = __int_as_float(0x7f800000);
  float acc = inf;
  const long long r0 = static_cast<long long>(blockIdx.y) * tiles * kTile;
  for (int tile = 0; tile < tiles; ++tile) {
    const long long base = r0 + static_cast<long long>(tile) * kTile;
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      const long long j = base + e;
      Ray r = {};
      float tmax = 0.0f;
      if (j < n) {
        r.ox = ro[3 * j];
        r.oy = ro[3 * j + 1];
        r.oz = ro[3 * j + 2];
        r.dx = rd[3 * j];
        r.dy = rd[3 * j + 1];
        r.dz = rd[3 * j + 2];
        r.tmin = tmin_in[j];
        tmax = tmax_in[j];
      }
      set_inverse_dir(r);
      s_o[e] = make_float4(r.ox, r.oy, r.oz, r.tmin);
      s_i[e] = make_float4(r.ix, r.iy, r.iz, tmax);
    }
    __syncthreads();
    if (!has_item) continue;
    // the tile holds whole groups (group <= kTile), or one group ends with
    // the CTA's last tile
    const int span = group < kTile ? group : kTile;
    for (int s0 = 0; s0 < kTile; s0 += span) {
      for (int e = s0; e < s0 + span; ++e) {
        const float4 o = s_o[e];
        const float4 d = s_i[e];
        float enter, exit;
        slab_enter_exit(o.x, o.y, o.z, d.x, d.y, d.z, box, o.w, d.w, enter,
                        exit);
        const bool hit = enter <= exit * kSlack;
        acc = fminf(acc, hit ? (enter > 0.0f ? enter : 0.0f) : inf);
      }
      if (group <= kTile || tile == tiles - 1) {
        const long long g = (base + s0) / group;
        if (g < n_groups) keys[g * n_items + item] = acc;
        acc = inf;
      }
    }
  }
}

}  // namespace

extern "C" int candidate_cull_launch(const float* ro, const float* rd,
                                     const float* tmin, const float* tmax,
                                     int n, const float* boxes,
                                     int box_stride, int n_items, int group,
                                     float* keys, cudaStream_t stream) {
  if (n < 0 || n_items < 0 || box_stride < 6 || group < 1 ||
      (kTile % group != 0 && group % kTile != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || n_items == 0) return 0;
  const int n_groups = (n + group - 1) / group;
  const int tiles = group > kTile ? group / kTile : 1;
  const long long rays = static_cast<long long>(n_groups) * group;
  const long long per_cta = static_cast<long long>(tiles) * kTile;
  const dim3 grid((n_items + kThreads - 1) / kThreads,
                  static_cast<unsigned>((rays + per_cta - 1) / per_cta));
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  candidate_cull_kernel<<<grid, kThreads, 0, stream>>>(
      ro, rd, tmin, tmax, n, boxes, box_stride, n_items, group, n_groups,
      tiles, keys);
  return static_cast<int>(cudaGetLastError());
}
