// Candidate cull of the work-item intersector: for each group of `group`
// rays, the work items whose world box some ray of the group enters, each
// with its key (the nearest entry of the group's rays into it), sorted by
// (key, item), and their count.
//
// Replaces the fused jnp of the JAX package's beam_precull
// (julia_raytracer_tpu/ops/pallas_cluster.py:1786, inside
// make_cluster_intersect_instanced) and the stable sort of its keys: not a
// pallas_call, but on the TPU XLA fuses its ~20 operations x rays x items
// into one pass that keeps the [rays, items] intermediates out of memory.
//
// Semantics (ops/instanced_intersect.py precull; bit for bit when built
// with -fmad=false): rays are padded to whole groups with zeros (tmin =
// tmax = 0), as the JAX package pads them; per (ray, item) the slab test
// of _group_keys in its arithmetic order (1 / d with 1e-30 for a zero
// component, per axis (lo - o) / d and (hi - o) / d, NaN-propagating
// min/max, clipped to [tmin, tmax], entered if enter <= exit * 1.00000024);
// the entry of a ray that enters is max(enter, 0) (+0 for a zero), else
// +inf; the key is the minimum over the group. order[g, :cnt[g]] holds
// the items with a finite key in the order of (key, item), which a stable
// sort of the keys gives, tlow[g, :cnt[g]] their keys; entries past
// cnt[g] are not written.
//
// What bounded the design it replaces (PERF.md section 6): a slab test of
// every (ray, item) pair, 1.3701 ms for 262,144 rays x 4,036 items against
// a 0.4422 ms bound of those operations, and a sort of every key, though
// under 1% of the pairs survive on the sphereflake. This design tests
// fewer pairs. The items come in clusters of kClusterItems (ordered by
// item_clusters in Morton order of their centres), each with the union of
// its items' boxes, and a root box over all. One CTA takes one group:
//   1. it stages the group's rays that may enter the root box, with their
//      inverse directions, in shared memory;
//   2. a warp takes a cluster at a time and votes, 32 rays a step, which
//      staged rays may enter its box (lane k keeps step k's vote);
//   3. for a cluster that some ray may enter, lane j takes item j of the
//      cluster and folds the voting rays' entries into its key, the same
//      arithmetic as the plain keys (a ray that enters an item may enter
//      every box that holds it: the slab arithmetic is monotone in the
//      corners, and may_enter lets a NaN pass);
//   4. each finite key goes with its item into a list in shared memory
//      (kListCap entries; past that into the group's rows of order and
//      tlow), which the CTA sorts by a bitonic network, in shared memory
//      or, for a group past kListCap, in those rows.
// Nothing is read back, and no shape depends on the data. counters (int64,
// zeroed by the caller) sum the (group, item) pairs of step 3, the groups
// that spilled past kListCap, the (ray, cluster) tests of step 2 and the
// (ray, item) tests of step 3. What bounds it: the slab tests of steps 2
// and 3 (ops/instanced_intersect.py cluster_pass_plain counts them,
// utils/kernel_flops.py candidate_cull_cost prices them).

#include <cuda_runtime.h>

#include "cluster_test.cuh"

namespace {

constexpr int kThreads = 256;       // a CTA: 8 warps
constexpr int kClusterItems = 32;   // items a cluster, one a lane
constexpr int kListCap = 2048;      // candidates a group keeps in shared memory
constexpr unsigned kFullMask = 0xffffffffu;

// Whether a ray (origin, tmin; inverse direction, tmax) may enter a box:
// slab_enter_exit with the compare negated, so that a NaN passes.
__device__ __forceinline__ bool may_enter(const float4& o, const float4& i,
                                          const float* box) {
  float enter, exit;
  slab_enter_exit(o.x, o.y, o.z, i.x, i.y, i.z, box, o.w, i.w, enter, exit);
  return !(enter > exit * kSlack);
}

__device__ __forceinline__ void load_box(const float* __restrict__ p,
                                         float* box) {
#pragma unroll
  for (int e = 0; e < 6; ++e) box[e] = __ldg(p + e);
}

// A candidate as one word that orders as (key, item): a finite key is a
// non-negative float, whose bits order as the floats do.
__device__ __forceinline__ unsigned long long pack(float key, int item) {
  return (static_cast<unsigned long long>(__float_as_uint(key)) << 32) |
         static_cast<unsigned>(item);
}

struct SharedList {
  unsigned long long* v;
  __device__ __forceinline__ void order(int a, int b) const {
    const unsigned long long x = v[a], y = v[b];
    if (x > y) {
      v[a] = y;
      v[b] = x;
    }
  }
};

struct RowList {  // a spilled group's rows of tlow and order
  float* key;
  int* item;
  __device__ __forceinline__ void order(int a, int b) const {
    const float ka = key[a], kb = key[b];
    const int ia = item[a], ib = item[b];
    if (ka > kb || (ka == kb && ia > ib)) {
      key[a] = kb;
      key[b] = ka;
      item[a] = ib;
      item[b] = ia;
    }
  }
};

// Sort list[0, n) ascending by the CTA: a bitonic network over the next
// power of two whose every compare puts the smaller value first (a merge
// compares each element of the first half with its mirror in the second,
// then halves), so the virtual +inf elements at n and past never move and
// a compare that reaches one is skipped. Every thread calls it.
template <class List>
__device__ void sort_list(const List& list, int n) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int size = 2; size <= p; size <<= 1) {
    const int half = size >> 1;
    for (int t = threadIdx.x; t < p / 2; t += kThreads) {
      const int base = (t / half) * size, off = t % half;
      const int mirror = base + size - 1 - off;
      if (mirror < n) list.order(base + off, mirror);
    }
    __syncthreads();
    for (int stride = half >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += kThreads) {
        const int a = (t / stride) * 2 * stride + t % stride;
        if (a + stride < n) list.order(a, a + stride);
      }
      __syncthreads();
    }
  }
}

// Group blockIdx.x: rays [g * group, (g + 1) * group), zeros past n.
__global__ void __launch_bounds__(kThreads) candidate_cull_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int n, const float* __restrict__ root,
    const float* __restrict__ cluster_boxes, int n_clusters,
    const float* __restrict__ slot_boxes, const int* __restrict__ slot_item,
    int n_items, int group, int* order, float* tlow, int* __restrict__ cnt,
    unsigned long long* __restrict__ counters) {
  extern __shared__ float4 s_rays[];  // [group] origin, tmin; [group] 1/d, tmax
  __shared__ unsigned long long s_list[kListCap];
  __shared__ int s_nr, s_cnt, s_next;
  __shared__ unsigned long long s_tested, s_item_tests;
  float4* s_o = s_rays;
  float4* s_i = s_rays + group;
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_nr = 0;
    s_cnt = 0;
    s_next = 0;
    s_tested = 0;
    s_item_tests = 0;
  }
  float box[6];
  load_box(root, box);
  __syncthreads();

  // 1. the group's rays that may enter the root box, in any order (a key
  // is a minimum over rays, and which rays vote in step 2 is a set)
  for (int e0 = 0; e0 < group; e0 += kThreads) {
    const int e = e0 + threadIdx.x;
    const long long j = static_cast<long long>(g) * group + e;
    Ray r = {};
    float tmax = 0.0f;
    if (e < group && j < n) {
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
    const float4 o = make_float4(r.ox, r.oy, r.oz, r.tmin);
    const float4 iv = make_float4(r.ix, r.iy, r.iz, tmax);
    const bool keep = e < group && may_enter(o, iv, box);
    const unsigned vote = __ballot_sync(kFullMask, keep);
    int at = 0;
    if (lane == 0 && vote) at = atomicAdd(&s_nr, __popc(vote));
    at = __shfl_sync(kFullMask, at, 0) + __popc(vote & ((1u << lane) - 1u));
    if (keep) {
      s_o[at] = o;
      s_i[at] = iv;
    }
  }
  __syncthreads();
  const int nr = s_nr;
  const int steps = (nr + 31) >> 5;  // at most 32: group <= 1,024
  const float inf = __int_as_float(0x7f800000);
  const size_t row = static_cast<size_t>(g) * n_items;
  unsigned long long tested = 0, item_tests = 0;

  while (nr > 0) {
    int c = 0;
    if (lane == 0) c = atomicAdd(&s_next, 1);
    c = __shfl_sync(kFullMask, c, 0);
    if (c >= n_clusters) break;
    // 2. which staged rays may enter the cluster's box
    load_box(cluster_boxes + 6 * static_cast<size_t>(c), box);
    unsigned mine = 0;  // the vote of step `lane`
    bool any = false;
    for (int k = 0; k < steps; ++k) {
      const int e = (k << 5) + lane;
      const unsigned vote =
          __ballot_sync(kFullMask, e < nr && may_enter(s_o[e], s_i[e], box));
      if (lane == k) mine = vote;
      any |= vote != 0u;
    }
    if (!any) continue;
    // 3. item `lane` of the cluster against the rays that voted
    const int slot = c * kClusterItems + lane;
    const bool has = slot < n_items;
    float ibox[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (has) load_box(slot_boxes + 6 * static_cast<size_t>(slot), ibox);
    float acc = inf;
    int voters = 0;
    for (int k = 0; k < steps; ++k) {
      unsigned vote = __shfl_sync(kFullMask, mine, k);
      voters += __popc(vote);
      while (vote) {
        const int e = (k << 5) + __ffs(vote) - 1;
        vote &= vote - 1u;
        const float4 o = s_o[e];
        const float4 d = s_i[e];
        float enter, exit;
        slab_enter_exit(o.x, o.y, o.z, d.x, d.y, d.z, ibox, o.w, d.w, enter,
                        exit);
        const bool hit = enter <= exit * kSlack;
        acc = fminf(acc, hit ? (enter > 0.0f ? enter : 0.0f) : inf);
      }
    }
    const int real = __popc(__ballot_sync(kFullMask, has));
    tested += real;
    item_tests += static_cast<unsigned long long>(real) * voters;
    // 4. append the finite keys
    const bool cand = has && acc < inf;
    const unsigned cv = __ballot_sync(kFullMask, cand);
    if (cv) {
      int at = 0;
      if (lane == 0) at = atomicAdd(&s_cnt, __popc(cv));
      at = __shfl_sync(kFullMask, at, 0) + __popc(cv & ((1u << lane) - 1u));
      if (cand) {
        const int item = __ldg(slot_item + slot);
        if (at < kListCap) {
          s_list[at] = pack(acc, item);
        } else {
          tlow[row + at] = acc;
          order[row + at] = item;
        }
      }
    }
  }
  if (lane == 0 && tested) {
    atomicAdd(&s_tested, tested);
    atomicAdd(&s_item_tests, item_tests);
  }
  __syncthreads();

  const int count = s_cnt;
  if (count <= kListCap) {
    sort_list(SharedList{s_list}, count);
    for (int k = threadIdx.x; k < count; k += kThreads) {
      const unsigned long long v = s_list[k];
      order[row + k] = static_cast<int>(static_cast<unsigned>(v));
      tlow[row + k] = __uint_as_float(static_cast<unsigned>(v >> 32));
    }
  } else {
    for (int k = threadIdx.x; k < kListCap; k += kThreads) {
      const unsigned long long v = s_list[k];
      order[row + k] = static_cast<int>(static_cast<unsigned>(v));
      tlow[row + k] = __uint_as_float(static_cast<unsigned>(v >> 32));
    }
    __syncthreads();
    sort_list(RowList{tlow + row, order + row}, count);
  }
  if (threadIdx.x == 0) {
    cnt[g] = count;
    if (s_tested) {
      atomicAdd(counters, s_tested);
      atomicAdd(counters + 3, s_item_tests);
    }
    if (count > kListCap) atomicAdd(counters + 1, 1ull);
    if (nr) {
      atomicAdd(counters + 2, static_cast<unsigned long long>(nr) * n_clusters);
    }
  }
}

}  // namespace

extern "C" int candidate_cull_launch(
    const float* ro, const float* rd, const float* tmin, const float* tmax,
    int n, const float* root, const float* cluster_boxes, int n_clusters,
    const float* slot_boxes, const int* slot_item, int n_items, int group,
    int* order, float* tlow, int* cnt, long long* counters,
    cudaStream_t stream) {
  if (n < 0 || n_items < 0 || group < 32 || group > 1024 ||
      (group & (group - 1)) != 0 ||
      n_clusters != (n_items + kClusterItems - 1) / kClusterItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || n_items == 0) return 0;
  const int n_groups = (n + group - 1) / group;
  const size_t smem = 2 * sizeof(float4) * group;  // 32 KB at 1,024 rays
  static bool smem_set = false;  // with the static list, past 48 KB
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        candidate_cull_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(2 * sizeof(float4) * 1024));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  candidate_cull_kernel<<<n_groups, kThreads, smem, stream>>>(
      ro, rd, tmin, tmax, n, root, cluster_boxes, n_clusters, slot_boxes,
      slot_item, n_items, group, order, tlow, cnt,
      reinterpret_cast<unsigned long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}
