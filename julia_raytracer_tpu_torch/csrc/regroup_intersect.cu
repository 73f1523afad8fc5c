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
// sequential grid. Here pack and unpack walk each (tile, super) pair per
// warp (pair_walk, below): the warp reads the pair's bits as 32 words, a
// lane ranks its set bit by the popcounts of the words before it (a
// shuffle scan) and of its own word's lower bits, each pair writes its
// rays straight to their slots, and segments need no slack.
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
//            its running best (the first minimum, as warp_closest finds
//            it); out (tri, t bits), tri = -1 and t = tmax on a miss or on
//            a triangle >= 2q (:544-553);
//   unpack:  per ray, supers in index order, (tri, t) of its slot merged
//            where t > 0 and t < best (strict, :368-372); best starts at
//            +inf and tri at -1; out (tri, t bits).
//
// What bounds them on an H100: pack and unpack move bytes (the bits of
// the live pairs once, 32 B in and out per set bit for pack, 8 B per set
// bit for unpack), the tri-test does operations (128 triangle tests of 40
// fp32 operations per (slot, cluster) pair that passes the cull).
//
// Pack runs one warp a (tile, super) pair, 4 pairs to a 128-thread CTA: a
// pair with no set bit (57% of them on the heavy scene's bounce rays) costs
// its warp one load of its count, and a live pair's warp takes its words
// that have a set bit, 4 at a time, reading their rays in coalesced 1 KB
// spans and writing consecutive slots. Unpack runs two 512-thread CTAs a
// tile, each holding the 64-bit keys of half its rays in shared memory:
// each CTA lists the tile's live pairs, and its warps take them from the
// list one at a time (a shared-memory counter) and walk the words of each
// that hold its rays, each set lane folding its slot's (t, slot) into its
// ray's key by atomicMin. The split and the list are for the tiles whose
// rays enter many superclusters: on the heavy scene's bounce rays a tile
// holds 745.7 non-empty words on average but up to 3,081, and the kernel
// takes as long as its heaviest CTAs. The old designs ranked a pair's
// lanes with three block-wide barriers: pack as one 1024-thread CTA a pair
// (48,128 CTAs, most of them empty), unpack walking a tile's 188 supers in
// series, each live pair a chain of dependent loads. On the heavy scene's
// bounce rays they took 0.1632 and 0.1698 ms, these 0.0447 and 0.0431 ms,
// in turns on one card, against 0.0218 and 0.0100 ms byte bounds (PERF.md
// section 6, NVIDIA H100 80GB HBM3, 700 W): pack moves its bytes at half
// the card's rate, and unpack's time follows its heaviest tiles' walks.
//
// The tri-test walks per warp (warp_walk.cuh's warp_super_step, with its
// running-best re-cull turned off): the 32 slots of a warp lie in one group,
// so in one supercluster, and take one step. Each slot culls the super's
// clusters against its tmax into a mask, the warp ORs the masks once (the
// mask vote), and each set cluster's table goes from device memory into
// registers (4 triangles a lane, coalesced read-only loads) for the slots
// that want it, each tested on all 32 lanes with a (t, index) shuffle-min
// that finds the serial strict `<`'s first minimum. A warp none of whose
// slots can enter a box (tmin > tmax * slack: the padding slots, at tmax =
// -1) writes its misses and leaves. There is no shared memory and no
// block-wide barrier, so several 128-thread CTAs share an SM. The old
// design (one 1024-thread CTA a group, a block-wide __syncthreads_or and
// an 8 KB shared-memory load per cluster any slot wanted, each wanting slot
// running its 128 tests alone on one lane) took 10.83 ms on the heavy
// scene's bounce rays against a 0.1400 ms bound; this design takes 1.156
// ms, in turns with it on one card (PERF.md section 6, NVIDIA H100 80GB
// HBM3, 700 W). There 38,830 of 42,144 warps vote, each slot culls the
// super's 128 boxes, and 489,740 (warp, cluster) table loads (6 KB each,
// 3.74 slots a load) feed 1,832,175 (slot, cluster) passes at 88% of the
// lane slots on real triangles: the culls and the table loads, not the
// tests, set its time.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "warp_walk.cuh"

namespace {

constexpr int kTile = 1024;  // rays per tile = slots per group
constexpr int kMaxSup = kMaskWords * kWarp;  // clusters per supercluster

// The pair walk, which pack and unpack share: one warp reads a (tile,
// super) pair's 1,024 bit bytes in one coalesced pass, 32 B a lane, so
// that lane c holds word c (lanes 32c .. 32c+31 of the tile) as a 32-bit
// mask. Popcounts and a shuffle scan give each word's offset, the set
// lanes of the words before it. Then the warp takes the words with a set
// bit among `walk_words` in index order, kBatch at a time, and lane j of
// word c, if its bit is set, has ray = 32c + j (its lane in the tile) and
// rank = off_c +
// popc(mask_c & ((1 << j) - 1)) (its rank among the pair's set lanes, as
// _ranks and its mirror pair_ranks_by_words in ops/regroup_intersect.py
// give it). For a batch, every set lane first calls gather(ray, rank),
// then apply(ray, rank, gathered): the batch's loads are in flight
// together, not one device-memory latency a word. No shared memory, no
// barrier.

// 1 in bit k for each nonzero byte k of x
__device__ __forceinline__ unsigned byte_flags(unsigned x) {
  const unsigned hi = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return ((hi >> 7) * 0x01020408u) >> 24;  // no carry: each byte <= 15
}

template <int kBatch, class Gather, class Apply>
__device__ __forceinline__ void pair_walk(const uint8_t* __restrict__ bits,
                                          int lane, unsigned walk_words,
                                          Gather&& gather, Apply&& apply) {
  const uint4* p = reinterpret_cast<const uint4*>(bits) + 2 * lane;
  const uint4 a = __ldg(p), b = __ldg(p + 1);
  const unsigned mask =
      byte_flags(a.x) | byte_flags(a.y) << 4 | byte_flags(a.z) << 8 |
      byte_flags(a.w) << 12 | byte_flags(b.x) << 16 | byte_flags(b.y) << 20 |
      byte_flags(b.z) << 24 | byte_flags(b.w) << 28;
  const int count = __popc(mask);
  int inc = count;  // inclusive scan of the 32 words' counts
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, inc, o);
    if (lane >= o) inc += y;
  }
  const int off = inc - count;
  unsigned words = __ballot_sync(kFullMask, mask != 0) & walk_words;
  while (words) {  // the same for the whole warp
    int ray[kBatch], rank[kBatch];  // rank -1: the lane's bit is clear
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      rank[k] = -1;
      ray[k] = 0;
      if (words) {
        const int c = __ffs(words) - 1;
        words &= words - 1;
        const unsigned m = __shfl_sync(kFullMask, mask, c);
        const int o = __shfl_sync(kFullMask, off, c);
        ray[k] = c * kWarp + lane;
        if (m >> lane & 1u) rank[k] = o + __popc(m & ((1u << lane) - 1u));
      }
    }
    decltype(gather(0, 0)) v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (rank[k] >= 0) v[k] = gather(ray[k], rank[k]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (rank[k] >= 0) apply(ray[k], rank[k], v[k]);
    }
  }
}

constexpr int kPackThreads = 128;  // 4 independent warps, one pair each
constexpr int kPairsPerCta = kPackThreads / kWarp;
constexpr int kWalkBatch = 4;  // words whose gathers are in flight together

struct RayPayload {
  float4 lo, hi;  // ox oy oz dx, dy dz tmin tmax
};

// grid (ceil(tiles * supers / 4)): one warp per (tile, super) pair, pairs
// tile-major. A warp whose pair has no set bit reads its count and leaves;
// the warp of pair (last tile, s) also writes super s's padding slots.
__global__ void __launch_bounds__(kPackThreads) pack_kernel(
    const uint8_t* __restrict__ bits, const float* __restrict__ rays,
    const int* __restrict__ cnt_ts, const int* __restrict__ base_ts,
    const int* __restrict__ seg_base, const int* __restrict__ cnt_s,
    int tiles, int n_super, float* __restrict__ packed) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int pair = blockIdx.x * kPairsPerCta + (threadIdx.x >> 5);
  if (pair >= tiles * n_super) return;  // the same for the whole warp
  const int t = pair / n_super, s = pair - t * n_super;
  if (__ldg(cnt_ts + pair) > 0) {
    const float4* src =
        reinterpret_cast<const float4*>(rays) + static_cast<size_t>(t) * kTile * 2;
    float4* dst = reinterpret_cast<float4*>(packed) +
                  static_cast<size_t>(__ldg(base_ts + pair)) * 2;
    // consecutive set lanes of a word fill consecutive slots
    pair_walk<kWalkBatch>(
        bits + static_cast<size_t>(pair) * kTile, lane, kFullMask,
        [&](int ray, int) {
          return RayPayload{__ldg(src + 2 * ray), __ldg(src + 2 * ray + 1)};
        },
        [&](int, int rank, const RayPayload& r) {
          dst[2 * rank] = r.lo;
          dst[2 * rank + 1] = r.hi;
        });
  }
  if (t == tiles - 1) {
    // the segment's padding (< 1024 slots): zeros, tmax = -1
    const int count = __ldg(cnt_s + s), first = __ldg(seg_base + s);
    const int end = first + (count + kTile - 1) / kTile * kTile;
    float4* dst = reinterpret_cast<float4*>(packed);
    for (int slot = first + count + lane; slot < end; slot += kWarp) {
      dst[2 * static_cast<size_t>(slot)] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dst[2 * static_cast<size_t>(slot) + 1] =
          make_float4(0.0f, 0.0f, 0.0f, -1.0f);
    }
  }
}

constexpr int kTriThreads = 128;  // 4 independent warps per CTA
constexpr int kCtasPerGroup = kTile / kTriThreads;

// grid (groups * 8): 128 threads per CTA, one thread per packed slot; the
// 8 CTAs of a group share its supercluster.
__global__ void __launch_bounds__(kTriThreads) tritest_kernel(
    const float* __restrict__ packed, const float* __restrict__ tab,
    const float* __restrict__ bbox, const int* __restrict__ grp_super,
    int sup, int q, int* __restrict__ out) {
  const int s = __ldg(grp_super + blockIdx.x / kCtasPerGroup);
  const size_t slot =
      static_cast<size_t>(blockIdx.x) * kTriThreads + threadIdx.x;
  const float4* p = reinterpret_cast<const float4*>(packed + slot * 8);
  const float4 a = __ldg(p), c = __ldg(p + 1);
  Ray r;
  r.ox = a.x;
  r.oy = a.y;
  r.oz = a.z;
  r.dx = a.w;
  r.dy = c.x;
  r.dz = c.y;
  r.tmin = c.z;
  set_inverse_dir(r);
  const float tmax = c.w;
  // a box test passes only if tmin <= enter <= exit * slack <= tmax * slack,
  // so a slot that fails this enters no cluster (and NaN fails it)
  const bool enter = r.tmin <= tmax * kSlack;
  Best b = {tmax, 0.0f, 0.0f, -1, 0, 0};
  if (__any_sync(kFullMask, enter)) {
    warp_super_step<false>(r, tmax, enter, b,
                           bbox + static_cast<size_t>(s) * sup * 8,
                           tab + static_cast<size_t>(s) * sup * kRows * kTris,
                           sup, s * sup, 0);
  }
  const int best_tri = b.cluster >= 0 ? b.cluster * kTris + b.arg : -1;
  const bool valid = best_tri >= 0 && best_tri < 2 * q;
  reinterpret_cast<int2*>(out)[slot] =
      make_int2(valid ? best_tri : -1, __float_as_int(valid ? b.t : tmax));
}

// An untouched key: above every (t bits << 32 | slot) of a finite t.
constexpr unsigned long long kNoKey = ~0ull;
constexpr int kUnpackSplit = 2;  // CTAs a tile, each 1024 / kUnpackSplit rays
constexpr int kUnpackThreads = kTile / kUnpackSplit;
constexpr int kUnpackWords = kWarp / kUnpackSplit;  // of a pair's 32

// grid (tiles * kUnpackSplit): CTA (t, h) holds the keys of rays
// kUnpackThreads h .. of tile t, one thread a ray, and walks only the
// words of each pair that hold them. Per pass of kUnpackThreads supers,
// each thread lists its super if the tile's pair with it is live, then
// each warp takes the next listed pair (a
// shared-memory counter, so that warps whose pairs hold few words take
// more of them) and walks it, each set lane folding (t bits << 32 | slot)
// into its ray's key by a shared-memory atomicMin where 0 < t < +inf (NaN
// fails, as it fails the serial test). Positive finite floats order as
// their bits, and a ray's slots rise with the super (segments are
// super-major), so the least key is the serial walk's first minimum over
// the supers in index order with a strict `<`, whatever the order of the
// atomics.
__global__ void __launch_bounds__(kUnpackThreads) unpack_kernel(
    const uint8_t* __restrict__ bits, const int* __restrict__ cnt_ts,
    const int* __restrict__ base_ts, const int* __restrict__ trires,
    int n_super, int* __restrict__ out) {
  __shared__ unsigned long long key[kUnpackThreads];
  __shared__ int2 live[kUnpackThreads];  // (super, slot of its first ray)
  __shared__ int n_live, next;
  const int t = blockIdx.x / kUnpackSplit, h = blockIdx.x % kUnpackSplit;
  const int lane = threadIdx.x & (kWarp - 1);
  const unsigned walk_words = static_cast<unsigned>(
      ((1ull << kUnpackWords) - 1) << (h * kUnpackWords));
  const int ray0 = h * kUnpackThreads;
  const int2* res = reinterpret_cast<const int2*>(trires);
  key[threadIdx.x] = kNoKey;
  for (int s0 = 0; s0 < n_super; s0 += kUnpackThreads) {
    if (threadIdx.x == 0) n_live = next = 0;
    __syncthreads();  // the counters reset (and the keys set)
    const int s = s0 + threadIdx.x;
    const size_t pair = static_cast<size_t>(t) * n_super + s;
    const bool on = s < n_super && __ldg(cnt_ts + pair) > 0;
    const unsigned vote = __ballot_sync(kFullMask, on);
    int at = 0;
    if (lane == 0 && vote) at = atomicAdd(&n_live, __popc(vote));
    at = __shfl_sync(kFullMask, at, 0) + __popc(vote & ((1u << lane) - 1u));
    if (on) live[at] = make_int2(s, __ldg(base_ts + pair));
    __syncthreads();  // the list complete
    for (;;) {
      int i = 0;
      if (lane == 0) i = atomicAdd(&next, 1);
      i = __shfl_sync(kFullMask, i, 0);
      if (i >= n_live) break;
      const int2 e = live[i];
      const int first = e.y;
      pair_walk<kWalkBatch>(
          bits + (static_cast<size_t>(t) * n_super + e.x) * kTile, lane,
          walk_words,
          [&](int, int rank) { return __ldg(&res[first + rank].y); },
          [&](int ray, int rank, int t_bits) {
            const float tt = __int_as_float(t_bits);
            if (tt > 0.0f && tt < __int_as_float(0x7f800000)) {
              atomicMin(&key[ray - ray0],
                        static_cast<unsigned long long>(
                            static_cast<unsigned>(t_bits)) << 32 |
                            static_cast<unsigned>(first + rank));
            }
          });
    }
    __syncthreads();  // every walk done before the list is rewritten or read
  }
  const unsigned long long k = key[threadIdx.x];
  const size_t i = static_cast<size_t>(t) * kTile + ray0 + threadIdx.x;
  reinterpret_cast<int2*>(out)[i] =
      k == kNoKey ? make_int2(-1, 0x7f800000)  // (-1, +inf)
                  : make_int2(__ldg(&res[static_cast<unsigned>(k)].x),
                              static_cast<int>(k >> 32));
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
  if (tiles < 0 || n_super < 1 || tiles > INT_MAX / n_super) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return 0;
  const int pairs = tiles * n_super;
  pack_kernel<<<(pairs + kPairsPerCta - 1) / kPairsPerCta, kPackThreads, 0,
                stream>>>(bits, rays, cnt_ts, base_ts, seg_base, cnt_s,
                          tiles, n_super, packed);
  return static_cast<int>(cudaGetLastError());
}

// packed [groups * 1024, 8] f32, tab [S * sup, 16, 128] f32, bbox [S * sup,
// 8] f32, grp_super [groups] i32 -> out [groups * 1024, 2] i32.
extern "C" int regroup_tritest_launch(const float* packed, const float* tab,
                                      const float* bbox, const int* grp_super,
                                      int groups, int sup, int q, int* out,
                                      cudaStream_t stream) {
  if (groups < 0 || groups > INT_MAX / kCtasPerGroup || sup < 1 || sup > kMaxSup ||
      q < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (groups == 0) return 0;
  tritest_kernel<<<groups * kCtasPerGroup, kTriThreads, 0, stream>>>(
      packed, tab, bbox, grp_super, sup, q, out);
  return static_cast<int>(cudaGetLastError());
}

// bits / cnt_ts / base_ts as for pack, trires [slots, 2] i32 -> out
// [tiles * 1024, 2] i32.
extern "C" int regroup_unpack_launch(const uint8_t* bits, const int* cnt_ts,
                                     const int* base_ts, const int* trires,
                                     int tiles, int n_super, int* out,
                                     cudaStream_t stream) {
  if (tiles < 0 || n_super < 1 || tiles > INT_MAX / kUnpackSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return 0;
  unpack_kernel<<<tiles * kUnpackSplit, kUnpackThreads, 0, stream>>>(
      bits, cnt_ts, base_ts, trires, n_super, out);
  return static_cast<int>(cudaGetLastError());
}
