// Lane compactor of the unsorted two-phase wavefront dispatch: stable
// pack of the alive lanes of every state plane to a [cap] prefix
// (compact), and the scatter of the narrow loop's outputs back to their
// source lanes (expand).
//
// Replaces the Pallas TPU kernels of julia_raytracer_tpu/ops/pallas_compact.py:
// _make_compact_kernel (compact_state) and _make_expand_kernel
// (expand_outputs). The TPU versions rank lanes with strict-lower MXU
// matmuls, move byte-chunk planes through one-hot dots and keep a running
// cursor in SMEM across a sequential grid; those are workarounds for a
// machine without warp votes or parallel blocks and do not carry over.
// What does carry over is the contract: the state rides as int32 planes
// [P, n] (f32 and bool leaves bitcast or 0/1), so every bit pattern (NaN
// payloads, denormals, full-range u32 rng) survives; ranks are stable in
// lane order; slots of the packed buffer past the survivor count are left
// unwritten.
//
// Design: one block of 1024 threads per 1024-lane tile, one lane per
// thread. The count kernel writes each tile's alive count (warp ballot +
// popc, then a sum over the 32 warps). The compact and expand kernels
// each sum the counts of the preceding tiles themselves (n/1024 ints, a
// block reduction), then rank the lane inside its tile by ballot, popc
// and an exclusive scan over the warp counts, and move all P planes of
// the lane: compact writes out[p, base + rank] = vals[p, i] for alive
// lanes; expand writes out[p, i] = alive ? narrow[p, base + rank] :
// fallback[p, i] (the merge of pallas_compact.py:395-398, fused).
//
// What bounds it on an H100: bytes. Compact reads P x n x 4 B and writes
// P x survivors x 4 B (main path: 45 planes x 262,144 lanes = 47 MB read,
// <= 12 MB written at cap 65,536); expand reads and writes P x n x 4 B of
// the 11 output planes. At 3.35 TB/s that is ~10-20 us; reads are
// coalesced along lanes (planes are rows of [P, n]), writes are coalesced
// runs because ranks are monotone in lane order. The O(tiles^2) prefix
// re-summation is 256 x 256 int reads at the main path, negligible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;
constexpr int kWarps = kTile / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// Block-wide sum of one int per thread (1024 threads); result to all.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  if (warp == 0) {
    total = warp_sum(scratch[lane]);
    if (lane == 0) scratch[0] = total;
  }
  __syncthreads();
  total = scratch[0];
  __syncthreads();
  return total;
}

// Tile base (alive lanes of tiles before this one) and this lane's stable
// rank among the tile's alive lanes.
__device__ __forceinline__ void tile_rank(const int* __restrict__ counts,
                                          bool alive, int* base_out,
                                          int* rank_out) {
  __shared__ int scratch[kWarps];
  __shared__ int warp_off[kWarps];
  const int tile = blockIdx.x;
  int partial = 0;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) partial += counts[j];
  const int base = block_sum(partial, scratch);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, alive);
  const int lane_rank = __popc(ballot & ((1u << lane) - 1u));
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
  *base_out = base;
  *rank_out = warp_off[warp] + lane_rank;
}

__global__ void __launch_bounds__(kTile) count_kernel(
    const uint8_t* __restrict__ alive, int* __restrict__ counts) {
  __shared__ int scratch[kWarps];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const unsigned ballot = __ballot_sync(kFull, alive[i] != 0);
  const int c = block_sum((threadIdx.x & 31) == 0 ? __popc(ballot) : 0, scratch);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

__global__ void __launch_bounds__(kTile) compact_kernel(
    const int32_t* __restrict__ vals, const uint8_t* __restrict__ alive,
    const int* __restrict__ counts, int planes, int n, int cap,
    int32_t* __restrict__ out) {
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool a = alive[i] != 0;
  int base, rank;
  tile_rank(counts, a, &base, &rank);
  const int dst = base + rank;
  if (!a || dst >= cap) return;
  for (int p = 0; p < planes; ++p)
    out[static_cast<size_t>(p) * cap + dst] = vals[static_cast<size_t>(p) * n + i];
}

__global__ void __launch_bounds__(kTile) expand_kernel(
    const int32_t* __restrict__ narrow, const uint8_t* __restrict__ alive,
    const int* __restrict__ counts, const int32_t* __restrict__ fallback,
    int planes, int n, int cap, int32_t* __restrict__ out) {
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool a = alive[i] != 0;
  int base, rank;
  tile_rank(counts, a, &base, &rank);
  const int src = base + rank;
  const bool take = a && src < cap;
  for (int p = 0; p < planes; ++p) {
    const size_t o = static_cast<size_t>(p) * n + i;
    out[o] = take ? narrow[static_cast<size_t>(p) * cap + src] : fallback[o];
  }
}

}  // namespace

// vals [planes, n] int32, alive [n] bool (one byte 0/1), counts [n/1024]
// int32 scratch, out [planes, cap] int32. n % 1024 == 0.
extern "C" int lane_compact_launch(const int32_t* vals, const uint8_t* alive,
                                   int* counts, int planes, int n, int cap,
                                   int32_t* out, cudaStream_t stream) {
  if (n % kTile != 0 || planes < 0 || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = n / kTile;
  if (tiles == 0) return 0;
  count_kernel<<<tiles, kTile, 0, stream>>>(alive, counts);
  compact_kernel<<<tiles, kTile, 0, stream>>>(vals, alive, counts, planes, n,
                                              cap, out);
  return static_cast<int>(cudaGetLastError());
}

// narrow [planes, cap] int32, alive [n] bool, counts [n/1024] int32
// scratch, fallback [planes, n] int32, out [planes, n] int32.
extern "C" int lane_expand_launch(const int32_t* narrow, const uint8_t* alive,
                                  int* counts, const int32_t* fallback,
                                  int planes, int n, int cap, int32_t* out,
                                  cudaStream_t stream) {
  if (n % kTile != 0 || planes < 0 || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = n / kTile;
  if (tiles == 0) return 0;
  count_kernel<<<tiles, kTile, 0, stream>>>(alive, counts);
  expand_kernel<<<tiles, kTile, 0, stream>>>(narrow, alive, counts, fallback,
                                             planes, n, cap, out);
  return static_cast<int>(cudaGetLastError());
}
