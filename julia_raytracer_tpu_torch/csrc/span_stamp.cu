// Clock stamps of a utils/timing.py device_span on the card, eager or in
// a captured CUDA graph (which cannot hold timed CUDA events). The span's
// ends are two launches of one thread each that write the card's
// %globaltimer (ns) into an int64 slot: the first stamps the start, the
// second turns the stamp into the ns since it and copies the span's
// tensor counts beside it (in a graph, into the graph's record, which
// each replay rewrites and the host copies out).
//
// No TPU counterpart: the JAX package times its spans on the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCounts = 8;

struct Counts {
  const int64_t* src[kMaxCounts];
  int k;
};

__device__ __forceinline__ int64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<int64_t>(t);
}

// clock: the start stamp (end == 0) or, at the end, the ns since it;
// out[i] = *counts.src[i].
__global__ void span_stamp_kernel(int64_t* clock, int64_t* out, Counts counts,
                                  int end) {
  const int64_t t = global_ns();
  for (int i = 0; i < counts.k; ++i) out[i] = *counts.src[i];
  *clock = end ? t - *clock : t;
}

}  // namespace

// clock: one int64; out: k int64; srcs: k device pointers to one int64
// each (k <= 8). One thread on `stream`.
extern "C" int span_stamp_launch(int64_t* clock, int64_t* out,
                                 const int64_t* const* srcs, int k, int end,
                                 cudaStream_t stream) {
  if (k < 0 || k > kMaxCounts) return static_cast<int>(cudaErrorInvalidValue);
  Counts counts{};
  for (int i = 0; i < k; ++i) counts.src[i] = srcs[i];
  counts.k = k;
  span_stamp_kernel<<<1, 1, 0, stream>>>(clock, out, counts, end);
  return static_cast<int>(cudaGetLastError());
}
