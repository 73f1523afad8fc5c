// Culled curve walk: the closest line and the closest point of each ray
// among its group's candidate curve elements, one thread a ray, each warp
// walking its group's list.
//
// Replaces no TPU kernel: the JAX package tests every line and point
// against every ray in jnp (julia_raytracer_tpu/render/integrator.py, the
// curve merge), and so does the port's plain sweep (render/integrator.py
// merge_curves), which stays the route on the CPU and in the fixed-trip
// loop. On the card the sweep ran some 40 ATen ops a chunk over [lanes,
// elements] temporaries (1,281.81 of the hairball's 1,308.73 device ms a
// sample, PERF.md); here the elements go through the work items' cull
// (candidate_cull.cu, unchanged) and one launch walks the lists.
//
// Inputs (ops/curve_intersect.py builds them):
//   - elems [E, 8] f32: the lines first, each (p1 xyz, r1, p2 xyz, r2),
//     then the points, each (p xyz, r, 0, 0, 0, 0); n_lines of the first;
//   - order [ng, E] i32, tlow [ng, E] f32, cnt [ng] i32: each group of
//     `group` rays' candidate elements by the cull of its rays against the
//     elements' padded world boxes, sorted by t_low, the nearest entry of
//     any of the group's rays, with the count first;
//   - tmax: the quad route's hit t (or the ray's tmax where it missed).
//
// Semantics (identical to curve_walk_plain, bit for bit when built with
// -fmad=false; the tests are ops/geometry.py intersect_line and
// intersect_point, term for term, their dot products as dot3 adds):
//   - each warp takes its group's candidates in t_low order and stops before
//     element k once no ray's bound, min(line best t, point best t), is at
//     or above tlow[k] (a warp vote; at, so that a tie is still met);
//   - a ray takes a line that it hits (t in [tmin, tmax]) below its line
//     best, or at it with a lower index once it has a line; a point the
//     same way against its point best. Best starts at tmax with no
//     element, so an element at t = tmax is never taken, as merge_curves
//     never lets one replace the quad hit;
//   - out: the line (-1: none) with its t (F32_MAX: none), u (the segment
//     parameter) and v (the radial fraction); the point (its index among
//     the points, -1: none) with its t (F32_MAX: none); `tested` adds the
//     (ray, element) pairs the warps tested.
// merge_curves turns these into the closest hit as its sweep does. The
// cull's boxes hold each element's hits (rounded out by a margin), so no
// element that could change that hit lies past where a warp stops.
//
// What bounds it on an H100: the element tests, 70 fp32 operations a line
// and 30 a point, one (ray, element) pair a lane each step; the bytes are
// the rays (32 B in, 24 B out), the list entries walked and 32 B an
// element, read by every lane of a warp at one address. No shared memory
// and no block-wide barrier: each warp walks on its own.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;  // 4 independent warps per CTA
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kF32Max = 3.4028234663852886e38f;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return (ax * bx + ay * by) + az * bz;
}

// torch.clamp(x, 0, 1): NaN stays NaN
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

// intersect_line: a = (p1, r1), b = (p2, r2) -> hit, s (u), v, t
__device__ __forceinline__ bool line_test(const Ray& r, const float4& a,
                                          const float4& b, float& s,
                                          float& v, float& t) {
  const float vx = b.x - a.x, vy = b.y - a.y, vz = b.z - a.z;
  const float wx = r.ox - a.x, wy = r.oy - a.y, wz = r.oz - a.z;
  const float A = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  const float B = dot3(r.dx, r.dy, r.dz, vx, vy, vz);
  const float C = dot3(vx, vy, vz, vx, vy, vz);
  const float D = dot3(r.dx, r.dy, r.dz, wx, wy, wz);
  const float E = dot3(vx, vy, vz, wx, wy, wz);
  const float det = A * C - B * B;
  const float safe = det == 0.0f ? 1.0f : det;
  t = (B * E - C * D) / safe;
  s = clamp01((A * E - B * D) / safe);
  const float qx = (r.ox + r.dx * t) - (a.x + vx * s);
  const float qy = (r.oy + r.dy * t) - (a.y + vy * s);
  const float qz = (r.oz + r.dz * t) - (a.z + vz * s);
  const float d2 = dot3(qx, qy, qz, qx, qy, qz);
  const float rad = a.w * (1.0f - s) + b.w * s;
  v = sqrtf(d2) / (rad == 0.0f ? 1.0f : rad);
  return det != 0.0f && t >= r.tmin && t <= r.tmax && d2 <= rad * rad;
}

// intersect_point: p = (centre, radius) -> hit, t
__device__ __forceinline__ bool point_test(const Ray& r, const float4& p,
                                           float& t) {
  const float wx = p.x - r.ox, wy = p.y - r.oy, wz = p.z - r.oz;
  t = dot3(wx, wy, wz, r.dx, r.dy, r.dz) /
      dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  const float qx = p.x - (r.ox + r.dx * t);
  const float qy = p.y - (r.oy + r.dy * t);
  const float qz = p.z - (r.oz + r.dz * t);
  return t >= r.tmin && t <= r.tmax &&
         dot3(qx, qy, qz, qx, qy, qz) <= p.w * p.w;
}

__global__ void __launch_bounds__(kThreads) curve_walk_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int n, const float4* __restrict__ elems, int n_lines,
    const int* __restrict__ order, const float* __restrict__ tlow,
    const int* __restrict__ cnt, int n_items, int group,
    int* __restrict__ line_out, float* __restrict__ lt_out,
    float* __restrict__ lu_out, float* __restrict__ lv_out,
    int* __restrict__ point_out, float* __restrict__ pt_out,
    unsigned long long* __restrict__ tested) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int first = i & ~(kWarp - 1);
  if (first >= n) return;  // the whole warp: no lane of it is a ray
  const bool live = i < n;  // the other lanes still vote
  Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    r.ox = ro[3 * i];
    r.oy = ro[3 * i + 1];
    r.oz = ro[3 * i + 2];
    r.dx = rd[3 * i];
    r.dy = rd[3 * i + 1];
    r.dz = rd[3 * i + 2];
    r.tmin = tmin_in[i];
    r.tmax = tmax_in[i];
  }
  float lt = r.tmax, lu = 0.0f, lv = 0.0f, pt = r.tmax;
  int li = -1, pi = -1;

  const int g = first / group;
  const int count = cnt[g];
  const size_t row = static_cast<size_t>(g) * n_items;
  int steps = 0;
  for (int k = 0; k < count; ++k) {
    // stop once no ray's bound reaches the next element's nearest entry
    const float key = __ldg(tlow + row + k);
    if (!__any_sync(kFullMask, live && fminf(lt, pt) >= key)) break;
    const int e = __ldg(order + row + k);
    ++steps;
    const float4 a = __ldg(elems + 2 * static_cast<size_t>(e));
    if (e < n_lines) {
      const float4 b = __ldg(elems + 2 * static_cast<size_t>(e) + 1);
      float s, v, t;
      const bool hit = line_test(r, a, b, s, v, t);
      if (live && hit && (t < lt || (t == lt && li >= 0 && e < li))) {
        lt = t;
        li = e;
        lu = s;
        lv = v;
      }
    } else {
      const int p = e - n_lines;
      float t;
      const bool hit = point_test(r, a, t);
      if (live && hit && (t < pt || (t == pt && pi >= 0 && p < pi))) {
        pt = t;
        pi = p;
      }
    }
  }
  if ((threadIdx.x & (kWarp - 1)) == 0 && steps > 0) {
    const int rays = n - first < kWarp ? n - first : kWarp;
    atomicAdd(tested, static_cast<unsigned long long>(steps) * rays);
  }
  if (!live) return;
  line_out[i] = li;
  lt_out[i] = li >= 0 ? lt : kF32Max;
  lu_out[i] = lu;
  lv_out[i] = lv;
  point_out[i] = pi;
  pt_out[i] = pi >= 0 ? pt : kF32Max;
}

}  // namespace

extern "C" int curve_walk_launch(const float* ro, const float* rd,
                                 const float* tmin, const float* tmax, int n,
                                 const float* elems, int n_lines,
                                 const int* order, const float* tlow,
                                 const int* cnt, int n_items, int group,
                                 int* line, float* lt, float* lu, float* lv,
                                 int* point, float* pt,
                                 unsigned long long* tested,
                                 cudaStream_t stream) {
  if (n < 0 || n_items < 1 || n_lines < 0 || n_lines > n_items ||
      group < kWarp || group % kWarp != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  curve_walk_kernel<<<blocks, kThreads, 0, stream>>>(
      ro, rd, tmin, tmax, n, reinterpret_cast<const float4*>(elems), n_lines,
      order, tlow, cnt, n_items, group, line, lt, lu, lv, point, pt, tested);
  return static_cast<int>(cudaGetLastError());
}
