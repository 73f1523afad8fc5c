// Dense closest-hit intersector: every ray against every quad of a small
// scene (<= 112 quads), one thread per ray.
//
// Replaces the Pallas TPU kernel julia_raytracer_tpu/ops/pallas_intersect.py
// (_make_kernel, built by make_bruteforce_pallas), which bakes the quads
// into the kernel as unrolled constants and streams [64, 128]-ray blocks
// through the VPU.
//
// Semantics (identical to the TPU kernel and to the plain PyTorch version
// in ops/dense_intersect.py):
//   - each quad is two Moller-Trumbore triangles (p1,p2,p4) and (p3,p4,p2);
//     the second has its uv flipped and is skipped when p3 == p4;
//   - quads are visited in index order and a hit replaces the best only
//     when t < best_t strictly, so the lowest index wins ties and the first
//     triangle wins a tie within a quad; best_t starts at the ray's tmax;
//   - a reconstruction pass returns the interpolated position (lower or
//     upper triangle by u + v <= 1), the quad's constant element normal
//     (precomputed on the host) and its instance id;
//   - on a miss: prim -1, t = tmax, u = v = 0, position = normal = 0,
//     instance 0.
// Built with -fmad=false and IEEE division so each operation rounds as the
// separate PyTorch elementwise ops of the plain version do.
//
// What bounds it on an H100: per ray two triangle tests of ~35 flops per
// quad (36 tests, ~1.3 kflop, for the 18-quad Cornell box; 224 at the
// 112-quad cap) with 32 B read and 44 B written. At the main path's 262,144
// rays that is ~0.3 GFLOP and ~20 MB: microseconds against the card's
// 67 TFLOP/s (fp32, no tensor cores) and 3.35 TB/s, so launch overhead and
// occupancy dominate. The design keeps the whole quad table in shared
// memory (q x 16 floats, <= 7 KB), loaded once per block, so the inner loop
// reads only shared memory and registers, with one global read per ray
// input and one global write per output.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPrims = 112;
constexpr int kStride = 16;  // p1 p2 p3 p4 (12), normal (3), instance bits (1)
constexpr int kThreads = 256;

struct TriHit {
  bool hit;
  float u, v, t;
};

// Moller-Trumbore in the same operation order as the plain version.
__device__ __forceinline__ TriHit moller(
    float rox, float roy, float roz, float rdx, float rdy, float rdz,
    float tmin, float tmax, const float* a, const float* b, const float* c) {
  const float e1x = b[0] - a[0], e1y = b[1] - a[1], e1z = b[2] - a[2];
  const float e2x = c[0] - a[0], e2y = c[1] - a[1], e2z = c[2] - a[2];
  const float pvx = rdy * e2z - rdz * e2y;
  const float pvy = rdz * e2x - rdx * e2z;
  const float pvz = rdx * e2y - rdy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  const float tvx = rox - a[0], tvy = roy - a[1], tvz = roz - a[2];
  TriHit h;
  h.u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  h.v = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det;
  h.t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  h.hit = (det != 0.0f) && (h.u >= 0.0f) && (h.u <= 1.0f) && (h.v >= 0.0f) &&
          (h.u + h.v <= 1.0f) && (h.t >= tmin) && (h.t <= tmax);
  return h;
}

__global__ void __launch_bounds__(kThreads) dense_intersect_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    const float* __restrict__ prims, int q, int n,
    int* __restrict__ prim_out, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ t_out,
    float* __restrict__ pos_out, float* __restrict__ nrm_out,
    int* __restrict__ inst_out) {
  __shared__ float s[kMaxPrims * kStride];
  for (int k = threadIdx.x; k < q * kStride; k += blockDim.x) s[k] = prims[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float rox = ro[3 * i], roy = ro[3 * i + 1], roz = ro[3 * i + 2];
  const float rdx = rd[3 * i], rdy = rd[3 * i + 1], rdz = rd[3 * i + 2];
  const float tmin = tmin_in[i];
  float best_t = tmax_in[i];
  float bu = 0.0f, bv = 0.0f;
  int best = -1;

  for (int p = 0; p < q; ++p) {
    const float* r = s + p * kStride;
    const float* p1 = r;
    const float* p2 = r + 3;
    const float* p3 = r + 6;
    const float* p4 = r + 9;
    TriHit h = moller(rox, roy, roz, rdx, rdy, rdz, tmin, best_t, p1, p2, p4);
    if (h.hit && h.t < best_t) {
      best_t = h.t;
      bu = h.u;
      bv = h.v;
      best = p;
    }
    const bool degenerate = p3[0] == p4[0] && p3[1] == p4[1] && p3[2] == p4[2];
    if (!degenerate) {
      h = moller(rox, roy, roz, rdx, rdy, rdz, tmin, best_t, p3, p4, p2);
      if (h.hit && h.t < best_t) {
        best_t = h.t;
        bu = 1.0f - h.u;
        bv = 1.0f - h.v;
        best = p;
      }
    }
  }

  float px = 0.0f, py = 0.0f, pz = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  int inst = 0;
  if (best >= 0) {
    const float* r = s + best * kStride;
    const bool lower = bu + bv <= 1.0f;
    const float iu = lower ? bu : 1.0f - bu;
    const float iv = lower ? bv : 1.0f - bv;
    const float iw = 1.0f - iu - iv;
    // lower triangle (p1,p2,p4); upper (p3,p4,p2) with flipped uv
    const float* a = lower ? r : r + 6;
    const float* b = lower ? r + 3 : r + 9;
    const float* c = lower ? r + 9 : r + 3;
    px = a[0] * iw + b[0] * iu + c[0] * iv;
    py = a[1] * iw + b[1] * iu + c[1] * iv;
    pz = a[2] * iw + b[2] * iu + c[2] * iv;
    nx = r[12];
    ny = r[13];
    nz = r[14];
    inst = __float_as_int(r[15]);
  }
  prim_out[i] = best;
  u_out[i] = bu;
  v_out[i] = bv;
  t_out[i] = best_t;
  pos_out[3 * i] = px;
  pos_out[3 * i + 1] = py;
  pos_out[3 * i + 2] = pz;
  nrm_out[3 * i] = nx;
  nrm_out[3 * i + 1] = ny;
  nrm_out[3 * i + 2] = nz;
  inst_out[i] = inst;
}

}  // namespace

extern "C" int dense_intersect_launch(
    const float* ro, const float* rd, const float* tmin, const float* tmax,
    const float* prims, int q, int n, int* prim, float* u, float* v, float* t,
    float* pos, float* nrm, int* inst, cudaStream_t stream) {
  if (q < 0 || q > kMaxPrims || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  dense_intersect_kernel<<<blocks, kThreads, 0, stream>>>(
      ro, rd, tmin, tmax, prims, q, n, prim, u, v, t, pos, nrm, inst);
  return static_cast<int>(cudaGetLastError());
}
