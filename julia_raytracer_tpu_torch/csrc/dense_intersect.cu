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
// What bounds it on an H100: operations. Per ray two triangle tests per
// quad (36 for the 18-quad Cornell box, 224 at the 112-quad cap) with 32 B
// read and 44 B written; at the main path's 262,144 rays that is ~20 MB
// against ~0.3 GFLOP, microseconds at the card's 3.35 TB/s and 67 TFLOP/s
// (fp32, no tensor cores). The old design reloaded the quad corners into
// shared memory in every 256-thread block and recomputed each test's two
// edges; it ran 0.033 ms a launch on the card (device time, CUDA-graph
// replay; the 0.0656 ms that PERF.md's table gave it before counted the
// host's launch; PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W). This
// design:
//   - The quad table is prepared once on the host when the intersector is
//     built (ops/dense_intersect.py build_quad_params): per triangle its
//     first vertex and its two edges, the same float32 subtractions the
//     plain version does on the device, and per quad the flag p3 == p4.
//     It reaches the kernel as a by-value __grid_constant__ parameter
//     (CUDA >= 12.1 takes up to 32,764 B of them; 112 quads are 8,960 B),
//     and the quad loop is unrolled over the table's capacity (32 or 112
//     quads, a uniform break at q), so every operand sits at a fixed offset
//     of the constant bank: the counterpart of the TPU kernel's baked-in
//     constants without a compile per scene (a runtime loop would load each
//     operand by a register-indexed constant load). There is no shared
//     memory and no barrier, and the launch copies the parameter, so scenes
//     on several streams cannot clash.
//   - A pre-test on undivided quantities skips the reciprocal and the rest
//     of a test that must miss: det == 0, or u's numerator uu with U = uu *
//     sign(det) outside [-2^-23 |det|, 2 |det|], where rounding cannot
//     bring u = uu * (1 / det) into [0, 1]: U > 2 |det| gives u > 1 even
//     with the reciprocal's rounding in the denormal range, and U < -2^-23
//     |det| gives u < 0 without an underflow to -0 (which would pass u >=
//     0). NaN fails both compares and falls through to the exact test, and
//     so does an overflow of 2 |det|. Everything after it keeps the plain
//     version's operation order, so the results stay bit-equal;
//     tests/test_torch_dense_intersect.py holds its plain mirror
//     (pretest_pass) to never reject a hit. A warp skips the rest of a
//     test only where all its lanes reject: on coherent camera rays often,
//     on bounce rays seldom, where the branch costs more than it saves
//     (PERF.md section 6).
//   - The reconstruction pass reads the winner's corners, normal and
//     instance from the [Q, 16] device table, once per ray (its index
//     differs between lanes, which the constant bank would serialise).

#include <cuda_runtime.h>

#if CUDART_VERSION < 12010
#error "dense_intersect.cu passes its quad table as a kernel parameter of up to 8,960 B: CUDA >= 12.1"
#endif

namespace {

constexpr int kMaxPrims = 112;
constexpr int kSmallCap = 32;  // the unrolled loop's capacity for q <= 32
constexpr int kStride = 16;  // p1 p2 p3 p4 (12), normal (3), instance bits (1)
// a1 e1 e2 (tri 1), a2 f1 f2 (tri 2), degenerate flag, pad
constexpr int kQuadWords = 20;
constexpr int kThreads = 256;
constexpr float kNegTol = 1.1920928955078125e-07f;  // 2^-23

struct QuadParams {
  float w[kMaxPrims * kQuadWords];
};

struct TriHit {
  bool hit;
  float u, v, t;
};

// Moller-Trumbore against the triangle with first vertex k[0..2] and edges
// k[3..5], k[6..8] (fixed offsets of the parameter), in the same operation
// order as the plain version, after the pre-test (this file's head note).
__device__ __forceinline__ TriHit moller(float rox, float roy, float roz,
                                         float rdx, float rdy, float rdz,
                                         float tmin, float tmax,
                                         const float* k) {
  TriHit h = {false, 0.0f, 0.0f, 0.0f};
  const float e1x = k[3], e1y = k[4], e1z = k[5];
  const float e2x = k[6], e2y = k[7], e2z = k[8];
  const float pvx = rdy * e2z - rdz * e2y;
  const float pvy = rdz * e2x - rdx * e2z;
  const float pvz = rdx * e2y - rdy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float tvx = rox - k[0], tvy = roy - k[1], tvz = roz - k[2];
  const float uu = tvx * pvx + tvy * pvy + tvz * pvz;
  const float d_abs = fabsf(det);
  const float s = det < 0.0f ? -uu : uu;
  if (det == 0.0f || s > 2.0f * d_abs || s < -(d_abs * kNegTol)) return h;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  h.u = uu * inv_det;
  h.v = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det;
  h.t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  h.hit = (det != 0.0f) && (h.u >= 0.0f) && (h.u <= 1.0f) && (h.v >= 0.0f) &&
          (h.u + h.v <= 1.0f) && (h.t >= tmin) && (h.t <= tmax);
  return h;
}

// One thread per ray; the quads unrolled up to kCap (>= q).
template <int kCap>
__global__ void __launch_bounds__(kThreads) dense_intersect_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    const __grid_constant__ QuadParams quads,
    const float* __restrict__ prims, int q, int n,
    int* __restrict__ prim_out, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ t_out,
    float* __restrict__ pos_out, float* __restrict__ nrm_out,
    int* __restrict__ inst_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float rox = ro[3 * i], roy = ro[3 * i + 1], roz = ro[3 * i + 2];
  const float rdx = rd[3 * i], rdy = rd[3 * i + 1], rdz = rd[3 * i + 2];
  const float tmin = tmin_in[i];
  float best_t = tmax_in[i];
  float bu = 0.0f, bv = 0.0f;
  int best = -1;

#pragma unroll
  for (int p = 0; p < kCap; ++p) {
    if (p >= q) break;
    const float* k = quads.w + p * kQuadWords;
    TriHit h = moller(rox, roy, roz, rdx, rdy, rdz, tmin, best_t, k);
    if (h.hit && h.t < best_t) {
      best_t = h.t;
      bu = h.u;
      bv = h.v;
      best = p;
    }
    if (k[18] == 0.0f) {  // p3 != p4
      h = moller(rox, roy, roz, rdx, rdy, rdz, tmin, best_t, k + 9);
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
    const float* r = prims + best * kStride;
    const bool lower = bu + bv <= 1.0f;
    const float iu = lower ? bu : 1.0f - bu;
    const float iv = lower ? bv : 1.0f - bv;
    const float iw = 1.0f - iu - iv;
    // lower triangle (p1,p2,p4); upper (p3,p4,p2) with flipped uv
    const float* a = lower ? r : r + 6;
    const float* b = lower ? r + 3 : r + 9;
    const float* c = lower ? r + 9 : r + 3;
    px = __ldg(a) * iw + __ldg(b) * iu + __ldg(c) * iv;
    py = __ldg(a + 1) * iw + __ldg(b + 1) * iu + __ldg(c + 1) * iv;
    pz = __ldg(a + 2) * iw + __ldg(b + 2) * iu + __ldg(c + 2) * iv;
    nx = __ldg(r + 12);
    ny = __ldg(r + 13);
    nz = __ldg(r + 14);
    inst = __float_as_int(__ldg(r + 15));
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

// quads: host pointer to q x 20 floats (build_quad_params), copied into the
// launch's parameters; prims: device [q, 16] (build_prim_table).
extern "C" int dense_intersect_launch(
    const float* ro, const float* rd, const float* tmin, const float* tmax,
    const float* quads, const float* prims, int q, int n, int* prim,
    float* u, float* v, float* t, float* pos, float* nrm, int* inst,
    cudaStream_t stream) {
  if (q < 0 || q > kMaxPrims || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  QuadParams params = {};
  for (int k = 0; k < q * kQuadWords; ++k) params.w[k] = quads[k];
  const int blocks = (n + kThreads - 1) / kThreads;
  if (q <= kSmallCap) {
    dense_intersect_kernel<kSmallCap><<<blocks, kThreads, 0, stream>>>(
        ro, rd, tmin, tmax, params, prims, q, n, prim, u, v, t, pos, nrm, inst);
  } else {
    dense_intersect_kernel<kMaxPrims><<<blocks, kThreads, 0, stream>>>(
        ro, rd, tmin, tmax, params, prims, q, n, prim, u, v, t, pos, nrm, inst);
  }
  return static_cast<int>(cudaGetLastError());
}
