// Worklist cluster intersector: closest hit of each ray over all quads of a
// flat scene of more than 112 quads (on heavy scenes the camera rays, the
// regroup fallback, and the bounce rays when kernel_select picks it; the
// hybrid's soup), one thread per ray, each warp walking its own
// supercluster list.
//
// Replaces the Pallas TPU kernel julia_raytracer_tpu/ops/pallas_cluster.py
// (_make_kernel_worklist, built by make_cluster_intersect_worklist; both its
// rectangular and its flat grid). The TPU kernel walks a sequential grid
// over (ray block, supercluster) steps and keeps the block's best hit in
// VMEM scratch across steps; here each warp walks its list in a loop and
// keeps each ray's best hit in registers.
//
// Inputs (ops/worklist_intersect.py builds them):
//   - tab [S*sup, 16, 128] f32: per cluster of 64 quads, rows 0-11 are the
//     128 triangles' affine world -> unit-triangle transforms (m_u, m_v,
//     n_hat, then t_u t_v t_w), rows 12-14 the quad's element normal, row 15
//     the owning instance id as f32;
//   - bbox [S*sup, 8] f32 cluster boxes (min xyz, max xyz, 2 pad); padding
//     clusters sit at +3e38 and are never entered; sbbox [S, 8] the
//     supercluster boxes (each the union of its clusters' boxes);
//   - order [ng, S] i32 / cnt [ng] i32: each group of `group` rays' (32 by
//     default, a multiple of the warp) superclusters front to back (the
//     precull in plain PyTorch), live count first.
//
// Semantics (identical to the plain PyTorch version in
// ops/worklist_intersect.py, bit for bit when built with -fmad=false):
//   - each warp takes its group's superclusters in list order, their
//     clusters in index order;
//   - each ray slab-tests each cluster box against [tmin, min(tmax, best)]
//     with the 1.00000024 slack of the TPU kernel (cluster_cull), and its
//     closest hit among the 128 triangles of a cluster it wants is the
//     first minimum below its running best (_closest_tri's result);
//   - triangle 2i is (p1, p2, p4) of quad i, triangle 2i+1 is (p3, p4, p2)
//     with its uv flipped;
//   - out: prim = best triangle / 2 (-1 on a miss), t = best t (tmax on a
//     miss), position = o + t d, the element normal and instance of the hit
//     (0 on a miss).
// A ray that does not enter a supercluster's box (against its running best)
// enters none of its clusters, so that test only skips work: a warp none of
// whose rays enters it skips the supercluster after one vote.
//
// What bounds it on an H100: the triangle tests. Each (ray, cluster) pair
// that passes the cull costs 128 tests of 40 fp32 operations; the bytes are
// the rays (32 B in, 44 B out each) and the table read once (8 KB per
// cluster; 13.6 MB for the 102,406-quad sphere scene, which fits in the
// 50 MB L2). So it is bound by operations at 67 TFLOP/s fp32 (no tensor
// cores: the hit test is a divide and compares). The old design (one
// 1024-thread CTA per ray block, one block-wide vote and a synchronous 8 KB
// shared-memory load per wanted cluster, each wanting lane running all 128
// tests alone) kept 9% of lanes busy in the triangle loop at one CTA per
// SM, 31.117 ms on the sphere grid's bounce rays (PERF.md, H100 80GB HBM3,
// 700 W). This design walks per warp (warp_walk.cuh): one mask vote per
// (warp, supercluster), the wanting rays of a cluster tested one at a time
// by all 32 lanes, the table read by coalesced float4 loads through the
// read-only path into registers, no shared memory and no block-wide
// barrier, so several 128-thread CTAs share an SM (124 registers: 4 CTAs,
// 16 warps) and one warp's loads overlap another's tests. Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6): 1.660 ms on the
// sphere grid's bounce rays, 16.8x its 0.0989 ms bound (1.107 ms on its
// camera rays, 6.965 before); 3.07 rays per table load and 83% of the
// triangle loop's lane slots on real triangles on bounce rays, so the
// table loads and each step's 128 cluster culls, not the tests, now set
// its time.

#include <cuda_runtime.h>

#include "warp_walk.cuh"

namespace {

constexpr int kThreads = 128;  // 4 independent warps per CTA
constexpr int kMaxSup = kMaskWords * kWarp;

__global__ void __launch_bounds__(kThreads) worklist_intersect_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int n, const float* __restrict__ tab, const float* __restrict__ bbox,
    const float* __restrict__ sbbox, const int* __restrict__ order,
    const int* __restrict__ cnt, int n_super, int sup, int group, int q,
    int* __restrict__ prim_out, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ t_out,
    float* __restrict__ pos_out, float* __restrict__ nrm_out,
    int* __restrict__ inst_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int first = i & ~(kWarp - 1);
  if (first >= n) return;  // the whole warp: no lane of it is a ray
  const bool live = i < n;  // the other lanes still vote and shuffle
  Ray r = {};
  float tmax = 0.0f;
  if (live) {
    r.ox = ro[3 * i];
    r.oy = ro[3 * i + 1];
    r.oz = ro[3 * i + 2];
    r.dx = rd[3 * i];
    r.dy = rd[3 * i + 1];
    r.dz = rd[3 * i + 2];
    set_inverse_dir(r);
    r.tmin = tmin_in[i];
    tmax = tmax_in[i];
  }
  Best b = {tmax, 0.0f, 0.0f, -1, 0, 0};

  const int g = first / group;
  const int count = cnt[g];
  for (int k = 0; k < count; ++k) {
    const int sc = __ldg(order + static_cast<size_t>(g) * n_super + k);
    float sbox[8];
    load_box(sbbox + sc * 8, sbox);
    const bool enter = live && cluster_cull(r, min_nan(tmax, b.t), sbox);
    if (!__any_sync(kFullMask, enter)) continue;
    warp_super_step(r, tmax, enter, b,
                    bbox + static_cast<size_t>(sc) * sup * 8,
                    tab + static_cast<size_t>(sc) * sup * kRows * kTris, sup,
                    sc * sup, 0);
  }

  if (!live) return;
  int prim = -1;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, inst = 0.0f;
  if (b.cluster >= 0) {
    prim = (b.cluster * kTris + b.arg) / 2;
    const float* attr =
        tab + static_cast<size_t>(b.cluster) * kRows * kTris + b.arg;
    nx = attr[12 * kTris];
    ny = attr[13 * kTris];
    nz = attr[14 * kTris];
    inst = attr[15 * kTris];
  }
  if (prim >= q) prim = -1;
  const float t = prim >= 0 ? b.t : tmax;
  prim_out[i] = prim;
  u_out[i] = b.u;
  v_out[i] = b.v;
  t_out[i] = t;
  pos_out[3 * i] = r.ox + t * r.dx;
  pos_out[3 * i + 1] = r.oy + t * r.dy;
  pos_out[3 * i + 2] = r.oz + t * r.dz;
  nrm_out[3 * i] = nx;
  nrm_out[3 * i + 1] = ny;
  nrm_out[3 * i + 2] = nz;
  inst_out[i] = static_cast<int>(inst + 0.5f);
}

}  // namespace

extern "C" int worklist_intersect_launch(
    const float* ro, const float* rd, const float* tmin, const float* tmax,
    int n, const float* tab, const float* bbox, const float* sbbox,
    const int* order, const int* cnt, int n_super, int sup, int group, int q,
    int* prim, float* u, float* v, float* t, float* pos, float* nrm,
    int* inst, cudaStream_t stream) {
  if (n < 0 || n_super < 1 || sup < 1 || sup > kMaxSup || group < kWarp ||
      group % kWarp != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  worklist_intersect_kernel<<<blocks, kThreads, 0, stream>>>(
      ro, rd, tmin, tmax, n, tab, bbox, sbbox, order, cnt, n_super, sup,
      group, q, prim, u, v, t, pos, nrm, inst);
  return static_cast<int>(cudaGetLastError());
}
