"""Dense closest-hit intersector for scenes of <= 112 quads: the wrapper of
csrc/dense_intersect.cu and its plain PyTorch version.

Replaces the Pallas TPU kernel julia_raytracer_tpu/ops/pallas_intersect.py
(_make_kernel via make_bruteforce_pallas). The quad tables are built once
per scene on the host (make_dense_table): [Q, 16] float32 rows of the four
corners, the quad's constant element normal (computed in float64 as the
TPU kernel's _quad_normal_const does) and the instance id's bits, on the
rays' device; and [Q, 20] float32 rows of each triangle's first vertex and
two edges (the plain version's own float32 subtractions) and the flag p3
== p4, kept on the host and passed to the kernel as a launch parameter.
`pretest_pass` is the plain mirror of the kernel's pre-test, which skips
the reciprocal of a test whose exact result must be a miss.

Semantics of both versions (see the .cu file): quads in index order,
strict `<` against a running best t that starts at tmax, so the lowest
index wins ties and the first triangle wins within a quad; the second
triangle's uv is flipped; on a miss prim is -1 and t is tmax. The plain
version evaluates all [N, 2Q] triangle tests at once with the kernel's
per-element operation order, then takes the first minimum in the
kernel's visiting order, which is what the sequential strict-< scan
selects.

For CPU tensors the wrapper runs the plain version; for CUDA tensors it
launches the kernel (or raises). `dense_intersect.launches` counts the
kernel's launches (a utils/timing.py counter).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops import cuda_build
from julia_raytracer_tpu_torch.ops.traversal import Hit, Intersector
from julia_raytracer_tpu_torch.utils import kernel_flops as kf, roofline, timing

MAX_PRIMS = 112
STRIDE = 16
# the kernel's parameter rows: a1 e1 e2 of (p1, p2, p4), a2 f1 f2 of (p3,
# p4, p2), the flag p3 == p4, a pad word
QUAD_WORDS = 20
NEG_TOL = 2.0**-23  # the pre-test's margin below u = 0


def _quad_normal_const(p: np.ndarray) -> np.ndarray:
    """Constant element normal of one quad [4, 3], in float64."""
    p = p.astype(np.float64)

    def tn(a, b, c):
        n = np.cross(b - a, c - a)
        l = np.linalg.norm(n)
        return n / l if l > 0 else n

    n = tn(p[0], p[1], p[3]) + tn(p[2], p[3], p[1])
    l = np.linalg.norm(n)
    return (n / l if l > 0 else n).astype(np.float32)


def build_prim_table(prim_verts: np.ndarray, prim_instance=None) -> np.ndarray:
    """[Q, 4, 3] corners (+ [Q] instance ids) -> [Q, 16] float32 table."""
    q = len(prim_verts)
    if q > MAX_PRIMS:
        raise ValueError(f"dense intersector takes <= {MAX_PRIMS} quads, got {q}")
    table = np.zeros((q, STRIDE), np.float32)
    table[:, :12] = np.asarray(prim_verts, np.float32).reshape(q, 12)
    for i in range(q):
        table[i, 12:15] = _quad_normal_const(table[i, :12].reshape(4, 3))
    inst = (
        np.zeros(q, np.int32) if prim_instance is None
        else np.asarray(prim_instance, np.int32)
    )
    table[:, 15] = inst.view(np.float32)
    return table


def build_quad_params(table: np.ndarray) -> np.ndarray:
    """[Q, 16] table (build_prim_table) -> [Q, 20] float32 rows of the
    kernel's parameter: per triangle its first vertex and its two edges,
    the same float32 subtractions `_moller` does, and the flag p3 == p4
    (1.0: the second triangle is skipped)."""
    t = np.asarray(table, np.float32)
    p1, p2, p3, p4 = t[:, 0:3], t[:, 3:6], t[:, 6:9], t[:, 9:12]
    out = np.zeros((len(t), QUAD_WORDS), np.float32)
    for k, (a, b, c) in enumerate(((p1, p2, p4), (p3, p4, p2))):
        out[:, 9 * k:9 * k + 3] = a
        out[:, 9 * k + 3:9 * k + 6] = b - a
        out[:, 9 * k + 6:9 * k + 9] = c - a
    out[:, 18] = (p3 == p4).all(axis=1)
    return out


class DenseTable(NamedTuple):
    """The dense intersector's two tables for one quad soup."""

    prims: torch.Tensor  # f32 [Q, 16] on the rays' device
    quads: np.ndarray  # f32 [Q, 20] on the host: the kernel's parameter


def make_dense_table(prim_verts: np.ndarray, prim_instance, device) -> DenseTable:
    """[Q, 4, 3] corners (+ [Q] instance ids) -> both tables, the [Q, 16]
    one on `device`."""
    table = build_prim_table(prim_verts, prim_instance)
    return DenseTable(torch.as_tensor(table, device=device),
                      build_quad_params(table))


def pretest_pass(ro, rd, quads: torch.Tensor, second: bool = False):
    """Plain mirror of the kernel's pre-test for rays ro/rd [N, 3] against
    the triangles of quads [Q, 20] (the first of each quad, or the second)
    -> [N, Q] bool: the tests that pass it and go on to the reciprocal. A
    test that fails it (det == 0, or u's numerator outside [-2^-23 |det|,
    2 |det|] in det's orientation) must be a miss of the exact test."""
    k = 9 if second else 0
    a, e1, e2 = ([quads[:, k + 3 * j + i] for i in range(3)] for j in range(3))
    rox, roy, roz = (ro[:, i:i + 1] for i in range(3))
    rdx, rdy, rdz = (rd[:, i:i + 1] for i in range(3))
    pvx = rdy * e2[2] - rdz * e2[1]
    pvy = rdz * e2[0] - rdx * e2[2]
    pvz = rdx * e2[1] - rdy * e2[0]
    det = e1[0] * pvx + e1[1] * pvy + e1[2] * pvz
    uu = (rox - a[0]) * pvx + (roy - a[1]) * pvy + (roz - a[2]) * pvz
    d_abs = det.abs()
    s = torch.where(det < 0.0, -uu, uu)
    return ~((det == 0.0) | (s > 2.0 * d_abs) | (s < -(d_abs * NEG_TOL)))


def _moller(ro, rd, tmin, tmax, a, b, c):
    """Moller-Trumbore of [N] rays against [Q] triangles -> [N, Q] (hit, u,
    v, t), in the kernel's operation order. ro/rd: 3 tensors [N, 1];
    a/b/c: 3 tensors [Q]."""
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    e1x, e1y, e1z = b[0] - a[0], b[1] - a[1], b[2] - a[2]
    e2x, e2y, e2z = c[0] - a[0], c[1] - a[1], c[2] - a[2]
    pvx = rdy * e2z - rdz * e2y
    pvy = rdz * e2x - rdx * e2z
    pvz = rdx * e2y - rdy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    tvx, tvy, tvz = rox - a[0], roy - a[1], roz - a[2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = (
        (det != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
        & (u + v <= 1.0) & (t >= tmin) & (t <= tmax)
    )
    return hit, u, v, t


def dense_intersect_plain(table, ro, rd, tmin, tmax) -> Hit:
    """Plain PyTorch version of the kernel (same results, bit for bit)."""
    n = ro.shape[0]
    if table.shape[0] == 0:
        z = torch.zeros(n, device=ro.device)
        return Hit(torch.zeros(n, dtype=torch.bool, device=ro.device),
                   torch.full((n,), -1, dtype=torch.int32, device=ro.device),
                   z, z.clone(), tmax.clone(), torch.zeros_like(ro),
                   torch.zeros_like(ro), torch.zeros(n, dtype=torch.int32,
                                                     device=ro.device))
    col = [table[:, k] for k in range(STRIDE)]
    p1, p2, p3, p4 = col[0:3], col[3:6], col[6:9], col[9:12]
    ro3 = [ro[:, k:k + 1] for k in range(3)]
    rd3 = [rd[:, k:k + 1] for k in range(3)]
    tn, tx = tmin[:, None], tmax[:, None]
    h1, u1, v1, t1 = _moller(ro3, rd3, tn, tx, p1, p2, p4)
    h2, u2, v2, t2 = _moller(ro3, rd3, tn, tx, p3, p4, p2)
    # candidates in the kernel's visiting order: (quad 0, tri 1), (quad 0,
    # tri 2), (quad 1, tri 1), ...; the strict-< scan keeps the first
    # minimum among candidates with t < tmax
    hit2 = torch.stack([h1, h2], dim=-1).reshape(n, -1) & (
        torch.stack([t1, t2], dim=-1).reshape(n, -1) < tx
    )
    t_all = torch.stack([t1, t2], dim=-1).reshape(n, -1)
    k = torch.argmin(torch.where(hit2, t_all, float("inf")), dim=1, keepdim=True)
    hit = hit2.gather(1, k)[:, 0]
    u_all = torch.stack([u1, 1.0 - u2], dim=-1).reshape(n, -1)
    v_all = torch.stack([v1, 1.0 - v2], dim=-1).reshape(n, -1)
    prim = torch.where(hit, (k[:, 0] // 2).to(torch.int32), -1)
    bu = torch.where(hit, u_all.gather(1, k)[:, 0], 0.0)
    bv = torch.where(hit, v_all.gather(1, k)[:, 0], 0.0)
    bt = torch.where(hit, t_all.gather(1, k)[:, 0], tmax)

    # reconstruction pass: interpolated position, constant normal, instance
    row = table[prim.clamp(min=0)]  # [N, 16]
    lower = (bu + bv <= 1.0)[:, None]
    iu = torch.where(lower[:, 0], bu, 1.0 - bu)[:, None]
    iv = torch.where(lower[:, 0], bv, 1.0 - bv)[:, None]
    iw = 1.0 - iu - iv
    a = torch.where(lower, row[:, 0:3], row[:, 6:9])
    b = torch.where(lower, row[:, 3:6], row[:, 9:12])
    c = torch.where(lower, row[:, 9:12], row[:, 3:6])
    hit1 = hit[:, None]
    pos = torch.where(hit1, a * iw + b * iu + c * iv, 0.0)
    nrm = torch.where(hit1, row[:, 12:15], 0.0)
    inst = torch.where(hit, row[:, 15].contiguous().view(torch.int32), 0)
    return Hit(hit, prim, bu, bv, bt, pos, nrm, inst)


def _check(x, dtype, shape, device, name):
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pretest_counts(table: DenseTable, ro, rd) -> tuple[int, int]:
    """(tests, reach): the triangle tests the kernel runs on these rays
    (second triangles of quads with p3 == p4 are skipped) and those that
    pass the pre-test and reach the reciprocal (pretest_pass)."""
    quads = torch.from_numpy(table.quads).to(ro.device)
    tested = quads[:, 18] == 0.0
    tests = reach = 0
    for second in (False, True):
        passed = pretest_pass(ro, rd, quads, second)
        if second:
            passed = passed[:, tested]
        tests += passed.numel()
        reach += int(passed.sum())
    return tests, reach


def call_cost(table: DenseTable, ro, rd) -> dict:
    """kernel_flops.dense_intersect_cost of one call on these rays."""
    return kf.dense_intersect_cost(
        ro.shape[0], table.quads.nbytes + table.prims.numel() * 4,
        *pretest_counts(table, ro, rd))


def dense_intersect(table: DenseTable, ro, rd, tmin, tmax) -> Hit:
    """Closest hit of rays ro/rd [N, 3], tmin/tmax [N] against the quads of
    `table` (make_dense_table). Plain version for CPU tensors, the CUDA
    kernel for CUDA tensors; under roofline.count_cost the call reports
    call_cost."""
    with roofline.kernel_region() as counter:
        hit = _dense_intersect(table, ro, rd, tmin, tmax)
        if counter is not None:
            counter.add_kernel("dense_intersect", call_cost(table, ro, rd))
    return hit


def _dense_intersect(table: DenseTable, ro, rd, tmin, tmax) -> Hit:
    prims, quads = table
    if ro.device.type == "cpu":
        return dense_intersect_plain(prims, ro, rd, tmin, tmax)
    if ro.device.type != "cuda":
        raise ValueError(f"dense_intersect: unsupported device {ro.device}")
    n, q = ro.shape[0], prims.shape[0]
    dev = ro.device
    f32 = torch.float32
    _check(prims, f32, (q, STRIDE), dev, "prims")
    if q > MAX_PRIMS:
        raise ValueError(f"dense intersector takes <= {MAX_PRIMS} quads, got {q}")
    if (quads.dtype != np.float32 or quads.shape != (q, QUAD_WORDS)
            or not quads.flags.c_contiguous):
        raise ValueError(f"quads: expected float32 ({q}, {QUAD_WORDS}) "
                         f"C-contiguous, got {quads.dtype} {quads.shape}")
    _check(ro, f32, (n, 3), dev, "ro")
    _check(rd, f32, (n, 3), dev, "rd")
    _check(tmin, f32, (n,), dev, "tmin")
    _check(tmax, f32, (n,), dev, "tmax")
    lib = _lib()
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=f32, device=dev)
    v = torch.empty(n, dtype=f32, device=dev)
    t = torch.empty(n, dtype=f32, device=dev)
    pos = torch.empty((n, 3), dtype=f32, device=dev)
    nrm = torch.empty((n, 3), dtype=f32, device=dev)
    inst = torch.empty(n, dtype=torch.int32, device=dev)
    err = lib.dense_intersect_launch(
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        quads.ctypes.data, prims.data_ptr(), q, n, prim.data_ptr(),
        u.data_ptr(), v.data_ptr(), t.data_ptr(), pos.data_ptr(),
        nrm.data_ptr(), inst.data_ptr(), cuda_build.stream_handle(dev),
    )
    cuda_build.check(err, "dense_intersect")
    if n:  # the launcher launches nothing for no rays
        dense_intersect.launches += 1
    return Hit(prim >= 0, prim, u, v, t, pos, nrm, inst)


timing.counter(dense_intersect, "launches")


FLAGS = ("-fmad=false",)


def _lib():
    lib = cuda_build.load("dense_intersect", FLAGS)
    fn = lib.dense_intersect_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def make_dense_intersect(prim_verts: np.ndarray, prim_instance, device):
    """The Intersector over a fixed quad soup (`tables`: its DenseTable).
    It is `graph_safe`: a call reads nothing back from the device and
    sizes its outputs by its inputs' shapes alone, and the kernel's launch
    goes onto PyTorch's current stream, so a CUDA graph can capture it
    (render/body_graphs.py)."""
    table = make_dense_table(prim_verts, prim_instance, device)

    def intersect(ro, rd, tmin, tmax):
        return dense_intersect(table, ro, rd, tmin, tmax)

    return Intersector(intersect, graph_safe=True, tables=table)
