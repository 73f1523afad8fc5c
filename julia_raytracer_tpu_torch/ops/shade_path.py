"""Path shading of one bounce in one hand-written CUDA kernel
(csrc/shade_path.cu), with its plain version, the eager bounce.

Replaces no TPU kernel: the JAX package shades inside its loop body in
jnp, as render/integrator.py `eager_bounce` still does on the CPU, in the
fixed-trip loop and on every scene that render/integrator.py
`shade_route` does not cover. On the card that code issues some 800 ATen
launches a body; here a body's shading is one launch before the
intersect, which stays the route's own.

  make_tables: the scene's tables the kernel reads (shape colours, curve
    attributes, the material rows, the area lights), once a trace; no
    device work.
  shade_path: one bounce's shading of a TraceVars state -> ShadeOut (the
    next ray, its tmin and tmax, and the state's fields the bounce
    changes). For CPU tensors it calls `plain`, the eager bounce's shading
    (render/integrator.py shade_plain); for CUDA tensors it launches the
    kernel, which gives the same outputs bit for bit. It raises on another
    device and on a CUDA state of another dtype, shape or layout. Outputs
    are allocated by their inputs' shapes alone and nothing is read back,
    so a CUDA graph can capture it (render/body_graphs.py).

`shade_path.launches` counts the kernel's launches (a registered
counter, utils/timing.py).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops import cuda_build
from julia_raytracer_tpu_torch.utils import timing

FLAGS = ("-fmad=false",)


class ShadeOut(NamedTuple):
    """What one bounce's shading gives: the next ray and the bounds its
    intersect takes, and the lane state's new fields."""

    ro: torch.Tensor  # f32 [N, 3]
    rd: torch.Tensor  # f32 [N, 3]
    tmin: torch.Tensor  # f32 [N]
    tmax: torch.Tensor  # f32 [N] F32_MAX on live lanes, -1 elsewhere
    radiance: torch.Tensor  # f32 [N, 3]
    weight: torch.Tensor  # f32 [N, 3]
    rng: torch.Tensor  # i32 [N]
    bounce: torch.Tensor  # i32 [N]
    alive: torch.Tensor  # bool [N]
    hit_flag: torch.Tensor  # bool [N]
    hit_albedo: torch.Tensor  # f32 [N, 3]
    hit_normal: torch.Tensor  # f32 [N, 3]


class ShadeTables(NamedTuple):
    """The scene's tensors the kernel reads and its sizes and options."""

    tensors: dict  # name -> tensor (None: not read)
    sizes: dict  # name -> int or float


# the state's fields the kernel reads: (dtype, trailing shape)
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
_STATE_SPECS = dict(
    rd=(_F32, (3,)), isec_hit=(_BOOL, ()), isec_prim=(_I32, ()),
    isec_u=(_F32, ()), isec_v=(_F32, ()), isec_pos=(_F32, (3,)),
    isec_gn=(_F32, (3,)), isec_inst=(_I32, ()), radiance=(_F32, (3,)),
    weight=(_F32, (3,)), rng=(_I32, ()), bounce=(_I32, ()),
    alive=(_BOOL, ()), hit_flag=(_BOOL, ()), hit_albedo=(_F32, (3,)),
    hit_normal=(_F32, (3,)))
# the kernel's argument block (csrc/shade_path.cu ShadeArgs), in order: the
# state, the scene's tables (make_tables), the outputs, sizes and options
_SCENE = ("prim_vidx", "prim_flags", "vert_colors", "line_attr",
          "point_attr", "inst_mat_dense", "inst_material", "mat_type",
          "mat_emission", "mat_color", "mat_roughness", "mat_ior",
          "light_cdf", "light_offset", "light_count", "elem_verts",
          "elem_is_tri", "elem_area")
_OUT = tuple(f + "_out" for f in ShadeOut._fields)
# ShadeOut's fields: the next ray and its bounds, then the state's
_OUT_SPECS = ((_F32, (3,)), (_F32, (3,)), (_F32, ()), (_F32, ())) + tuple(
    _STATE_SPECS[f] for f in ShadeOut._fields[4:])
_INTS = ("n", "n_prim", "n_inst", "n_verts", "has_colors", "n_lines",
         "n_points", "n_mats", "n_lights", "cdf_len", "elem_rows", "n_elems",
         "search_iters", "bounces", "lobes")


class _Args(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p)
                 for name in (*_STATE_SPECS, *_SCENE, *_OUT)]
                + [(name, ctypes.c_int) for name in _INTS]
                + [("inv_lights", ctypes.c_float)])


def make_tables(dscene, config, options) -> ShadeTables:
    """The kernel's view of the scene (render/scene_device.py DeviceScene
    and SceneConfig) under `options` (TraceOptions). The material rows
    are eval_material_dense's folded table where the eager bounce takes it
    (1-64 instances), else eval_material's instance -> material tables."""
    counts = config.light_counts
    m = dscene.materials
    dense = 0 < config.n_instances <= 64
    lights = counts.total > 0
    lt = dscene.lights
    t = dict(
        prim_vidx=dscene.prim_vidx if config.has_colors else None,
        prim_flags=dscene.prim_flags if config.has_colors else None,
        vert_colors=dscene.vert_colors if config.has_colors else None,
        line_attr=dscene.line_attr if config.n_lines else None,
        point_attr=dscene.point_attr if config.n_points else None,
        inst_mat_dense=dscene.inst_mat_dense if dense else None,
        inst_material=None if dense else dscene.inst_material,
        mat_type=None if dense else m.type,
        mat_emission=None if dense else m.emission,
        mat_color=None if dense else m.color,
        mat_roughness=None if dense else m.roughness,
        mat_ior=None if dense else m.ior,
        light_cdf=lt.inst_cdf if lights else None,
        light_offset=lt.inst_cdf_offset if lights else None,
        light_count=lt.inst_cdf_count if lights else None,
        elem_verts=lt.elem_verts if lights else None,
        elem_is_tri=lt.elem_is_tri if lights else None,
        elem_area=lt.elem_owner_area if lights else None,
    )
    t = {k: None if v is None else v.contiguous() for k, v in t.items()}
    sizes = dict(
        n_prim=dscene.prim_verts.shape[0], n_inst=dscene.inst_frame.shape[0],
        n_verts=dscene.vert_colors.shape[0],
        has_colors=int(config.has_colors), n_lines=config.n_lines,
        n_points=config.n_points, n_mats=m.type.shape[0],
        n_lights=counts.total if lights else 0,
        cdf_len=lt.inst_cdf.shape[0], elem_rows=lt.elem_verts.shape[0],
        n_elems=counts.total_inst_elems if lights else 0,
        search_iters=max(1, int(counts.max_inst_elems).bit_length()),
        bounces=options.bounces,
        lobes=sum(1 << int(x) for x in config.present_types),
        inv_lights=float(np.float32(1.0 / counts.total)) if lights else 0.0)
    return ShadeTables(t, sizes)


def _check_state(s, n: int, dev) -> None:
    for name, (dtype, tail) in _STATE_SPECS.items():
        x = getattr(s, name)
        if (x.dtype != dtype or tuple(x.shape) != (n,) + tail
                or x.device != dev or not x.is_contiguous()):
            raise ValueError(
                f"shade_path: {name} must be a contiguous {dtype} "
                f"{(n,) + tail} on {dev}, got {x.dtype} {tuple(x.shape)} "
                f"on {x.device}" + ("" if x.is_contiguous()
                                    else ", not contiguous"))


def shade_path(tables: ShadeTables, s, plain) -> ShadeOut:
    """One bounce's shading of the lane state `s` (render/integrator.py
    TraceVars): `plain(s)` for CPU tensors, the kernel for CUDA tensors
    (module docstring)."""
    dev = s.alive.device
    if dev.type == "cpu":
        return plain(s)
    if dev.type != "cuda":
        raise ValueError(f"shade_path: unsupported device {dev}")
    n = s.alive.shape[0]
    _check_state(s, n, dev)
    for name, x in tables.tensors.items():
        if x is not None and x.device != dev:
            raise ValueError(f"shade_path: {name} is on {x.device}, the "
                             f"state on {dev}")
    out = ShadeOut(*(torch.empty((n,) + tail, dtype=dtype, device=dev)
                     for dtype, tail in _OUT_SPECS))
    args = _Args(
        **{name: getattr(s, name).data_ptr() for name in _STATE_SPECS},
        **{name: None if x is None else x.data_ptr()
           for name, x in tables.tensors.items()},
        **{name: x.data_ptr() for name, x in zip(_OUT, out)},
        n=n, **tables.sizes)
    err = _lib().shade_path_launch(ctypes.byref(args),
                                   cuda_build.stream_handle(dev))
    cuda_build.check(err, "shade_path")
    if n:  # the launcher launches nothing for no lanes
        shade_path.launches += 1
    return out


timing.counter(shade_path, "launches")


def _lib():
    lib = cuda_build.load("shade_path", FLAGS)
    fn = lib.shade_path_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
