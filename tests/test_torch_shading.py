"""Shading-side parity: the port's camera, geometry, every BSDF lobe
(eval, sample, pdf), the material dispatch, texture lookups,
eval_material and light sampling against the JAX package on the same
numpy inputs.

Tolerance: rtol 1e-5 with atol 1e-5. XLA's CPU and PyTorch's CPU
kernels differ by an ulp or two in transcendentals (sin, cos, atan,
acos, pow, log) and in how fused expressions round; the atol term covers
values that are differences of near-equal terms (e.g. 1 - u of a
Fresnel factor), where the relative error of an O(1) input becomes
absolute. Lobes whose results divide by grazing cosines get no looser
bound: the inputs keep |cos| >= 0.05. Ray-primitive intersection on
random triangles, light-sample directions and their pdfs use 1e-4, the t
tolerance of check() in tests/test_pallas_kernels.py: they divide by a
triangle determinant or normalize the difference of nearby points,
which amplifies a last-ulp difference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.ops import bsdf as jbsdf
from julia_raytracer_tpu.ops import camera as jcam
from julia_raytracer_tpu.ops import eval as jeval
from julia_raytracer_tpu.ops import geometry as jgeo
from julia_raytracer_tpu.ops import texture as jtex
from julia_raytracer_tpu.render import dispatch as jdisp
from julia_raytracer_tpu.render import lights as jlights
from julia_raytracer_tpu.render.scene_device import (
    build_device_scene as jax_build_device_scene,
)
from julia_raytracer_tpu.scene import types as jt
from julia_raytracer_tpu_torch.ops import bsdf as tbsdf
from julia_raytracer_tpu_torch.ops import camera as tcam
from julia_raytracer_tpu_torch.ops import eval as teval
from julia_raytracer_tpu_torch.ops import geometry as tgeo
from julia_raytracer_tpu_torch.ops import texture as ttex
from julia_raytracer_tpu_torch.render import dispatch as tdisp
from julia_raytracer_tpu_torch.render import lights as tlights
from julia_raytracer_tpu_torch.render.scene_device import device_scene_from_numpy
from torch_parity import cornell_scene_jax, jax_config_fields, jax_scene_arrays

N = 2048
RTOL = ATOL = 1e-5


def _unit(g, n):
    v = g.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def inputs():
    g = np.random.default_rng(11)
    normal = _unit(g, N)
    outgoing = _unit(g, N)
    incoming = _unit(g, N)
    # keep cosines off grazing so 1/cos factors stay well conditioned
    for v in (outgoing, incoming):
        c = np.sum(normal * v, axis=1, keepdims=True)
        v += normal * np.sign(c) * np.maximum(0.0, 0.05 - np.abs(c))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
    ior = g.uniform(1.1, 2.5, N).astype(np.float32)
    ior[::8] = 1.0  # refractive passthrough lanes
    return dict(
        color=g.uniform(0.05, 0.95, (N, 3)).astype(np.float32),
        normal=normal, outgoing=outgoing, incoming=incoming,
        halfway=_unit(g, N), direction=incoming,
        ior=ior, eta=ior,
        roughness=g.uniform(0.05, 1.0, N).astype(np.float32),
        metallic=g.uniform(0.0, 1.0, N).astype(np.float32),
        rnl=g.random(N, dtype=np.float32),
        rn=g.random((N, 2), dtype=np.float32),
        ruv=g.random((N, 2), dtype=np.float32),
        eta3=g.uniform(0.2, 3.0, (N, 3)).astype(np.float32),
        etak3=g.uniform(0.0, 4.0, (N, 3)).astype(np.float32),
        reflectivity=g.uniform(0.0, 1.0, (N, 3)).astype(np.float32),
        density=g.uniform(0.0, 3.0, (N, 3)).astype(np.float32),
        distance=g.uniform(0.0, 4.0, N).astype(np.float32),
        max_distance=g.uniform(0.5, 4.0, N).astype(np.float32),
        rl=g.random(N, dtype=np.float32),
        rd=g.random(N, dtype=np.float32),
        anisotropy=np.where(g.random(N) < 0.2, 0.0,
                            g.uniform(-0.9, 0.9, N)).astype(np.float32),
    )


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


# every public lobe of ops/bsdf.py with its argument names
LOBES = {
    "sample_hemisphere_cos": "normal ruv",
    "sample_hemisphere_cos_pdf": "normal direction",
    "microfacet_distribution": "roughness normal halfway",
    "microfacet_shadowing": "roughness normal halfway outgoing incoming",
    "sample_microfacet": "roughness normal rn",
    "sample_microfacet_pdf": "roughness normal halfway",
    "fresnel_dielectric": "eta normal outgoing",
    "fresnel_conductor": "eta3 etak3 normal outgoing",
    "fresnel_schlick": "reflectivity normal outgoing",
    "eta_to_reflectivity": "eta",
    "reflectivity_to_eta": "reflectivity",
    "eval_matte": "color normal outgoing incoming",
    "sample_matte": "color normal outgoing rn",
    "sample_matte_pdf": "color normal outgoing incoming",
    "eval_glossy": "color ior roughness normal outgoing incoming",
    "sample_glossy": "color ior roughness normal outgoing rnl rn",
    "sample_glossy_pdf": "color ior roughness normal outgoing incoming",
    "eval_reflective": "color roughness normal outgoing incoming",
    "sample_reflective": "color roughness normal outgoing rn",
    "sample_reflective_pdf": "color roughness normal outgoing incoming",
    "eval_reflective_delta": "color normal outgoing incoming",
    "sample_reflective_delta": "color normal outgoing",
    "sample_reflective_delta_pdf": "color normal outgoing incoming",
    "eval_gltfpbr": "color ior roughness metallic normal outgoing incoming",
    "sample_gltfpbr": "color ior roughness metallic normal outgoing rnl rn",
    "sample_gltfpbr_pdf": "color ior roughness metallic normal outgoing incoming",
    "eval_transparent": "color ior roughness normal outgoing incoming",
    "sample_transparent": "color ior roughness normal outgoing rnl rn",
    "sample_transparent_pdf": "color ior roughness normal outgoing incoming",
    "eval_transparent_delta": "color ior normal outgoing incoming",
    "sample_transparent_delta": "color ior normal outgoing rnl",
    "sample_transparent_delta_pdf": "color ior normal outgoing incoming",
    "eval_refractive": "color ior roughness normal outgoing incoming",
    "sample_refractive": "color ior roughness normal outgoing rnl rn",
    "sample_refractive_pdf": "color ior roughness normal outgoing incoming",
    "eval_refractive_delta": "color ior normal outgoing incoming",
    "sample_refractive_delta": "color ior normal outgoing rnl",
    "sample_refractive_delta_pdf": "color ior normal outgoing incoming",
    "eval_translucent": "color normal outgoing incoming",
    "sample_translucent": "color normal outgoing rn",
    "sample_translucent_pdf": "color normal outgoing incoming",
    "eval_passthrough": "color normal outgoing incoming",
    "sample_passthrough": "color normal outgoing",
    "sample_passthrough_pdf": "color normal outgoing incoming",
    "eval_transmittance": "density distance",
    "sample_transmittance": "density max_distance rl rd",
    "sample_transmittance_pdf": "density distance max_distance",
    "eval_phasefunction": "anisotropy outgoing incoming",
    "sample_phasefunction": "anisotropy outgoing rn",
    "sample_phasefunction_pdf": "anisotropy outgoing incoming",
}


@pytest.mark.parametrize("name", sorted(LOBES))
def test_bsdf_lobe(inputs, name):
    args = LOBES[name].split()
    want = getattr(jbsdf, name)(*(jnp.asarray(inputs[a]) for a in args))
    got = getattr(tbsdf, name)(*(torch.from_numpy(inputs[a]) for a in args))
    _close(got, want, what=name)


def _material(inputs, types_):
    g = np.random.default_rng(3)
    d = dict(
        type=types_, emission=g.random((N, 3), dtype=np.float32),
        color=inputs["color"], opacity=np.ones(N, np.float32),
        roughness=np.where(g.random(N) < 0.3, 0.0,
                           inputs["roughness"]).astype(np.float32),
        metallic=inputs["metallic"], ior=inputs["ior"],
        density=inputs["density"], scattering=inputs["reflectivity"],
        scanisotropy=inputs["anisotropy"],
        trdepth=np.full(N, 0.01, np.float32),
    )
    jm = jeval.MaterialPoint(**{k: jnp.asarray(v) for k, v in d.items()})
    tm = teval.MaterialPoint(**{k: torch.from_numpy(v) for k, v in d.items()})
    return jm, tm


@pytest.mark.parametrize("present", [None, (0,), (1, 2, 4)])
def test_dispatch(inputs, present):
    types_ = np.random.default_rng(4).integers(0, 8, N).astype(np.int32)
    if present is not None:
        types_ = np.asarray(present, np.int32)[types_ % len(present)]
    jm, tm = _material(inputs, types_)
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    for name, extra in (
        ("eval_bsdfcos", ("incoming",)), ("sample_bsdfcos", ("rnl", "rn")),
        ("sample_bsdfcos_pdf", ("incoming",)), ("eval_delta", ("incoming",)),
        ("sample_delta", ("rnl",)), ("sample_delta_pdf", ("incoming",)),
    ):
        want = getattr(jdisp, name)(jm, j["normal"], j["outgoing"],
                                    *(j[a] for a in extra), present=present)
        got = getattr(tdisp, name)(tm, t["normal"], t["outgoing"],
                                   *(t[a] for a in extra), present=present)
        _close(got, want, what=name)
    for name, args in (
        ("eval_scattering", "reflectivity density anisotropy outgoing incoming"),
        ("sample_scattering", "density anisotropy outgoing rn"),
        ("sample_scattering_pdf", "density anisotropy outgoing incoming"),
    ):
        args = args.split()
        _close(getattr(tdisp, name)(*(t[a] for a in args)),
               getattr(jdisp, name)(*(j[a] for a in args)), what=name)


def test_geometry(inputs):
    g = np.random.default_rng(5)
    ro = g.uniform(-1, 1, (N, 3)).astype(np.float32)
    rd = _unit(g, N)
    p = [g.uniform(-1, 1, (N, 3)).astype(np.float32) for _ in range(4)]
    p[3][::4] = p[2][::4]  # degenerate quads (embedded triangles)
    tmin = np.full(N, 1e-4, np.float32)
    tmax = np.full(N, 1e30, np.float32)
    uv = g.random((N, 2), dtype=np.float32)
    J = lambda *xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    T = lambda *xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    cases = [
        ("intersect_triangle", (ro, rd, tmin, tmax, p[0], p[1], p[2])),
        ("intersect_quad", (ro, rd, tmin, tmax, *p)),
        ("intersect_bbox", (ro, 1.0 / rd, tmin, tmax,
                            np.minimum(p[0], p[1]), np.maximum(p[0], p[1]))),
        ("intersect_point", (ro, rd, tmin, tmax, p[0],
                             np.full(N, 0.3, np.float32))),
        ("intersect_line", (ro, rd, tmin, tmax, p[0], p[1],
                            np.full(N, 0.2, np.float32),
                            np.full(N, 0.1, np.float32))),
        ("interpolate_quad", (*p, uv[:, 0], uv[:, 1])),
        ("quad_normal", tuple(p)),
        ("quad_area", tuple(p)),
        ("triangle_tangents_fromuv", (p[0], p[1], p[2], uv, uv[::-1].copy(),
                                      g.random((N, 2), dtype=np.float32))),
    ]
    for name, args in cases:
        want = getattr(jgeo, name)(*J(*args))
        got = getattr(tgeo, name)(*T(*args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for gg, ww in zip(got, want):
            if np.asarray(ww).dtype == bool:
                # a hit decided by a last-ulp difference may flip
                assert (gg.numpy() == np.asarray(ww)).mean() > 0.999, name
            else:
                hit = None
                if name.startswith("intersect"):
                    hit = np.asarray(want[0]) & got[0].numpy()
                ww, gg = np.asarray(ww), gg.numpy()
                if hit is not None:
                    ww, gg = ww[hit], gg[hit]
                _close(gg, ww, rtol=1e-4, atol=1e-4, what=name)


@pytest.mark.parametrize("ortho,tent", [(False, False), (False, True),
                                        (True, False)])
def test_camera(ortho, tent):
    g = np.random.default_rng(6)
    frame = np.array([[1, 0, 0], [0, 0.8, 0.6], [0, -0.6, 0.8], [0.1, 1, 3.9]],
                     np.float32)
    kw = dict(lens=0.035, film=0.024, aspect=1.5, focus=3.9, aperture=0.02)
    jc = jcam.CameraArrays(frame=jnp.asarray(frame),
                           **{k: jnp.float32(v) for k, v in kw.items()},
                           orthographic=ortho)
    tc = tcam.CameraArrays(frame=torch.from_numpy(frame),
                           **{k: torch.tensor(v, dtype=torch.float32)
                              for k, v in kw.items()},
                           orthographic=ortho)
    ij = g.integers(0, 64, (N, 2)).astype(np.int32)
    puv = g.random((N, 2), dtype=np.float32)
    luv = g.random((N, 2), dtype=np.float32)
    want = jcam.sample_camera(jc, jnp.asarray(ij), (64, 48), jnp.asarray(puv),
                              jnp.asarray(luv), tent)
    got = tcam.sample_camera(tc, torch.from_numpy(ij), (64, 48),
                             torch.from_numpy(puv), torch.from_numpy(luv), tent)
    for gg, ww in zip(got, want):
        _close(gg, ww, what="camera")


def _textured_scene():
    """The Cornell box plus textures, a textured environment light and
    textured materials, as (JAX scene, port scene)."""
    g = np.random.default_rng(9)
    s = cornell_scene_jax()
    s.textures = [
        jt.TextureData(width=3, height=2,
                       pixels=g.random((6, 4), dtype=np.float32)),
        jt.TextureData(width=4, height=4, linear=True,
                       pixels=g.uniform(0, 4, (16, 4)).astype(np.float32)),
    ]
    s.environments = [jt.EnvironmentData(
        frame=np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0], [0, 0, 0]], np.float32),
        emission=np.array([0.5, 0.6, 0.7], np.float32), emission_tex=1,
    )]
    s.materials[0].color_tex = 0
    s.materials[1].roughness_tex = 1
    s.materials[1].emission_tex = 1
    s.materials[1].normal_tex = 0
    s.materials[2].scattering_tex = 0
    # per-vertex normals, texcoords and colors on the left wall
    wall = s.shapes[1]
    nv = len(wall.positions)
    wall.normals = _unit(g, nv) * 0.3 + np.array([1, 0, 0], np.float32)
    wall.texcoords = g.random((nv, 2), dtype=np.float32)
    wall.colors = g.uniform(0.2, 1, (nv, 4)).astype(np.float32)
    dj, cj = jax_build_device_scene(s)
    dt, ct = device_scene_from_numpy(jax_scene_arrays(dj), jax_config_fields(cj),
                                     device="cpu")
    return dj, cj, dt, ct


def test_texture_material_and_environment():
    dj, cj, dt, ct = _textured_scene()
    g = np.random.default_rng(10)
    tid = g.integers(-1, 2, N).astype(np.int32)
    uv = g.uniform(-2, 2, (N, 2)).astype(np.float32)
    uv[:8] = np.round(uv[:8])  # integer uv: the mod1 wrap maps to 1.0
    for lin in (False, True):
        _close(ttex.eval_texture(dt.textures, torch.from_numpy(tid),
                                 torch.from_numpy(uv), lin),
               jtex.eval_texture(dj.textures, jnp.asarray(tid),
                                 jnp.asarray(uv), lin), what="texture")
    inst = g.integers(0, ct.n_instances, N).astype(np.int32)
    shp = g.uniform(0.2, 1, (N, 4)).astype(np.float32)
    jmat = jeval.eval_material(dj, jnp.asarray(inst), jnp.asarray(uv),
                               jnp.asarray(shp))
    tmat = teval.eval_material(dt, torch.from_numpy(inst),
                               torch.from_numpy(uv), torch.from_numpy(shp))
    for f in jmat._fields:
        _close(getattr(tmat, f), getattr(jmat, f), what=f)
    rows_j = dj.inst_mat_dense[jnp.asarray(inst)]
    rows_t = dt.inst_mat_dense[torch.from_numpy(inst)]
    jrow = jeval.eval_material_rows(dj, rows_j, jnp.asarray(uv), jnp.asarray(shp))
    trow = teval.eval_material_rows(dt, rows_t, torch.from_numpy(uv),
                                    torch.from_numpy(shp))
    jden = jeval.eval_material_dense(dj, jnp.asarray(inst), jnp.asarray(shp),
                                     ct.n_instances)
    tden = teval.eval_material_dense(dt, torch.from_numpy(inst),
                                     torch.from_numpy(shp))
    for f in jmat._fields:
        _close(getattr(trow, f), getattr(jrow, f), what="rows " + f)
        _close(getattr(tden, f), getattr(jden, f), what="dense " + f)
    d = _unit(g, N)
    _close(teval.eval_environment(dt, torch.from_numpy(d)),
           jeval.eval_environment(dj, jnp.asarray(d)), what="environment")


def test_surface_eval():
    """Vertex attributes, vertex normals, normal mapping and the
    shading-normal rules at random (prim, u, v)."""
    dj, cj, dt, ct = _textured_scene()
    assert ct.has_vertex_normals and ct.has_texcoords and ct.has_normal_maps
    g = np.random.default_rng(13)
    prim = g.integers(0, ct.n_prims, N).astype(np.int32)
    u, v = g.random(N, dtype=np.float32), g.random(N, dtype=np.float32)
    out = _unit(g, N)
    mtype = g.integers(0, 8, N).astype(np.int32)
    ntex = g.integers(-1, 1, N).astype(np.int32)
    J = {k: jnp.asarray(x) for k, x in dict(
        prim=prim, u=u, v=v, out=out, mtype=mtype, ntex=ntex).items()}
    T = {k: torch.from_numpy(x) for k, x in dict(
        prim=prim, u=u, v=v, out=out, mtype=mtype, ntex=ntex).items()}
    jverts, jvidx, jinst, jflags = jeval.gather_prim(dj, J["prim"])
    tverts, tvidx, tinst, tflags = teval.gather_prim(dt, T["prim"])
    for a, b in ((tverts, jverts), (tvidx, jvidx), (tinst, jinst),
                 (tflags, jflags)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(teval.eval_position(tverts, T["u"], T["v"]),
           jeval.eval_position(jverts, J["u"], J["v"]), what="position")
    jgn = jeval.eval_element_normal(jverts)
    tgn = teval.eval_element_normal(tverts)
    _close(tgn, jgn, what="element normal")
    jtc = jeval.eval_texcoord(dj, jvidx, jflags, J["u"], J["v"])
    ttc = teval.eval_texcoord(dt, tvidx, tflags, T["u"], T["v"])
    _close(ttc, jtc, what="texcoord")
    _close(teval.eval_color_attr(dt, tvidx, tflags, T["u"], T["v"]),
           jeval.eval_color_attr(dj, jvidx, jflags, J["u"], J["v"]),
           what="color")
    for nmap in (False, True):
        want = jeval.eval_shading_normal(
            dj, jgn, jverts, jvidx, jinst, jflags, J["u"], J["v"], J["out"],
            J["mtype"], J["ntex"], jtc, with_normalmap=nmap)
        got = teval.eval_shading_normal(
            dt, tgn, tverts, tvidx, tinst, tflags, T["u"], T["v"], T["out"],
            T["mtype"], T["ntex"], ttc, with_normalmap=nmap)
        _close(got, want, what="shading normal")


def test_light_sampling_and_pdf():
    dj, cj, dt, ct = _textured_scene()
    g = np.random.default_rng(12)
    pos = g.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (N, 3)).astype(np.float32)
    rl, rel = g.random(N, dtype=np.float32), g.random(N, dtype=np.float32)
    ruv = g.random((N, 2), dtype=np.float32)
    want = jlights.sample_lights(dj, dj.lights, cj.light_counts, *(
        jnp.asarray(x) for x in (pos, rl, rel, ruv)))
    got = tlights.sample_lights(dt, dt.lights, ct.light_counts, *(
        torch.from_numpy(x) for x in (pos, rl, rel, ruv)))
    _close(got, want, rtol=1e-4, atol=1e-4, what="sample_lights")
    # pdf of the sampled directions (they cross the light) and of random ones
    for d in (np.array(want), _unit(g, N)):
        wp = jlights.sample_lights_pdf(
            dj, dj.lights, cj.light_counts, None, jnp.asarray(pos),
            jnp.asarray(d), None)
        tp = tlights.sample_lights_pdf(dt, dt.lights, ct.light_counts,
                                       torch.from_numpy(pos), torch.from_numpy(d))
        _close(tp, wp, rtol=1e-4, what="sample_lights_pdf")
    # the env-texel CDF search picks the same texels
    assert ct.light_counts.n_env == 1
    texels = ct.light_counts.max_env_texels
    cnt = np.full(N, texels, np.int32)
    off = np.zeros(N, np.int32)
    got = tlights.sample_discrete(dt.lights.env_cdf, torch.from_numpy(off),
                                  torch.from_numpy(cnt), torch.from_numpy(rel),
                                  texels)
    want = jlights.sample_discrete(dj.lights.env_cdf, jnp.asarray(off),
                                   jnp.asarray(cnt), jnp.asarray(rel), texels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
