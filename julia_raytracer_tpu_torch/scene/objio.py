"""Minimal OBJ reader for subdivision control cages (numpy), the port's
copy of julia_raytracer_tpu/scene/objio.py.

The corpus stores subdiv control meshes as small OBJs
(scenes/*/subdivs/*.obj, written by Yocto/GL); only positions and face
topology matter for Catmull-Clark — normals are recomputed after
tessellation and the corpus cages carry no meaningful texcoords.
Faces may be tris or quads (n-gons up to 4); tris are kept as 3-gons
(nsides array), NOT fan-triangulated, because Catmull-Clark subdivides
an n-gon into n quads around its face point.
"""

from __future__ import annotations

import numpy as np


def load_obj_cage(path: str):
    """-> (positions f32 [V,3], faces i32 [F,4] (slot 3 repeats slot 2
    for tris), nsides i32 [F] in {3,4}, texcoords f32 [T,2]|None,
    vt_faces i32 [F,4]|None). Texcoords are FACE-VARYING: vt_faces holds
    per-corner texcoord indices with their own topology (UV seams)."""
    pos: list[list[float]] = []
    uvs: list[list[float]] = []
    faces: list[list[int]] = []
    vt_faces: list[list[int]] = []
    nsides: list[int] = []
    any_vt = True
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                pos.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2])])
            elif line.startswith("f "):
                # OBJ is 1-based; negative indices are relative to the
                # positions read SO FAR (resolved here, not left to wrap
                # through numpy fancy-indexing as garbage)
                toks = [tok.split("/") for tok in line.split()[1:]]
                raw = [int(t[0]) for t in toks]
                idx = [i - 1 if i > 0 else len(pos) + i for i in raw]
                if any(i < 0 for i in idx):
                    raise ValueError(f"{path}: face index out of range")
                if len(idx) < 3 or len(idx) > 4:
                    raise ValueError(
                        f"{path}: only tri/quad faces supported, got "
                        f"{len(idx)}-gon"
                    )
                if all(len(t) > 1 and t[1] for t in toks):
                    # negative vt indices resolve against the texcoords read
                    # so far, same as position indices (silent numpy wrap
                    # would yield wrong texcoords instead of an error)
                    raw_vt = [int(t[1]) for t in toks]
                    vt = [i - 1 if i > 0 else len(uvs) + i for i in raw_vt]
                    if any(i < 0 or i >= len(uvs) for i in vt):
                        raise ValueError(f"{path}: texcoord index out of range")
                    if len(vt) == 3:
                        vt = vt + [vt[2]]
                    vt_faces.append(vt)
                else:
                    any_vt = False
                nsides.append(len(idx))
                if len(idx) == 3:
                    idx = idx + [idx[2]]
                faces.append(idx)
    have_vt = any_vt and len(uvs) > 0 and len(vt_faces) == len(faces)
    return (
        np.asarray(pos, np.float32),
        np.asarray(faces, np.int32).reshape(-1, 4),
        np.asarray(nsides, np.int32),
        np.asarray(uvs, np.float32) if have_vt else None,
        np.asarray(vt_faces, np.int32).reshape(-1, 4) if have_vt else None,
    )
