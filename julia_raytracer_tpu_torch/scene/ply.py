"""Vectorized binary-PLY reader (numpy), replacing PlyIO (src/shape.jl:78-124).

The port's copy of julia_raytracer_tpu/scene/ply.py, kept as it is.

The Yocto-exported scene corpus uses `binary_little_endian 1.0` with float
vertex properties and a single `list uchar int` index property per face /
line / point element. The fast path parses uniform-count lists with one
reshape; ragged lists fall back to an offset walk.

Face semantics (src/shape.jl:302-369):
  - if ANY face has 4 indices, every face is parsed as a quad; 3-index
    faces become (a, b, c, c), >4-gons are fanned into degenerate quads
    (a, v[k-1], v[k], v[k]);
  - otherwise faces are triangles; >3-gons are fanned into triangles.
Indices remain 0-based here (the reference shifts to 1-based for Julia,
src/shape.jl:101-105 — irrelevant for numpy).
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class PlyElement:
    name: str
    count: int
    # scalar properties: list of (name, dtype-str); data dict name -> np array
    properties: list = field(default_factory=list)
    # list property: (name, count_dtype, item_dtype) or None
    list_property: tuple | None = None
    data: dict = field(default_factory=dict)
    list_counts: np.ndarray | None = None
    list_data: np.ndarray | None = None


def read_ply(path: str) -> dict[str, PlyElement]:
    with open(path, "rb") as f:
        raw = f.read()
    header_end = raw.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: missing PLY end_header")
    header = raw[:header_end].decode("ascii", "replace").splitlines()
    body = memoryview(raw)[header_end + len(b"end_header\n"):]

    fmt = None
    elements: list[PlyElement] = []
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append(PlyElement(tok[1], int(tok[2])))
        elif tok[0] == "property":
            el = elements[-1]
            if tok[1] == "list":
                el.list_property = (tok[4], _DTYPES[tok[2]], _DTYPES[tok[3]])
            else:
                el.properties.append((tok[2], _DTYPES[tok[1]]))
    if fmt == "ascii":
        return _read_ascii(header, raw[header_end + len(b"end_header\n"):], elements)
    if fmt != "binary_little_endian":
        raise ValueError(f"{path}: unsupported PLY format {fmt}")

    offset = 0
    for el in elements:
        if el.list_property is None:
            dtype = np.dtype([(n, "<" + d) for n, d in el.properties])
            arr = np.frombuffer(body, dtype=dtype, count=el.count, offset=offset)
            offset += dtype.itemsize * el.count
            for n, _ in el.properties:
                el.data[n] = arr[n]
        else:
            if el.properties:
                raise ValueError(f"{path}: mixed scalar+list element unsupported")
            _name, cnt_d, item_d = el.list_property
            cnt_size = np.dtype(cnt_d).itemsize
            item_size = np.dtype(item_d).itemsize
            if el.count == 0:
                el.list_counts = np.zeros(0, np.int64)
                el.list_data = np.zeros(0, np.int64)
                continue
            # fast path: uniform list length
            first_cnt = int(np.frombuffer(body, dtype="<" + cnt_d, count=1, offset=offset)[0])
            stride = cnt_size + first_cnt * item_size
            if offset + stride * el.count <= len(body):
                block = np.frombuffer(
                    body, dtype=np.uint8, count=stride * el.count, offset=offset
                ).reshape(el.count, stride)
                counts = block[:, :cnt_size].copy().view("<" + cnt_d).ravel()
                if np.all(counts == first_cnt):
                    items = (
                        block[:, cnt_size:].copy().view("<" + item_d)
                        .reshape(el.count, first_cnt)
                    )
                    el.list_counts = counts.astype(np.int64)
                    el.list_data = items.astype(np.int64).ravel()
                    offset += stride * el.count
                    continue
            # ragged fallback: walk offsets
            counts = np.empty(el.count, np.int64)
            chunks = []
            pos = offset
            for i in range(el.count):
                c = int(np.frombuffer(body, dtype="<" + cnt_d, count=1, offset=pos)[0])
                counts[i] = c
                pos += cnt_size
                chunks.append(
                    np.frombuffer(body, dtype="<" + item_d, count=c, offset=pos)
                )
                pos += c * item_size
            el.list_counts = counts
            el.list_data = np.concatenate(chunks).astype(np.int64) if chunks else np.zeros(0, np.int64)
            offset = pos
    return {el.name: el for el in elements}


def _read_ascii(header, body_bytes, elements):
    text = io.StringIO(body_bytes.decode("ascii", "replace"))
    for el in elements:
        if el.list_property is None:
            rows = np.array(
                [text.readline().split() for _ in range(el.count)], dtype=np.float64
            )
            for j, (n, d) in enumerate(el.properties):
                el.data[n] = rows[:, j].astype("<" + d)
        else:
            counts, items = [], []
            for _ in range(el.count):
                vals = text.readline().split()
                c = int(vals[0])
                counts.append(c)
                items.extend(int(v) for v in vals[1 : 1 + c])
            el.list_counts = np.array(counts, np.int64)
            el.list_data = np.array(items, np.int64)
    return {el.name: el for el in elements}


def _fan_lists(counts: np.ndarray, data: np.ndarray, as_quads: bool) -> np.ndarray:
    """Fan ragged polygon lists into quads (a,b,c,c-padded) or triangles."""
    out = []
    offs = np.concatenate([[0], np.cumsum(counts)])
    for i in range(len(counts)):
        idx = data[offs[i]: offs[i + 1]]
        n = len(idx)
        if as_quads:
            if n == 0:
                out.append((-1, -1, -1, -1))
            elif n == 1:
                out.append((idx[0], -1, -1, -1))
            elif n == 2:
                out.append((idx[0], idx[1], -1, -1))
            elif n == 3:
                out.append((idx[0], idx[1], idx[2], idx[2]))
            elif n == 4:
                out.append(tuple(idx))
            else:
                for k in range(1, n - 1):
                    out.append((idx[0], idx[k], idx[k + 1], idx[k + 1]))
        else:
            if n == 0:
                out.append((-1, -1, -1))
            elif n == 1:
                out.append((idx[0], -1, -1))
            elif n == 2:
                out.append((idx[0], idx[1], -1))
            elif n == 3:
                out.append(tuple(idx))
            else:
                for k in range(1, n - 1):
                    out.append((idx[0], idx[k], idx[k + 1]))
    width = 4 if as_quads else 3
    if not out:
        return np.zeros((0, width), np.int32)
    return np.array(out, np.int32)


def parse_faces(el: PlyElement) -> tuple[np.ndarray, np.ndarray, bool]:
    """-> (triangles [T,3] i32, quads [Q,4] i32, had_quads).

    Matches get_faces/has_quads (src/shape.jl:430-446): if any face has 4
    vertices the whole element is parsed as quads (triangles padded c,c).
    """
    counts, data = el.list_counts, el.list_data
    empty3 = np.zeros((0, 3), np.int32)
    empty4 = np.zeros((0, 4), np.int32)
    if counts is None or len(counts) == 0:
        return empty3, empty4, False
    has_quads = bool(np.any(counts == 4))
    if has_quads:
        if np.all(counts == 4):
            quads = data.reshape(-1, 4).astype(np.int32)
        else:
            quads = _fan_lists(counts, data, as_quads=True)
        return empty3, quads, True
    if np.all(counts == 3):
        return data.reshape(-1, 3).astype(np.int32), empty4, False
    return _fan_lists(counts, data, as_quads=False), empty4, False


def parse_lines(el: PlyElement) -> np.ndarray:
    """Polyline lists -> [L,2] i32 segments (src/shape.jl:407-428)."""
    counts, data = el.list_counts, el.list_data
    if counts is None or len(counts) == 0:
        return np.zeros((0, 2), np.int32)
    if np.all(counts == 2):
        return data.reshape(-1, 2).astype(np.int32)
    segs = []
    offs = np.concatenate([[0], np.cumsum(counts)])
    for i in range(len(counts)):
        idx = data[offs[i]: offs[i + 1]]
        if len(idx) == 0:
            segs.append((-1, -1))
        elif len(idx) == 1:
            segs.append((idx[0], -1))
        else:
            for k in range(len(idx) - 1):
                segs.append((idx[k], idx[k + 1]))
    return np.array(segs, np.int32)
