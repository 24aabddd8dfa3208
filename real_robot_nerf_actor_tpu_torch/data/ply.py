"""Minimal PLY point-cloud reader and writer, numpy only (the port's copy of
the JAX package's `data/ply.py`).

Covers what the recorded demos hold: ascii and binary_little_endian bodies,
vertex properties x/y/z (float) and red/green/blue (uchar), any other vertex
property skipped.
"""
from __future__ import annotations

import io
from typing import Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a PLY file -> (points (N,3) float32, colors (N,3) float32 in
    [0,1] or None)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header_end = data.find(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace")

    fmt = None
    n_vertex = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in header.splitlines():
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            in_vertex = t[1] == "vertex"
            if in_vertex:
                n_vertex = int(t[2])
        elif t[0] == "property" and in_vertex:
            if t[1] == "list":
                raise ValueError("list property on vertex element unsupported")
            props.append((t[2], _PLY_TYPES[t[1]]))

    names = [p[0] for p in props]
    if fmt == "ascii":
        body = np.loadtxt(io.BytesIO(data[header_end:]), max_rows=n_vertex, ndmin=2)
        cols = {nm: body[:, i] for i, (nm, _) in enumerate(props)}
    elif fmt == "binary_little_endian":
        dtype = np.dtype([(nm, "<" + ty) for nm, ty in props])
        arr = np.frombuffer(data, dtype=dtype, count=n_vertex, offset=header_end)
        cols = {nm: arr[nm] for nm in names}
    else:
        raise ValueError(f"unsupported PLY format {fmt!r}")

    pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1).astype(np.float32)
    colors = None
    if all(k in cols for k in ("red", "green", "blue")):
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=-1)
        # scale by the declared property type (ascii bodies parse as float)
        declared = dict(props)["red"]
        scale = {"u1": 255.0, "u2": 65535.0}.get(declared, 1.0)
        colors = (rgb / scale).astype(np.float32)
    return pts, colors


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
              binary: bool = True) -> None:
    """Write points (N,3) and optional colors (N,3 in [0,1]) to PLY."""
    n = points.shape[0]
    has_c = colors is not None
    lines = ["ply",
             "format binary_little_endian 1.0" if binary else "format ascii 1.0",
             f"element vertex {n}",
             "property float x", "property float y", "property float z"]
    if has_c:
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    lines.append("end_header")
    header = ("\n".join(lines) + "\n").encode("ascii")

    with open(path, "wb") as f:
        f.write(header)
        if binary:
            if has_c:
                dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                  ("r", "u1"), ("g", "u1"), ("b", "u1")])
                rec = np.empty(n, dtype=dtype)
                rec["x"], rec["y"], rec["z"] = points.T.astype(np.float32)
                c8 = np.clip(colors * 255.0 + 0.5, 0, 255).astype(np.uint8)
                rec["r"], rec["g"], rec["b"] = c8.T
                f.write(rec.tobytes())
            else:
                f.write(points.astype("<f4").tobytes())
        else:
            c8 = (np.clip(colors * 255.0 + 0.5, 0, 255).astype(np.uint8)
                  if has_c else None)
            for i in range(n):
                row = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
                if has_c:
                    row += f" {c8[i, 0]} {c8[i, 1]} {c8[i, 2]}"
                f.write((row + "\n").encode("ascii"))
