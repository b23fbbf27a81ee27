"""Minimal PLY I/O (binary little-endian + ascii), no plyfile dependency.

The port's own copy of splatloam_tpu/io/ply.py (numpy only): both
packages write and read the same binary layout.

Writes the 2DGS-compatible surfel schema of ref scene/gaussian_model.py:
123-168 — properties x,y,z, opacity, scale_0..1, rot_0..3, f_dc_0..2 (dummy
colors kept for ecosystem compatibility) — and reads it back
(ref :170-221).  Also reads generic point-cloud PLYs (x/y/z at least).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def write_ply(filename: str | Path, arrays: dict[str, np.ndarray],
              count: int | None = None) -> None:
    """Write a single 'vertex' element with float32 scalar properties.

    ``arrays``: ordered mapping name -> [N] or [N, k] array ([N, k] expands
    to name_0..name_{k-1} unless name is x/y/z style scalars).
    """
    filename = Path(filename)
    filename.parent.mkdir(parents=True, exist_ok=True)
    cols: list[tuple[str, np.ndarray]] = []
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if arr.ndim == 1:
            cols.append((name, arr.astype("<f4")))
        else:
            for k in range(arr.shape[1]):
                cols.append((f"{name}_{k}", arr[:, k].astype("<f4")))
    n = count if count is not None else len(cols[0][1])
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in cols]
    header += ["end_header"]
    body = np.empty((n,), dtype=[(name, "<f4") for name, _ in cols])
    for name, arr in cols:
        body[name] = arr[:n]
    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(body.tobytes())


def read_ply(filename: str | Path) -> dict[str, np.ndarray]:
    """Read the first 'vertex' element; returns name -> [N] float arrays."""
    with open(filename, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{filename}: not a PLY file (no end_header)")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = None
    props: list[tuple[str, str]] = []
    counts: list[int] = []
    in_vertex = False
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                counts.append(int(tok[2]))
        elif tok[0] == "property" and in_vertex:
            if tok[1] == "list":
                raise ValueError("list properties unsupported for vertices")
            props.append((tok[-1], _PLY_TO_NP[tok[1]]))
    if fmt is None or not counts:
        raise ValueError(f"{filename}: malformed PLY header")
    n = counts[0]

    if fmt == "ascii":
        rows = np.loadtxt([ln for ln in body.decode().splitlines()
                           if ln.strip()][:n], dtype=np.float64, ndmin=2)
        return {name: rows[:, i].astype(np.float32)
                for i, (name, _) in enumerate(props)}
    byteorder = "<" if fmt == "binary_little_endian" else ">"
    dtype = np.dtype([(name, byteorder + t) for name, t in props])
    arr = np.frombuffer(body[:n * dtype.itemsize], dtype=dtype)
    return {name: np.ascontiguousarray(arr[name]).astype(np.float32)
            for name, _ in props}


# ---------------------------------------------------------------------------
# surfel-model schema (ref scene/gaussian_model.py:123-221)
# ---------------------------------------------------------------------------

def save_surfel_ply(filename: str | Path, xyz, logit_opacity, log_scale,
                    quat) -> None:
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    write_ply(filename, {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "opacity": np.asarray(logit_opacity, np.float32).reshape(n),
        "scale": np.asarray(log_scale, np.float32).reshape(n, 2),
        "rot": np.asarray(quat, np.float32).reshape(n, 4),
        "f_dc": np.zeros((n, 3), np.float32),
    })


def load_surfel_ply(filename: str | Path):
    """Returns (xyz [N,3], logit_opacity [N], log_scale [N,2], quat [N,4])."""
    d = read_ply(filename)
    xyz = np.stack([d["x"], d["y"], d["z"]], axis=1)
    opac = d["opacity"]
    scale_names = sorted((k for k in d if k.startswith("scale_")),
                         key=lambda k: int(k.split("_")[-1]))
    scales = np.stack([d[k] for k in scale_names], axis=1)
    rot_names = sorted((k for k in d if k.startswith("rot_")),
                       key=lambda k: int(k.split("_")[-1]))
    quat = np.stack([d[k] for k in rot_names], axis=1)
    return xyz, opac, scales, quat
