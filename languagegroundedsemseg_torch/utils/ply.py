"""Minimal self-contained PLY reader/writer (no plyfile dependency).

Counterpart of ``languagegroundedsemseg_tpu/utils/ply.py``.

Supports ascii and binary_little_endian vertex-only reads — the formats the
ScanNet preprocessing emits (reference lib/pc_utils.py:30-60 uses plyfile for
the same job).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read vertex properties of a PLY file -> {prop_name: (N,) array}."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = None
        elements: List[Tuple[str, int]] = []
        props: Dict[str, List[Tuple[str, str]]] = {}
        cur = None
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur = parts[1]
                elements.append((cur, int(parts[2])))
                props[cur] = []
            elif parts[0] == "property" and cur is not None:
                if parts[1] == "list":
                    props[cur].append(("list", " ".join(parts[2:])))
                else:
                    props[cur].append((parts[1], parts[-1]))

        assert elements and elements[0][0] == "vertex", "vertex element must come first"
        vname, vcount = elements[0]
        vprops = props[vname]
        assert all(t != "list" for t, _ in vprops), "list vertex properties unsupported"

        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=vcount, dtype=np.float64)
            rows = np.atleast_2d(rows)
            return {
                name: rows[:, i].astype(_PLY_TYPES[t])
                for i, (t, name) in enumerate(vprops)
            }
        if fmt == "binary_little_endian":
            dt = np.dtype([(name, "<" + _PLY_TYPES[t]) for t, name in vprops])
            data = np.frombuffer(f.read(dt.itemsize * vcount), dtype=dt, count=vcount)
            return {name: np.ascontiguousarray(data[name]) for _, name in vprops}
        raise ValueError(f"unsupported ply format {fmt!r}")


def read_ply_cloud(path: str):
    """Read a labeled cloud -> (xyz f32 (N,3), rgb f32 (N,3), labels i32,
    instance_ids i32 or None) — the tuple the datasets consume (reference
    lib/dataset.py:178-191 load_ply_w_path)."""
    d = read_ply(path)
    xyz = np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)
    if "red" in d:
        rgb = np.stack([d["red"], d["green"], d["blue"]], axis=1).astype(np.float32)
    else:
        rgb = np.zeros_like(xyz)
    labels = d.get("label")
    labels = labels.astype(np.int32) if labels is not None else np.zeros(len(xyz), np.int32)
    inst = d.get("instance_id")
    inst = inst.astype(np.int32) if inst is not None else None
    return xyz, rgb, labels, inst


def write_ply(
    path: str,
    xyz: np.ndarray,
    rgb: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    binary: bool = True,
):
    n = len(xyz)
    fields = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    if rgb is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if labels is not None:
        fields += [("label", "i4")]
    dt = np.dtype([(nm, ("<" if binary else "") + t) for nm, t in fields])
    rec = np.empty(n, dtype=dt)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if rgb is not None:
        c = np.clip(rgb, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]
    if labels is not None:
        rec["label"] = labels.astype(np.int32)
    type_names = {"f4": "float", "u1": "uchar", "i4": "int"}
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0",
               f"element vertex {n}"]
        hdr += [f"property {type_names[t]} {nm}" for nm, t in fields]
        hdr += ["end_header"]
        f.write(("\n".join(hdr) + "\n").encode("ascii"))
        if binary:
            f.write(rec.tobytes())
        else:
            for r in rec:
                f.write((" ".join(str(v) for v in r) + "\n").encode("ascii"))
