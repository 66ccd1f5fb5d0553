"""Dataset IO: PLY meshes, BOP json files, BOP19 result CSV.

The port's own copy of ``rdpn6d_tpu/data/inout.py`` (numpy only):
``load_ply`` for ASCII and binary files, the BOP scene JSON loaders, and
the BOP19 result CSV, written byte for byte as the JAX package writes it.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "char": ("b", 1), "uchar": ("B", 1), "int8": ("b", 1), "uint8": ("B", 1),
    "short": ("h", 2), "ushort": ("H", 2), "int16": ("h", 2),
    "uint16": ("H", 2), "int": ("i", 4), "uint": ("I", 4), "int32": ("i", 4),
    "uint32": ("I", 4), "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str, vertex_scale: float = 1.0) -> dict[str, np.ndarray]:
    """Load an ascii or binary PLY. Returns {pts [N,3], normals?, colors?,
    faces? [M,3]} with pts scaled by vertex_scale (BOP models are mm)."""
    with open(path, "rb") as f:
        line = f.readline().decode("ascii").strip()
        assert line == "ply", f"not a ply file: {path}"
        fmt = None
        elements: list[tuple[str, int, list[tuple[str, str, str | None]]]] = []
        cur_props: list[tuple[str, str, str | None]] = []
        while True:
            raw = f.readline()
            if not raw:  # EOF before end_header: truncated/malformed file
                raise ValueError(f"truncated PLY header: {path}")
            line = raw.decode("ascii").strip()
            if line.startswith("comment") or line.startswith("obj_info") or not line:
                continue
            toks = line.split()
            if toks[0] == "format":
                fmt = toks[1]
            elif toks[0] == "element":
                cur_props = []
                elements.append((toks[1], int(toks[2]), cur_props))
            elif toks[0] == "property":
                if toks[1] == "list":
                    cur_props.append((toks[-1], toks[3], toks[2]))
                else:
                    cur_props.append((toks[-1], toks[1], None))
            elif toks[0] == "end_header":
                break

        data: dict[str, Any] = {}
        for el_name, count, props in elements:
            if fmt == "ascii":
                rows = _read_ply_ascii(f, count, props)
            else:
                rows = _read_ply_binary(f, count, props,
                                        little="little" in fmt)
            data[el_name] = rows

    out: dict[str, np.ndarray] = {}
    if "vertex" in data:
        v = data["vertex"]
        out["pts"] = np.stack([v["x"], v["y"], v["z"]], -1).astype(
            np.float64) * vertex_scale
        if "nx" in v:
            out["normals"] = np.stack([v["nx"], v["ny"], v["nz"]], -1)
        if "red" in v:
            out["colors"] = np.stack([v["red"], v["green"], v["blue"]], -1)
        if "texture_u" in v:
            out["texture_uv"] = np.stack([v["texture_u"], v["texture_v"]], -1)
    face_rows = None
    if "face" in data and "vertex_indices" in data["face"]:
        face_rows = data["face"]["vertex_indices"]
    elif "face" in data and "vertex_index" in data["face"]:
        face_rows = data["face"]["vertex_index"]
    if face_rows is not None:
        # fan-triangulate polygon faces (CAD exports often store quads):
        # truncating to r[:3] would silently punch one hole per quad into
        # every VSD depth render and generated xyz crop. (The reference
        # toolkit raises on non-triangles; a fan covers the same area.)
        tris = []
        for r in face_rows:
            for k in range(1, len(r) - 1):
                tris.append((r[0], r[k], r[k + 1]))
        out["faces"] = np.asarray(tris, np.int64)
    return out


def _read_ply_ascii(f, count, props):
    cols: dict[str, list] = {name: [] for name, _, _ in props}
    for _ in range(count):
        toks = f.readline().decode("ascii").split()
        i = 0
        for name, typ, list_len_type in props:
            if list_len_type is not None:
                n = int(toks[i]); i += 1
                cols[name].append([float(toks[i + j]) for j in range(n)])
                i += n
            else:
                cols[name].append(float(toks[i])); i += 1
    return {k: (np.asarray(v) if not isinstance(v[0], list) else v)
            for k, v in cols.items()}


def _read_ply_binary(f, count, props, little=True):
    endian = "<" if little else ">"
    has_list = any(p[2] is not None for p in props)
    if not has_list:
        # one vectorized structured read — a per-vertex struct.unpack loop
        # costs seconds on 100k-vertex meshes
        dt = np.dtype([(name, endian + _PLY_TYPES[t][0])
                       for name, t, _ in props])
        raw = f.read(dt.itemsize * count)
        arr = np.frombuffer(raw, dtype=dt, count=count)
        return {name: np.asarray(arr[name], np.float64)
                for name, _, _ in props}
    cols: dict[str, list] = {name: [] for name, _, _ in props}
    for _ in range(count):
        for name, typ, len_type in props:
            if len_type is not None:
                lc, ls = _PLY_TYPES[len_type]
                n = struct.unpack(endian + lc, f.read(ls))[0]
                ic, isz = _PLY_TYPES[typ]
                cols[name].append(list(
                    struct.unpack(endian + ic * n, f.read(isz * n))))
            else:
                c, s = _PLY_TYPES[typ]
                cols[name].append(struct.unpack(endian + c, f.read(s))[0])
    return {k: (np.asarray(v) if v and not isinstance(v[0], list) else v)
            for k, v in cols.items()}


# ---------------------------------------------------------------------------
# BOP json
# ---------------------------------------------------------------------------

def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_scene_gt(path: str) -> dict[int, list[dict]]:
    """{im_id: [{R 3x3, t 3 (m), obj_id}]} from scene_gt.json (mm -> m)."""
    raw = load_json(path)
    out = {}
    for im_id, insts in raw.items():
        lst = []
        for inst in insts:
            lst.append({
                "R": np.asarray(inst["cam_R_m2c"],
                                np.float64).reshape(3, 3),
                "t": np.asarray(inst["cam_t_m2c"], np.float64) / 1000.0,
                "obj_id": int(inst["obj_id"]),
            })
        out[int(im_id)] = lst
    return out


def load_scene_camera(path: str) -> dict[int, dict]:
    raw = load_json(path)
    out = {}
    for im_id, cam in raw.items():
        entry = {"K": np.asarray(cam["cam_K"], np.float64).reshape(3, 3)}
        if "depth_scale" in cam:
            entry["depth_scale"] = float(cam["depth_scale"])
        out[int(im_id)] = entry
    return out


def load_scene_gt_info(path: str) -> dict[int, list[dict]]:
    raw = load_json(path)
    return {int(k): v for k, v in raw.items()}


def load_bop_targets(path: str) -> list[dict]:
    """test_targets_bop19.json: [{im_id, inst_count, obj_id, scene_id}]."""
    return load_json(path)


# ---------------------------------------------------------------------------
# BOP19 result CSV  (scene_id,im_id,obj_id,score,R,t,time)
# ---------------------------------------------------------------------------

def save_bop_results_csv(path: str, results: list[dict]) -> None:
    """Write estimates byte-compatible with the reference's CSV
    (test_utils.py:33-52): R row-major space-separated, t in mm."""
    lines = ["scene_id,im_id,obj_id,score,R,t,time"]
    for r in results:
        R = np.asarray(r["R"], np.float64).reshape(9)
        t = np.asarray(r["t"], np.float64) * 1000.0
        lines.append(",".join([
            str(int(r["scene_id"])), str(int(r["im_id"])),
            str(int(r["obj_id"])), f"{float(r.get('score', 1.0)):.6f}",
            " ".join(f"{x:.8f}" for x in R),
            " ".join(f"{x:.8f}" for x in t),
            f"{float(r.get('time', -1.0)):.6f}",
        ]))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_bop_results_csv(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        header = f.readline()
        assert header.strip().startswith("scene_id"), header
        for line in f:
            if not line.strip():
                continue
            sid, iid, oid, score, R, t, tm = line.strip().split(",")
            out.append({
                "scene_id": int(sid), "im_id": int(iid), "obj_id": int(oid),
                "score": float(score),
                "R": np.fromstring(R, sep=" ").reshape(3, 3),
                "t": np.fromstring(t, sep=" ") / 1000.0,
                "time": float(tm),
            })
    return out
