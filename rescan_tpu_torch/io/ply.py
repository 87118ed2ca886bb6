"""PLY codec, byte-compatible with the reference's msh_ply output.

The reference reads/writes PLY through descriptor-driven msh_ply
(lib/msh/msh_ply.h). The surfel field set is fixed
(lib/rs/rs_pointcloud.h:608-611 / :791-794):

    x y z  nx ny nz  red green blue  radius  class_idx  instance_idx  [+faces]

Writer byte layout (msh_ply__write_header, lib/msh/msh_ply.h:1868-1911):

    ply\\n
    format binary_little_endian 1.0\\n
    element vertex N\\n
    property float x ...            (one line per property)
    element face M\\n               (only when faces present)
    property list uchar int vertex_indices\\n
    end_header\\n
    <interleaved little-endian vertex records><face records>

This module is a fresh numpy implementation: vectorized structured-dtype
reads/writes, a general header parser for foreign PLYs (ascii +
binary_little_endian, arbitrary property sets), and the reference's
missing-field synthesis semantics (rs_pointcloud__load_ply,
lib/rs/rs_pointcloud.h:716-776).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "char": np.int8, "int8": np.int8,
    "uchar": np.uint8, "uint8": np.uint8,
    "short": np.int16, "int16": np.int16,
    "ushort": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
}


@dataclasses.dataclass
class PlyProperty:
    name: str
    dtype: type
    list_count_dtype: Optional[type] = None  # set for list properties


@dataclasses.dataclass
class PlyElement:
    name: str
    count: int
    properties: List[PlyProperty]


@dataclasses.dataclass
class PlyData:
    """Raw parsed PLY: per-element dict of property-name -> ndarray."""

    elements: Dict[str, Dict[str, np.ndarray]]
    counts: Dict[str, int]


def _parse_header(f) -> Tuple[str, List[PlyElement], int]:
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[PlyElement] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", "replace").split()
        if not tokens:
            continue
        cmd = tokens[0]
        if cmd == "format":
            fmt = tokens[1]
        elif cmd == "comment" or cmd == "obj_info":
            continue
        elif cmd == "element":
            elements.append(PlyElement(tokens[1], int(tokens[2]), []))
        elif cmd == "property":
            if tokens[1] == "list":
                prop = PlyProperty(tokens[4], _PLY_TYPES[tokens[3]], _PLY_TYPES[tokens[2]])
            else:
                prop = PlyProperty(tokens[2], _PLY_TYPES[tokens[1]])
            elements[-1].properties.append(prop)
        elif cmd == "end_header":
            break
    if fmt not in ("binary_little_endian", "ascii"):
        raise ValueError(f"unsupported PLY format: {fmt}")
    return fmt, elements, f.tell()


def read_ply(path: str) -> PlyData:
    """Parse a PLY file into per-element property arrays."""
    with open(path, "rb") as f:
        fmt, elements, _ = _parse_header(f)
        out: Dict[str, Dict[str, np.ndarray]] = {}
        counts: Dict[str, int] = {}
        for el in elements:
            has_list = any(p.list_count_dtype is not None for p in el.properties)
            counts[el.name] = el.count
            if fmt == "binary_little_endian":
                if not has_list:
                    dt = np.dtype([(p.name, np.dtype(p.dtype).newbyteorder("<"))
                                   for p in el.properties])
                    raw = np.frombuffer(f.read(dt.itemsize * el.count), dtype=dt,
                                        count=el.count)
                    out[el.name] = {p.name: np.ascontiguousarray(raw[p.name])
                                    for p in el.properties}
                else:
                    out[el.name] = _read_binary_list_element(f, el)
            else:
                out[el.name] = _read_ascii_element(f, el)
        return PlyData(out, counts)


def _read_binary_list_element(f, el: PlyElement) -> Dict[str, np.ndarray]:
    # Fast path: single list property with uniform count (triangle faces).
    if len(el.properties) == 1 and el.properties[0].list_count_dtype is not None:
        p = el.properties[0]
        start = f.tell()
        cnt_dt = np.dtype(p.list_count_dtype).newbyteorder("<")
        val_dt = np.dtype(p.dtype).newbyteorder("<")
        if el.count == 0:
            return {p.name: np.zeros((0,), dtype=p.dtype)}
        first_cnt = int(np.frombuffer(f.read(cnt_dt.itemsize), dtype=cnt_dt)[0])
        f.seek(start)
        rec = np.dtype([("n", cnt_dt), ("v", val_dt, (first_cnt,))])
        raw = np.frombuffer(f.read(rec.itemsize * el.count), dtype=rec, count=el.count)
        if not np.all(raw["n"] == first_cnt):
            raise ValueError("non-uniform list counts unsupported in fast path")
        return {p.name: np.ascontiguousarray(raw["v"])}
    # General slow path.
    arrays: Dict[str, List] = {p.name: [] for p in el.properties}
    for _ in range(el.count):
        for p in el.properties:
            if p.list_count_dtype is None:
                dt = np.dtype(p.dtype).newbyteorder("<")
                arrays[p.name].append(np.frombuffer(f.read(dt.itemsize), dtype=dt)[0])
            else:
                cdt = np.dtype(p.list_count_dtype).newbyteorder("<")
                n = int(np.frombuffer(f.read(cdt.itemsize), dtype=cdt)[0])
                vdt = np.dtype(p.dtype).newbyteorder("<")
                arrays[p.name].append(np.frombuffer(f.read(vdt.itemsize * n), dtype=vdt))
    return {k: np.asarray(v) for k, v in arrays.items()}


def _read_ascii_element(f, el: PlyElement) -> Dict[str, np.ndarray]:
    has_list = any(p.list_count_dtype is not None for p in el.properties)
    rows = [f.readline().split() for _ in range(el.count)]
    if not has_list:
        mat = np.array(rows, dtype=np.float64)
        return {p.name: mat[:, i].astype(p.dtype)
                for i, p in enumerate(el.properties)}
    arrays: Dict[str, List] = {p.name: [] for p in el.properties}
    for row in rows:
        i = 0
        for p in el.properties:
            if p.list_count_dtype is None:
                arrays[p.name].append(np.dtype(p.dtype).type(float(row[i])))
                i += 1
            else:
                n = int(row[i]); i += 1
                arrays[p.name].append(np.array(row[i:i + n], dtype=p.dtype))
                i += n
    return {k: np.asarray(v) for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# Surfel-cloud load/save with the reference's field semantics.
# ---------------------------------------------------------------------------

SURFEL_FIELDS = ("positions", "normals", "colors", "radii", "qualities",
                 "class_ids", "instance_ids")


def load_surfel_ply(path: str) -> Dict[str, np.ndarray]:
    """Load a PLY into surfel arrays with the reference's defaults.

    Mirrors rs_pointcloud__load_ply (lib/rs/rs_pointcloud.h:598-781):
    missing normals synthesized from faces, radius default 0.01, class /
    instance default 0, colors default 0.5, qualities 1.0; normals
    normalized with NaN -> zero vector.
    Returns dict with positions/normals/colors (float32 [N,3]),
    radii/qualities (float32 [N]), class_ids/instance_ids (int32 [N]) and
    faces (int32 [M,3], possibly empty).
    """
    data = read_ply(path)
    v = data.elements.get("vertex")
    if v is None:
        raise ValueError(f"{path}: PLY has no 'vertex' element")
    n = data.counts["vertex"]
    out: Dict[str, np.ndarray] = {}
    pos = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    out["positions"] = pos

    faces = np.zeros((0, 3), dtype=np.int32)
    if "face" in data.elements and "vertex_indices" in data.elements["face"]:
        fi = data.elements["face"]["vertex_indices"]
        faces = np.asarray(fi, dtype=np.int32).reshape(-1, 3)
    out["faces"] = faces

    if all(k in v for k in ("nx", "ny", "nz")):
        nrm = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    elif len(faces):
        nrm = compute_vertex_normals(pos, faces)
    else:
        nrm = np.zeros((n, 3), dtype=np.float32)
    # normalize; NaN -> zeros (rs_pointcloud.h:744-752). Multiply by the f32
    # reciprocal sqrt exactly as msh_vec3_normalize (msh_vec_math.h:868-872)
    # so saved normals are bit-identical to the reference's.
    out["normals"] = normalize_f32(nrm)

    if all(k in v for k in ("red", "green", "blue")):
        col = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float32) / 255.0
    else:
        col = np.full((n, 3), 0.5, dtype=np.float32)
    out["colors"] = col.astype(np.float32)

    out["radii"] = (v["radius"].astype(np.float32) if "radius" in v
                    else np.full(n, 0.01, dtype=np.float32))
    out["class_ids"] = (v["class_idx"].astype(np.int32) if "class_idx" in v
                        else np.zeros(n, dtype=np.int32))
    out["instance_ids"] = (v["instance_idx"].astype(np.int32) if "instance_idx" in v
                           else np.zeros(n, dtype=np.int32))
    out["qualities"] = np.ones(n, dtype=np.float32)
    return out


def normalize_f32(v: np.ndarray) -> np.ndarray:
    """Row-normalize exactly like msh_vec3_normalize
    (msh_vec_math.h:868-872): multiply by f32 1/sqrt(x^2+y^2+z^2);
    non-finite rows become zero (rs_pointcloud.h:747-751)."""
    v = np.asarray(v, dtype=np.float32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        s = ((v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2])
        denom = (np.float32(1.0) / np.sqrt(s, dtype=np.float32)).astype(np.float32)
        out = v * denom[:, None]
    out[~np.isfinite(out).all(axis=1)] = 0.0
    return out.astype(np.float32)


def compute_vertex_normals(pos: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Vertex normals = mean of adjacent unnormalized face normals.

    The reference blends each face normal into its vertices with
    lerp(n, fn, 1/(count+1)) in face order (rs_pointcloud.h:568-584), which
    is exactly a running arithmetic mean — computed here vectorized.
    Zero-norm vertices get +Y (rs_pointcloud.h:588-590).
    """
    p1 = pos[faces[:, 0]]
    fn = np.cross(pos[faces[:, 1]] - p1, pos[faces[:, 2]] - p1)
    acc = np.zeros_like(pos, dtype=np.float64)
    cnt = np.zeros(len(pos), dtype=np.int64)
    for k in range(3):
        np.add.at(acc, faces[:, k], fn)
        np.add.at(cnt, faces[:, k], 1)
    acc /= np.maximum(cnt, 1)[:, None]
    norms = np.linalg.norm(acc, axis=1)
    out = np.where(norms[:, None] > 0.0, acc / np.maximum(norms, 1e-30)[:, None],
                   np.array([0.0, 1.0, 0.0]))
    return out.astype(np.float32)


def save_surfel_ply(path: str, cloud: Dict[str, np.ndarray],
                    faces: Optional[np.ndarray] = None) -> None:
    """Write the fixed surfel field set byte-identically to
    rs_pointcloud__save_ply (lib/rs/rs_pointcloud.h:783-836)."""
    pos = np.asarray(cloud["positions"], dtype=np.float32)
    n = len(pos)
    nrm = np.asarray(cloud["normals"], dtype=np.float32)
    col = np.clip(np.asarray(cloud["colors"], dtype=np.float32) * 255.0, 0, 255).astype(np.uint8)
    rad = np.asarray(cloud["radii"], dtype=np.float32)
    cls = np.asarray(cloud["class_ids"], dtype=np.int32)
    ins = np.asarray(cloud["instance_ids"], dtype=np.int32)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for name in ("x", "y", "z", "nx", "ny", "nz"):
        header.append(f"property float {name}")
    for name in ("red", "green", "blue"):
        header.append(f"property uchar {name}")
    header.append("property float radius")
    header.append("property int class_idx")
    header.append("property int instance_idx")
    if faces is not None and len(faces):
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    rec = np.dtype([("pos", "<f4", (3,)), ("nrm", "<f4", (3,)), ("col", "u1", (3,)),
                    ("rad", "<f4"), ("cls", "<i4"), ("ins", "<i4")])
    buf = np.empty(n, dtype=rec)
    buf["pos"] = pos
    buf["nrm"] = nrm
    buf["col"] = col
    buf["rad"] = rad
    buf["cls"] = cls
    buf["ins"] = ins

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(buf.tobytes())
        if faces is not None and len(faces):
            frec = np.dtype([("n", "u1"), ("v", "<i4", (3,))])
            fbuf = np.empty(len(faces), dtype=frec)
            fbuf["n"] = 3
            fbuf["v"] = np.asarray(faces, dtype=np.int32)
            f.write(fbuf.tobytes())
