"""Rooms and rescans made from a seed: the benchmark's inputs.

A frozen copy of the port's scene generator (``utils/synthetic.py``: the
floor, four walls and box furniture as one labelled triangle mesh, with
the NYU40 class table and the ground-truth instance ids 0 floor, 1 walls,
3 + k object k), with the room itself read from a configuration file,
and the general generator of a traffic mix's moves. Nothing here imports
the program: the reference reads the same specs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

NYU40_CLASSES = [
    "unlabelled", "wall", "floor", "cabinet", "bed", "chair", "sofa", "table",
    "door", "window", "bookshelf", "picture", "counter", "blinds", "desk",
    "shelves", "curtain", "dresser", "pillow", "mirror", "floor_mat",
    "clothes", "ceiling", "books", "refridgerator", "television", "paper",
    "towel", "shower_curtain", "box", "whiteboard", "person", "night_stand",
    "toilet", "sink", "lamp", "bathtub", "bag", "otherstructure",
    "otherfurniture", "otherprop",
]
FLOOR_ID, WALL_ID, FIRST_OBJECT_ID = 0, 1, 3


@dataclasses.dataclass(frozen=True)
class Box:
    """A piece of furniture: a box standing on the floor, turned by
    ``rot`` radians about the vertical through its centre."""
    cls: str
    center: Tuple[float, float]        # x, z
    size: Tuple[float, float, float]   # x, y (height), z before turning
    rot: float


@dataclasses.dataclass(frozen=True)
class Room:
    size: Tuple[float, float]          # x, z
    wall_height: float
    objects: Tuple[Box, ...]

    def moved(self, k: int, center, rot) -> "Room":
        objs = list(self.objects)
        objs[k] = dataclasses.replace(objs[k], center=tuple(center), rot=rot)
        return dataclasses.replace(self, objects=tuple(objs))


def room_of(config: dict) -> Room:
    r = config["room"]
    return Room(tuple(r["size_m"]), float(r["wall_height_m"]), tuple(
        Box(o["class"], tuple(o["center_xz_m"]), tuple(o["size_m"]),
            float(o["rot_rad"])) for o in r["objects"]))


def twin_groups(room: Room) -> Dict[int, int]:
    """Ground-truth instance id -> the smallest id of its twins (objects of
    one class and size, which a rescan may swap)."""
    first: Dict[tuple, int] = {}
    out = {FLOOR_ID: FLOOR_ID, WALL_ID: WALL_ID}
    for k, b in enumerate(room.objects):
        out[FIRST_OBJECT_ID + k] = first.setdefault((b.cls, b.size),
                                                    FIRST_OBJECT_ID + k)
    return out


# --- the mesh (a frozen copy of utils/synthetic.py's) ----------------------

def _grid_plane(origin, du, dv, nu, nv):
    origin = np.asarray(origin, dtype=np.float32)
    du = np.asarray(du, dtype=np.float32)
    dv = np.asarray(dv, dtype=np.float32)
    us, vs = np.meshgrid(np.arange(nu + 1), np.arange(nv + 1), indexing="ij")
    verts = (origin[None, :] + us.reshape(-1, 1) * du[None, :]
             + vs.reshape(-1, 1) * dv[None, :])
    idx = np.arange((nu + 1) * (nv + 1)).reshape(nu + 1, nv + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[:-1, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)], 0)
    return verts.astype(np.float32), faces.astype(np.int32)


def _box(center, size, res):
    cx, cy, cz = center
    sx, sy, sz = size
    o = np.array([cx - sx / 2, cy - sy / 2, cz - sz / 2], dtype=np.float32)
    verts_all, faces_all = [], []
    quads = [
        (o, [sx, 0, 0], [0, sy, 0]),
        (o + [0, 0, sz], [0, sy, 0], [sx, 0, 0]),
        (o, [0, 0, sz], [sx, 0, 0]),
        (o + [0, sy, 0], [sx, 0, 0], [0, 0, sz]),
        (o, [0, sy, 0], [0, 0, sz]),
        (o + [sx, 0, 0], [0, 0, sz], [0, sy, 0]),
    ]
    n = 0
    for origin, du, dv in quads:
        v, f = _grid_plane(np.asarray(origin, np.float32),
                           np.asarray(du, np.float32) / res,
                           np.asarray(dv, np.float32) / res, res, res)
        verts_all.append(v)
        faces_all.append(f + n)
        n += len(v)
    return np.concatenate(verts_all), np.concatenate(faces_all)


def vertex_normals(pos: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Mean of the adjacent unnormalised face normals, +y where zero."""
    p1 = pos[faces[:, 0]]
    fn = np.cross(pos[faces[:, 1]] - p1, pos[faces[:, 2]] - p1)
    acc = np.zeros_like(pos, dtype=np.float64)
    cnt = np.zeros(len(pos), dtype=np.int64)
    for k in range(3):
        np.add.at(acc, faces[:, k], fn)
        np.add.at(cnt, faces[:, k], 1)
    acc /= np.maximum(cnt, 1)[:, None]
    norms = np.linalg.norm(acc, axis=1)
    out = np.where(norms[:, None] > 0.0,
                   acc / np.maximum(norms, 1e-30)[:, None],
                   np.array([0.0, 1.0, 0.0]))
    return out.astype(np.float32)


def scene_mesh(room: Room, resolution: int) -> Dict[str, np.ndarray]:
    """The labelled room mesh: positions, normals, faces, class and
    instance ids per vertex, colours, radii."""
    w, d = room.size
    h = room.wall_height
    parts = []
    fv, ff = _grid_plane([0, 0, 0], [0, 0, d / resolution],
                         [w / resolution, 0, 0], resolution, resolution)
    parts.append((fv, ff, "floor", FLOOR_ID))
    wall_res = max(resolution // 2, 2)
    for o, du, dv in (([0, 0, 0], [w, 0, 0], [0, h, 0]),
                      ([0, 0, d], [w, 0, 0], [0, h, 0]),
                      ([0, 0, 0], [0, 0, d], [0, h, 0]),
                      ([w, 0, 0], [0, 0, d], [0, h, 0])):
        vv, vf = _grid_plane(np.asarray(o, np.float32),
                             np.asarray(du, np.float32) / wall_res,
                             np.asarray(dv, np.float32) / wall_res,
                             wall_res, wall_res)
        parts.append((vv, vf, "wall", WALL_ID))
    for k, b in enumerate(room.objects):
        bv, bf = _box((0.0, b.size[1] / 2, 0.0), b.size,
                      max(resolution // 6, 2))
        c, s = np.cos(b.rot), np.sin(b.rot)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)
        bv = bv @ R.T + np.array([b.center[0], 0.0, b.center[1]],
                                 dtype=np.float32)
        parts.append((bv, bf, b.cls, FIRST_OBJECT_ID + k))
    verts, faces, classes, instances = [], [], [], []
    n = 0
    for vv, vf, cls, inst in parts:
        verts.append(vv)
        faces.append(vf + n)
        classes.append(np.full(len(vv), NYU40_CLASSES.index(cls), np.int32))
        instances.append(np.full(len(vv), inst, np.int32))
        n += len(vv)
    verts = np.concatenate(verts)
    faces = np.concatenate(faces)
    classes = np.concatenate(classes)
    return {
        "positions": verts,
        "normals": vertex_normals(verts, faces),
        "faces": faces,
        "class_ids": classes,
        "instance_ids": np.concatenate(instances),
        "colors": (0.2 + 0.6 * (classes[:, None] % np.array([3, 5, 7]))
                   / np.array([3, 5, 7])).astype(np.float32),
        "radii": np.full(len(verts), 0.01, np.float32),
    }


def write_ply(path: str, mesh: Dict[str, np.ndarray]) -> int:
    """The mesh as the pipeline's binary surfel PLY; returns its bytes."""
    n = len(mesh["positions"])
    faces = mesh["faces"]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {k}" for k in ("x", "y", "z", "nx", "ny", "nz")]
    header += [f"property uchar {k}" for k in ("red", "green", "blue")]
    header += ["property float radius", "property int class_idx",
               "property int instance_idx", f"element face {len(faces)}",
               "property list uchar int vertex_indices", "end_header"]
    rec = np.dtype([("pos", "<f4", (3,)), ("nrm", "<f4", (3,)),
                    ("col", "u1", (3,)), ("rad", "<f4"), ("cls", "<i4"),
                    ("ins", "<i4")])
    buf = np.empty(n, dtype=rec)
    buf["pos"] = mesh["positions"]
    buf["nrm"] = mesh["normals"]
    buf["col"] = np.clip(mesh["colors"] * 255.0, 0, 255).astype(np.uint8)
    buf["rad"] = mesh["radii"]
    buf["cls"] = mesh["class_ids"]
    buf["ins"] = mesh["instance_ids"]
    fbuf = np.empty(len(faces), dtype=np.dtype([("n", "u1"),
                                                ("v", "<i4", (3,))]))
    fbuf["n"] = 3
    fbuf["v"] = faces
    data = ("\n".join(header) + "\n").encode("ascii") + buf.tobytes() \
        + fbuf.tobytes()
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def write_class_file(path: str) -> None:
    with open(path, "w") as f:
        for idx, name in enumerate(NYU40_CLASSES):
            f.write(f"class {name} {idx}\n")


# --- the traffic: what moves between scans ---------------------------------

def footprint(b: Box, grow: float = 0.0) -> np.ndarray:
    """The box's four floor corners (x, z), its half sizes grown by
    ``grow``."""
    hx, hz = b.size[0] / 2 + grow, b.size[2] / 2 + grow
    c, s = math.cos(b.rot), math.sin(b.rot)
    # the mesh turns (x, z) by [[c, s], [-s, c]]
    corners = np.array([[-hx, -hz], [hx, -hz], [hx, hz], [-hx, hz]])
    return corners @ np.array([[c, -s], [s, c]]) + np.asarray(b.center)


def _overlap(a: np.ndarray, b: np.ndarray) -> bool:
    """Whether two convex quadrilaterals intersect (separating axes)."""
    for poly in (a, b):
        for i in range(4):
            e = poly[(i + 1) % 4] - poly[i]
            axis = np.array([-e[1], e[0]])
            pa, pb = a @ axis, b @ axis
            if pa.max() < pb.min() or pb.max() < pa.min():
                return False
    return True


def fits(room: Room, k: int, clearance: float) -> bool:
    """Object k lies inside the room and off every other footprint, each
    by ``clearance``."""
    fp = footprint(room.objects[k], clearance)
    if fp.min() < 0.0 or (fp[:, 0].max() > room.size[0]
                          or fp[:, 1].max() > room.size[1]):
        return False
    return not any(_overlap(fp, footprint(b)) for j, b in
                   enumerate(room.objects) if j != k)


def draw_rescan(room: Room, mix: dict, rng: np.random.Generator) -> Room:
    """The room after one rescan's moves: ``mix["moves"]`` objects of the
    movable classes, each moved by a distance in ``distance_m`` in a
    random direction and turned by an angle in ``turn_deg`` either way.
    A draw that leaves the room or meets another footprint is drawn
    again."""
    movable = [k for k, b in enumerate(room.objects)
               if not mix.get("classes") or b.cls in mix["classes"]]
    chosen = rng.choice(movable, size=mix["moves"], replace=False)
    lo, hi = mix["distance_m"]
    tlo, thi = mix["turn_deg"]
    for k in sorted(int(c) for c in chosen):
        b = room.objects[k]
        for _ in range(10000):
            dist = rng.uniform(lo, hi)
            head = rng.uniform(0.0, 2 * math.pi)
            turn = math.radians(rng.uniform(tlo, thi)) * rng.choice([-1, 1])
            cand = room.moved(k, (b.center[0] + dist * math.cos(head),
                                  b.center[1] + dist * math.sin(head)),
                              b.rot + turn)
            if fits(cand, k, mix["clearance_m"]):
                room = cand
                break
        else:
            raise RuntimeError(f"no room to move object {k}")
    return room


def draw_pool(room: Room, traffic: dict, seed: int) -> List[Room]:
    """The window's pool of rescans of ``room``, in the order the window
    takes them.

    The moves come from the mix's own ``pool_seed``, so every run does the
    same work; ``seed`` draws the order in which the window takes the
    pool."""
    rng = np.random.default_rng(traffic["pool_seed"])
    pool = [draw_rescan(room, traffic["mix"], rng)
            for _ in range(traffic["pool"])]
    order = np.random.default_rng(seed % (1 << 64)).permutation(len(pool))
    return [pool[int(k)] for k in order]
