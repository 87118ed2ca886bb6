"""``.rsdb`` temporal-database text format, pose-proposal ``.bin`` codec,
and arrangement ``.bin`` codec — byte-compatible with the reference.

Text format commands (parser: lib/rs/rs_database.h:428-441, writer:
:532-611):

    rsdb <major>.<minor>
    model_folder <path>
    class <name> <idx>
    scene <uidx> <arrangement_idx> <scn_filename> <pp_filename|none> [<prp>]
    object <filename> <uidx> <class_idx>
    shape_prior <filename> <uidx> <class_idx>
    n_arrangements <n>
    pose <uidx> <arrangement_idx> <object_idx> <score> <16 floats row-major>

Pose-proposal binary (writer: apps/pose_proposal/main.cpp:61-89, reader:
apps/segment_transfer/main.cpp:143-193):

    int32 n_arrays; int32 counts[n_arrays];
    then per array: n x (16 float column-major pose + 1 float score)

Note the asymmetry: the text format stores poses ROW-major
(rs_database.h:601-606), the binary stores them COLUMN-major
(main.cpp:84 writes &pose.col[0].x). Matrices in memory are plain
(4,4) row-major numpy arrays mapping points as ``M @ [x,y,z,1]``.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RsObject:
    """One object model (rs_object_t, lib/rs/rs_database.h:69-76)."""
    uidx: int
    filename: str
    class_idx: int
    is_shape_prior: bool = False
    cloud: Optional[object] = None  # core.pointcloud.PointCloud, attached lazily


@dataclasses.dataclass
class Placement:
    """An object placement in an arrangement (rs_obj_plcmnt_t,
    lib/rs/rs_database.h:78-86). ``pose`` is (4,4) float."""
    uidx: int
    arrangement_idx: int
    object_idx: int
    pose_idx: int
    pose: np.ndarray
    score: float


@dataclasses.dataclass
class RsScene:
    """One scan (rs_scene_t, lib/rs/rs_database.h:88-96)."""
    uidx: int
    arrangement_idx: int
    scn_filename: str
    pose_proposal_filename: Optional[str] = None
    cloud: Optional[object] = None


@dataclasses.dataclass
class Rsdb:
    """The temporal model container (rsdb_t, lib/rs/rs_database.h:98-117).

    ``class_table`` preserves insertion order (the reference's hashtable
    iterates items in insertion order, so serialization order matches).
    """
    version: Tuple[int, int] = (1, 0)
    model_folder: Optional[str] = None
    class_table: Dict[str, int] = dataclasses.field(default_factory=dict)
    scenes: List[RsScene] = dataclasses.field(default_factory=list)
    objects: List[RsObject] = dataclasses.field(default_factory=list)
    arrangements: List[List[Placement]] = dataclasses.field(default_factory=list)
    proposed_poses: List[Optional[List[np.ndarray]]] = dataclasses.field(default_factory=list)
    proposed_scores: List[Optional[List[np.ndarray]]] = dataclasses.field(default_factory=list)

    # -- class helpers (rs_database.h:234-255) --
    def class_idx(self, name: str) -> int:
        return self.class_table.get(name, -1)

    def class_name(self, idx: int) -> Optional[str]:
        for k, v in self.class_table.items():
            if v == idx:
                return k
        return None

    def is_class_static(self, class_idx: int) -> bool:
        """Static-class predicate (rs_database.h:257-288). The reference
        caches per-name indices from the first db queried; we use the
        intended semantics: lookup in this db's class table. Memoized per
        class_idx — the SA inner loop queries this ~10 times per iteration
        (class tables never shrink, so hits stay valid)."""
        cache = self.__dict__.setdefault("_static_cache", {})
        hit = cache.get(class_idx)
        if hit is not None:
            return hit
        from .. import config
        out = False
        for name in config.STATIC_CLASS_NAMES:
            idx = self.class_table.get(name, -1)
            if idx >= 0 and class_idx == idx:
                out = True
                break
        cache[class_idx] = out
        return out

    def is_object_static(self, obj_idx: int) -> bool:
        return self.is_class_static(self.objects[obj_idx].class_idx)

    def find_object(self, uidx: int) -> Optional[RsObject]:
        for o in self.objects:
            if o.uidx == uidx:
                return o
        return None

    def add_object(self, obj: RsObject) -> int:
        """rsdb_add_object (rs_database.h:647-658): dedup by uidx.
        NOTE the reference returns the existing object's *uidx* on dup and
        the new *index* otherwise; callers only use the fresh-add path, so
        we return the index in both cases."""
        for i, o in enumerate(self.objects):
            if o.uidx == obj.uidx:
                return i
        self.objects.append(obj)
        return len(self.objects) - 1

    def max_dynamic_uidx(self) -> int:
        """rsao__find_max_uidx (arrangement_optimization.cpp:404-422)."""
        max_uidx = 0
        for arr in self.arrangements:
            for p in arr:
                if not self.is_object_static(p.object_idx) and p.uidx > max_uidx:
                    max_uidx = p.uidx
        return max_uidx


# ---------------------------------------------------------------------------
# Text .rsdb
# ---------------------------------------------------------------------------

def load_rsdb(path: str) -> Rsdb:
    """Parse a .rsdb text file (rsdb_load, lib/rs/rs_database.h:443-470).

    Pointcloud attachment is done separately by core.database.load_database.
    """
    db = Rsdb()
    with open(path, "r") as f:
        for line_no, line in enumerate(f, 1):
            tokens = line.split()
            if not tokens:
                continue
            cmd = tokens[0]
            if cmd == "rsdb":
                major, minor = tokens[1].split(".")
                db.version = (int(major), int(minor))
            elif cmd == "model_folder":
                db.model_folder = tokens[1]
            elif cmd == "class":
                db.class_table[tokens[1]] = int(tokens[2])
            elif cmd in ("object", "shape_prior"):
                db.objects.append(RsObject(
                    uidx=int(tokens[2]), filename=tokens[1],
                    class_idx=int(tokens[3]), is_shape_prior=(cmd == "shape_prior")))
            elif cmd == "scene":
                pp = None if tokens[4] == "none" else tokens[4]
                db.scenes.append(RsScene(
                    uidx=int(tokens[1]), arrangement_idx=int(tokens[2]),
                    scn_filename=tokens[3], pose_proposal_filename=pp))
                # each scene cmd appends arrangement + proposal slots
                # (rs_database.h:420-423)
                db.arrangements.append([])
                db.proposed_poses.append(None)
                db.proposed_scores.append(None)
            elif cmd == "n_arrangements":
                n = int(tokens[1])
                # the n_arrangements cmd RESETS the arrangement list to n
                # empty arrangements (rs_database.h:350-366); in files written
                # by rsdb_save it appears after all scene commands
                if n > 0:
                    db.arrangements = [[] for _ in range(n)]
            elif cmd == "pose":
                # tokens: pose uidx arr_idx obj_idx score m00..m33 (row-major)
                uidx, arr_idx, obj_idx = int(tokens[1]), int(tokens[2]), int(tokens[3])
                score = float(tokens[4])
                mat = np.array([float(t) for t in tokens[5:21]],
                               dtype=np.float32).reshape(4, 4)
                # validate: the reference indexes out of bounds when a
                # hand-written file orders commands oddly or declares
                # n_arrangements < #scenes (rs_database.h parser fragility,
                # VERDICT r1); fail with context instead
                if arr_idx >= len(db.arrangements):
                    raise ValueError(
                        f"{path}:{line_no}: pose references arrangement "
                        f"{arr_idx} but only {len(db.arrangements)} are "
                        "declared (check n_arrangements / scene command "
                        "order)")
                db.arrangements[arr_idx].append(
                    Placement(uidx, arr_idx, obj_idx, 0, mat, score))
            else:
                print(f"Unrecognized command at line {line_no} : {line.rstrip()}")
    return db


def _fmt_f(x: float) -> str:
    """C printf %f formatting (6 decimal places)."""
    return "%f" % x


def save_rsdb(path: str, db: Rsdb, save_objects: bool = True) -> None:
    """Serialize to .rsdb text (rsdb_save, lib/rs/rs_database.h:532-611).

    Sets model_folder from the output filename (strip extension) and, when
    ``save_objects``, writes every object cloud as a binary PLY into it.
    """
    from . import paths, ply

    db.model_folder = paths.model_folder_name(path)
    if save_objects:
        os.makedirs(db.model_folder, exist_ok=True)

    lines = [f"rsdb {db.version[0]}.{db.version[1]}",
             f"model_folder {db.model_folder}"]
    for name, idx in db.class_table.items():
        lines.append(f"class {name} {idx}")
    for s in db.scenes:
        pp = s.pose_proposal_filename if s.pose_proposal_filename else "none"
        # trailing space matches the reference's empty prp field
        # (rs_database.h:568-570)
        lines.append(f"scene {s.uidx} {s.arrangement_idx} {s.scn_filename} {pp} ")
    for o in db.objects:
        kind = "shape_prior" if o.is_shape_prior else "object"
        lines.append(f"{kind} {o.filename} {o.uidx} {o.class_idx}")
    lines.append(f"n_arrangements {len(db.arrangements)}")
    for i, arr in enumerate(db.arrangements):
        for p in arr:
            m = np.asarray(p.pose, dtype=np.float32)
            # pose line: 3 spaces after score, 2 spaces between 4-float rows
            # (rs_database.h:601-606)
            mat_str = "  ".join(" ".join(_fmt_f(float(m[r, c])) for c in range(4))
                                for r in range(4))
            lines.append(f"pose {p.uidx} {i} {p.object_idx} {_fmt_f(p.score)}   "
                         + mat_str)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")

    if save_objects:
        for o in db.objects:
            if o.cloud is None:
                continue
            out = os.path.join(db.model_folder, o.filename)
            print(f"Writing: {out}")
            o.cloud.save_ply(out, level=0)


# ---------------------------------------------------------------------------
# Pose-proposal binary
# ---------------------------------------------------------------------------

def save_pose_proposals(path: str, poses: List[np.ndarray],
                        scores: List[np.ndarray]) -> None:
    """Write the pose-proposal .bin (apps/pose_proposal/main.cpp:61-89).

    ``poses[i]`` is (K_i, 4, 4), ``scores[i]`` is (K_i,). Written poses are
    column-major float32 as in the reference (pose.col[0].x first).
    """
    with open(path, "wb") as f:
        n = len(poses)
        f.write(struct.pack("<i", n))
        for i in range(n):
            f.write(struct.pack("<i", len(poses[i])))
        for i in range(n):
            k = len(poses[i])
            if k == 0:
                continue
            rec = np.empty((k, 17), dtype="<f4")
            # transpose -> column-major flattening of our row-major mats
            rec[:, :16] = np.transpose(np.asarray(poses[i], dtype=np.float32),
                                       (0, 2, 1)).reshape(k, 16)
            rec[:, 16] = np.asarray(scores[i], dtype=np.float32)
            f.write(rec.tobytes())


def load_pose_proposals(path: str) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Read the pose-proposal .bin (apps/segment_transfer/main.cpp:143-193).

    Returns (poses, scores): per object, a list of (4,4) float32 poses
    (best-first) and a matching (k,) float32 score array."""
    with open(path, "rb") as f:
        n = struct.unpack("<i", f.read(4))[0]
        counts = np.frombuffer(f.read(4 * n), dtype="<i4", count=n)
        poses, scores = [], []
        for k in counts:
            k = int(k)
            if k == 0:
                poses.append(np.zeros((0, 4, 4), dtype=np.float32))
                scores.append(np.zeros((0,), dtype=np.float32))
                continue
            rec = np.frombuffer(f.read(4 * 17 * k), dtype="<f4",
                                count=17 * k).reshape(k, 17)
            mats = np.transpose(rec[:, :16].reshape(k, 4, 4), (0, 2, 1))
            poses.append(np.ascontiguousarray(mats))
            scores.append(np.ascontiguousarray(rec[:, 16]))
        return poses, scores


# ---------------------------------------------------------------------------
# Arrangement binary (apps/segment_transfer/main.cpp:81-141)
# ---------------------------------------------------------------------------

_PLCMNT_REC = np.dtype([("uidx", "<i4"), ("arrangement_idx", "<i4"),
                        ("object_idx", "<i4"), ("pose_idx", "<i4"),
                        ("pose", "<f4", (16,)), ("score", "<f4")])


def save_arrangement(path: str, arrangement: List[Placement]) -> None:
    buf = np.empty(len(arrangement), dtype=_PLCMNT_REC)
    for i, p in enumerate(arrangement):
        buf[i]["uidx"] = p.uidx
        buf[i]["arrangement_idx"] = p.arrangement_idx
        buf[i]["object_idx"] = p.object_idx
        buf[i]["pose_idx"] = p.pose_idx
        buf[i]["pose"] = np.asarray(p.pose, dtype=np.float32).T.reshape(16)
        buf[i]["score"] = p.score
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(arrangement)))
        f.write(buf.tobytes())


def load_arrangement(path: str) -> List[Placement]:
    with open(path, "rb") as f:
        n = struct.unpack("<i", f.read(4))[0]
        buf = np.frombuffer(f.read(n * _PLCMNT_REC.itemsize), dtype=_PLCMNT_REC,
                            count=n)
    return [Placement(int(r["uidx"]), int(r["arrangement_idx"]),
                      int(r["object_idx"]), int(r["pose_idx"]),
                      np.ascontiguousarray(r["pose"].reshape(4, 4).T),
                      float(r["score"])) for r in buf]
