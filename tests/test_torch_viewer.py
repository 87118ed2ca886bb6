"""The port's viewer (rescan_tpu_torch/viewer/) and distance field
(rescan_tpu_torch/ops/distance_field.py) against the JAX package's, CPU
on both sides, at 160x120 on the small room's database: its first scan
through the port's seg2rsdb, with seeded pose proposals attached.

The contract: the distance field bit for bit; renders byte for byte
without EDL; with EDL and with the float64 colour maps (score mode, the
distance-field slice), at most 0.1 % of pixels off, by one level (libm
rounding before the uint8 truncation). Measured here: 0 pixels off in
every case.

The reference splats points in ``np.argsort(-z)`` order, a quicksort
that orders equal depths arbitrarily; the port sorts stably. Equal-depth
points do land on one pixel in these fixtures: a placement at the
identity pose puts an object's points exactly on the scene's, and in
score mode the two carry different colours (``test_equal_depth_ties``).
So the comparisons pin the reference module's ``np.argsort`` to a stable
sort; the test below shows that every pixel where the unpinned reference
differs is such a tie.
"""

import contextlib
import functools
import io
import os
import sys

import numpy as np
import pytest
import torch

from rescan_tpu.core import database as jdb
from rescan_tpu.io import rsdb as jrs
from rescan_tpu.ops import distance_field as jdf
from rescan_tpu.viewer import cli as jcli
from rescan_tpu.viewer import render as J
import rescan_tpu_torch
from rescan_tpu_torch import sequences
from rescan_tpu_torch.core import database as tdb
from rescan_tpu_torch.io import rsdb as trs
from rescan_tpu_torch.ops import distance_field as tdf
from rescan_tpu_torch.pipeline import seg2rsdb
from rescan_tpu_torch.viewer import cli as tcli
from rescan_tpu_torch.viewer import render as T

W, H = 160, 120
RSDB = os.path.join(sequences.SEQ_NAME, "scan_000.rsdb")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's many small CPU ops stall on their own threads when it is
    oversubscribed (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StableNumpy:
    """numpy, with argsort stable."""

    argsort = staticmethod(functools.partial(np.argsort, kind="stable"))

    def __getattr__(self, name):
        return getattr(np, name)


@pytest.fixture
def stable_reference(monkeypatch):
    monkeypatch.setattr(J, "np", _StableNumpy())


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """The small room's first scan as a database (chair, table, walls,
    floor; the arrangement seg2rsdb writes), with 6 seeded proposals per
    object, one of them the identity, the rest moved and turned about y,
    in a pose-proposal file the scene names."""
    root = str(tmp_path_factory.mktemp("room"))
    class_file = sequences.write_small_sequence(root)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            seg2rsdb.run(os.path.join(sequences.SEQ_NAME, "gt_segmentation",
                                      "scan_000.ply"), class_file, RSDB)
        db = trs.load_rsdb(RSDB)
        rng = np.random.default_rng(3)
        poses, scores = [], []
        for _ in db.objects:
            P = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
            a = rng.uniform(-0.4, 0.4, 5)
            P[1:, 0, 0] = P[1:, 2, 2] = np.cos(a)
            P[1:, 0, 2] = np.sin(a)
            P[1:, 2, 0] = -np.sin(a)
            P[1:, 0, 3] = rng.uniform(-0.2, 0.2, 5)
            P[1:, 2, 3] = rng.uniform(-0.2, 0.2, 5)
            poses.append(P)
            scores.append(rng.uniform(0.0, 1.0, 6).astype(np.float32))
        pp = os.path.join(sequences.SEQ_NAME, "scan_000_pp.bin")
        trs.save_pose_proposals(pp, poses, scores)
        db.scenes[0].pose_proposal_filename = pp
        trs.save_rsdb(RSDB, db, save_objects=False)
    finally:
        os.chdir(cwd)
    return root


def _load(root, database, rsdbio):
    """The room as the viewer CLI loads it, proposals included."""
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            db = database.load_database(RSDB, load_pointclouds=True)
        for i, s in enumerate(db.scenes):
            if s.pose_proposal_filename:
                p, sc = rsdbio.load_pose_proposals(s.pose_proposal_filename)
                db.proposed_poses[i] = p
                db.proposed_scores[i] = sc
    finally:
        os.chdir(cwd)
    return db


@pytest.fixture(scope="module")
def dbs(room):
    """(JAX-package database, port database) of the room."""
    return _load(room, jdb, jrs), _load(room, tdb, trs)


def _off(a, b):
    """(pixels that differ, the largest difference in levels)."""
    a = np.asarray(a).astype(np.int64)
    b = np.asarray(b).astype(np.int64)
    assert a.shape == b.shape
    d = np.abs(a - b).max(axis=-1) if a.ndim == 3 else np.abs(a - b)
    return int((d > 0).sum()), int(d.max(initial=0))


def _within_contract(a, b):
    """At most 0.1 % of pixels off, by one level."""
    n, lvl = _off(a, b)
    assert lvl <= 1 and n <= 0.001 * a.shape[0] * a.shape[1], (n, lvl)
    return n


def _view(pts):
    lo, hi = pts.min(0), pts.max(0)
    c = (lo + hi) / 2
    return J.look_at(c + np.array([0.65, 0.9, 0.75]) *
                     float(np.linalg.norm(hi - lo)), c)


def test_distance_field_bit_identical(dbs):
    """The chamfer field of the scene's level-2 points (the viewer's
    slice) and of a random cloud: dist and lookups equal bit for bit."""
    rng = np.random.default_rng(5)
    clouds = [dbs[1].scenes[0].cloud.pos(2),
              rng.uniform(-1.0, 1.0, (3000, 3)).astype(np.float32)]
    for pts, voxel, max_dist in zip(clouds, (0.05, 0.07), (0.5, 0.3)):
        a = jdf.build_distance_field(pts, voxel=voxel, max_dist=max_dist)
        b = tdf.build_distance_field(pts, voxel=voxel, max_dist=max_dist,
                                     device="cpu")
        assert np.array_equal(a.origin, b.origin)
        assert np.array_equal(a.dist.view(np.int32),
                              b.dist.numpy().view(np.int32))
        assert (a.dist == 0).any() and (a.dist > 0.1).any()
        q = rng.uniform(-2.0, 3.0, (5000, 3)).astype(np.float32)
        la, lb = a.lookup(q), b.lookup(q).numpy()
        assert np.isinf(la).any() and np.array_equal(la, lb)


@pytest.mark.parametrize("point_px,surfels,uint8", [
    (1, False, False), (2, False, True), (3, False, False),
    (2, True, False)])
def test_render_points_matches_jax(dbs, stable_reference, point_px,
                                   surfels, uint8):
    """Scene points with seeded colours, shading normals, fixed and
    projected surfel sizes, part of the cloud behind the camera: equal
    images, and z-buffers within 2 ulp (the reference's camera transform
    is a BLAS product with FMAs, the port's plain f64 multiply-adds; no
    pixel moves)."""
    L = dbs[1].scenes[0].cloud.levels[1]
    pts = L["positions"]
    rng = np.random.default_rng(point_px)
    cols = rng.uniform(0, 1, (len(pts), 3))
    if uint8:
        cols = (cols * 255).astype(np.uint8)
    view = _view(pts)
    view[:3, 3] += [0.0, 0.0, -2.0]               # part behind the camera
    kw = dict(width=W, height=H, point_px=point_px,
              shade_normals=L["normals"],
              radii=L["radii"] if surfels else None, return_zbuf=True)
    a, za = J.render_points(pts, cols, view, **kw)
    b, zb = T.render_points(pts, cols, view, device="cpu", **kw)
    assert _off(a, b) == (0, 0)
    np.testing.assert_allclose(zb.numpy(), za, rtol=4.5e-16, atol=0)
    assert np.isinf(za).any() and np.isfinite(za).sum() > 1000


def test_apply_edl_within_contract(dbs, stable_reference):
    """EDL on the same image and z-buffer: float64 log/exp, so within
    the contract (measured: 0 pixels off)."""
    L = dbs[1].scenes[0].cloud.levels[1]
    img, z = J.render_points(L["positions"], L["colors"], _view(
        L["positions"]), W, H, return_zbuf=True)
    for strength in (0.5, 1.0, 3.0):
        a = J.apply_edl(img, z, strength)
        b = T.apply_edl(torch.from_numpy(img), torch.from_numpy(z), strength)
        assert _within_contract(a, b.numpy()) == 0
        assert _off(a, img)[0] > 100              # the shading bites


def test_draw_segments_matches_jax(dbs, stable_reference):
    """Grid, axes and posed boxes (2 px), depth-tested against the
    splats, some segments crossing behind the camera: equal images."""
    L = dbs[1].scenes[0].cloud.levels[1]
    pts = L["positions"]
    view = _view(pts)
    img, z = J.render_points(pts, L["colors"], view, W, H, return_zbuf=True)
    lo, hi = pts.min(0), pts.max(0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.2, 0.0, 0.1]
    eye = np.linalg.inv(view)[:3, 3]
    cases = [(J.grid_segments(lo, hi, y=float(lo[1])),
              np.full((12, 3), 90, np.uint8), 1),
             (*J.axes_segments(lo, 0.5), 2),
             (J.bbox_segments(lo, (lo + hi) / 2, pose),
              np.array([[0.2, 0.5, 0.9]]), 2),
             (np.array([[eye + [0.0, 0.0, 0.01], lo], [eye - 1.0, hi]]),
              np.array([[255, 0, 0], [0, 255, 0]], np.uint8), 1)]
    a, b = img.copy(), torch.from_numpy(img.copy())
    for segs, cols, px in cases:
        J.draw_segments(a, z, view, segs, cols, px=px)
        T.draw_segments(b, torch.from_numpy(z), view, segs, cols, px=px)
        assert _off(a, b.numpy()) == (0, 0)
    assert _off(a, img)[0] > 50


_MODES = [dict(mode=m) for m in ("rgb", "class", "instance", "normal",
                                 "score")]
_MODES += [dict(mode=m, placement_mode=p) for m in ("instance", "score")
           for p in ("proposals", "identity")]
_MODES += [dict(mode="class", surfels=True, edl_strength=1.0),
           dict(mode="normal", surfels=True),
           dict(mode="score", placement_mode="proposals", show_bboxes=True,
                show_grid=True, show_axes=True, max_proposals=3),
           dict(mode="instance", show_bboxes=True, show_grid=True,
                show_axes=True),
           dict(mode="instance", df_slice_y=0.3),
           dict(mode="class", show_placements=False, level=2),
           dict(mode="rgb", camera_eye=(0.8, 2.5, 3.0),
                camera_target=(0.8, 0.2, 0.8))]


@pytest.mark.parametrize("kw", _MODES,
                         ids=[",".join(f"{k}={v}" for k, v in m.items())
                              for m in _MODES])
def test_render_rsdb_matches_jax(dbs, stable_reference, kw):
    """Every colour and placement mode and overlay: byte-identical
    images without EDL and colour maps; with them within the contract
    (measured: 0 pixels off)."""
    a = J.render_rsdb(dbs[0], width=W, height=H, **kw)
    b = T.render_rsdb(dbs[1], width=W, height=H, device="cpu", **kw).numpy()
    if kw.get("edl_strength") or kw["mode"] == "score" or \
            "df_slice_y" in kw:
        assert _within_contract(a, b) == 0
    else:
        assert _off(a, b) == (0, 0)
    assert len(np.unique(a.reshape(-1, 3), axis=0)) > 5


def test_equal_depth_ties(dbs):
    """Score mode at the identity placement: the scene's points in grey
    and the objects' points, exactly on them, in score colours. Drawing
    the same points in reverse order flips every equal-depth tie, so the
    pixels where the two renders differ are the ties that matter; the
    unpinned reference (quicksort) differs from the port only there.
    Measured at 160x120: 3,243 tie pixels, 1,584 of them off in the
    unpinned reference (numpy 2.0.2)."""
    db = dbs[1]
    L = db.scenes[0].cloud.levels[1]
    objs = [o.cloud.levels[1] for o in db.objects if o.cloud is not None]
    pts = np.concatenate([L["positions"]] + [o["positions"] for o in objs])
    cols = np.concatenate(
        [np.full((len(L["positions"]), 3), 0.55)] +
        [np.tile([0.9, 0.1, 0.1 * k], (len(o["positions"]), 1))
         for k, o in enumerate(objs)])
    view = _view(pts)
    port = T.render_points(pts, cols, view, W, H, device="cpu").numpy()
    flipped = T.render_points(pts[::-1].copy(), cols[::-1].copy(), view, W,
                              H, device="cpu").numpy()
    ties = np.abs(port.astype(int) - flipped).max(-1) > 0
    assert ties.sum() > 100
    ref = J.render_points(pts, cols, view, W, H)
    off = np.abs(port.astype(int) - ref).max(-1) > 0
    assert off.any() and not (off & ~ties).any()


def _cli_args(room, out, extra):
    return [os.path.join(room, RSDB), "--output", out,
            "--resolution", str(W), str(H)] + extra


@pytest.mark.parametrize("extra", [
    ["--mode", "instance"],
    ["--mode", "class", "--placement_mode", "proposals", "--show_bboxes",
     "--show_grid", "--show_axes", "--df_slice_y", "0.3"],
])
def test_cli_png_bytes(room, stable_reference, tmp_path, monkeypatch, extra):
    """The rsdb_viewer argv (the port's with --device cpu): the same PNG
    bytes and the same stdout, with paths relative to the room."""
    monkeypatch.chdir(room)
    got = []
    for main, dev in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{len(dev)}.png")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(_cli_args(room, out, extra + dev)) == 0
        with open(out, "rb") as f:
            got.append((f.read(), buf.getvalue().replace(out, "OUT")))
    assert got[0] == got[1]
    assert got[0][0].startswith(b"\x89PNG")


def test_cli_interactive_keys(room, stable_reference, tmp_path, monkeypatch):
    """The headless key loop, keys read line-wise from stdin: every key
    of the help re-renders; the same PNGs (numbered screenshots
    included) and the same stdout."""
    monkeypatch.chdir(room)
    keys = "cnevarbp0hljk-+?sxq\n"
    got = []
    for main, dev in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        d = tmp_path / str(len(dev))
        d.mkdir()
        out = str(d / "shot.png")
        buf = io.StringIO()
        monkeypatch.setattr(sys, "stdin", io.StringIO(keys))
        with contextlib.redirect_stdout(buf):
            assert main(_cli_args(room, out, ["--interactive"] + dev)) == 0
        files = {}
        for name in sorted(os.listdir(d)):
            with open(d / name, "rb") as f:
                files[name] = f.read()
        got.append((files, buf.getvalue().replace(str(d), "D")))
    assert got[0] == got[1]
    assert sorted(got[0][0]) == ["shot.png", "shot_001.png"]
    assert got[0][1].count("VIEWER: ") == 17    # 1 + 15 keys + the shot


def test_entry_points_without_card_raise(room, dbs, tmp_path, monkeypatch):
    """No device named means CUDA: without a card the renderer, the
    distance field and the CLI raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(room)
    pts = dbs[1].scenes[0].cloud.pos(2)
    for fn in (lambda: T.render_rsdb(dbs[1], width=W, height=H),
               lambda: T.render_points(pts, np.zeros_like(pts), np.eye(4)),
               lambda: T.diverging_colors(np.zeros(3)),
               lambda: tdf.build_distance_field(pts),
               lambda: tcli.main(_cli_args(room, str(tmp_path / "x.png"),
                                           []))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def test_cpu_calls_counted(dbs):
    """A render on CPU tensors counts its device work in CPU_CALLS."""
    rescan_tpu_torch.CPU_CALLS.clear()
    T.render_rsdb(dbs[1], width=W, height=H, device="cpu", mode="score",
                  show_grid=True, df_slice_y=0.3)
    assert set(rescan_tpu_torch.CPU_CALLS) == {
        "render.render_points", "render.draw_segments",
        "render.diverging_colors", "distance_field.build_distance_field",
        "distance_field.lookup"}
    rescan_tpu_torch.CPU_CALLS.clear()
