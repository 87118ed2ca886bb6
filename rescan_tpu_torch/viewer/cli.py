"""rsdb_viewer — scripted-screenshot CLI (headless), the port of
rescan_tpu/viewer/cli.py; renders on the card unless ``--device cpu``.

Mirrors the reference viewer's scripted screenshot mode
(apps/rsdb_viewer/main.cpp:496-503, :1020-1028):

    python -m rescan_tpu_torch.viewer.cli <rsdb> [--output out.png]
        [--mode rgb|class|instance] [--level N] [--resolution W H]
        [--camera ex ey ez tx ty tz] [--scene_idx I] [--no_placements]
        [--placement_mode optimized|proposals|identity] [--device D]
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import resolve_device
from ..core import database
from . import render


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rsdb_viewer",
                                 description="Headless rsdb screenshot tool")
    ap.add_argument("rsdb_filename")
    ap.add_argument("--output", "-o", default="screenshot.png")
    ap.add_argument("--mode",
                    choices=("rgb", "class", "instance", "normal", "score"),
                    default="instance")
    ap.add_argument("--interactive", action="store_true",
                    help="keyboard-driven re-render loop (the reference "
                         "viewer's shortcut surface, headless: each "
                         "keystroke re-renders the output PNG)")
    ap.add_argument("--level", type=int, default=1)
    ap.add_argument("--resolution", nargs=2, type=int, default=(1024, 768))
    ap.add_argument("--camera", nargs=6, type=float, default=None,
                    help="eye xyz + target xyz")
    ap.add_argument("--scene_idx", type=int, default=-1)
    ap.add_argument("--no_placements", action="store_true")
    ap.add_argument("--placement_mode",
                    choices=("optimized", "proposals", "identity"),
                    default="optimized")
    ap.add_argument("--max_proposals", type=int, default=8,
                    help="proposals per object in proposals mode")
    ap.add_argument("--show_bboxes", action="store_true",
                    help="wireframe bbox per drawn placement (debugvis)")
    ap.add_argument("--show_grid", action="store_true",
                    help="floor grid overlay (debugvis)")
    ap.add_argument("--show_axes", action="store_true",
                    help="world axes overlay (debugvis)")
    ap.add_argument("--df_slice_y", type=float, default=None,
                    help="render a scene distance-field slice at height Y")
    ap.add_argument("--surfels", action="store_true",
                    help="splat points at their projected surfel radius")
    ap.add_argument("--edl", type=float, default=0.0, metavar="STRENGTH",
                    help="Eye-Dome Lighting strength (0 = off)")
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu or cuda:1 (default: cuda)")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)

    db = database.load_database(args.rsdb_filename, load_pointclouds=True)
    if args.placement_mode == "proposals" or args.mode == "score":
        # the reference viewer loads the proposal .bin alongside the rsdb
        # (apps/rsdb_viewer/main.cpp:647-661)
        from ..io import rsdb as rsdbio
        for i, s in enumerate(db.scenes):
            if s.pose_proposal_filename:
                p, sc = rsdbio.load_pose_proposals(s.pose_proposal_filename)
                db.proposed_poses[i] = p
                db.proposed_scores[i] = sc
    cam_eye = cam_tgt = None
    if args.camera:
        cam_eye, cam_tgt = args.camera[:3], args.camera[3:]
    if args.interactive:
        return interactive_loop(db, args, cam_eye, cam_tgt)
    img = render.render_rsdb(
        db, scene_idx=args.scene_idx, mode=args.mode, level=args.level,
        width=args.resolution[0], height=args.resolution[1],
        camera_eye=cam_eye, camera_target=cam_tgt,
        show_placements=not args.no_placements,
        placement_mode=args.placement_mode,
        max_proposals=args.max_proposals,
        show_bboxes=args.show_bboxes, show_grid=args.show_grid,
        show_axes=args.show_axes, df_slice_y=args.df_slice_y,
        surfels=args.surfels, edl_strength=args.edl, device=args.device)
    render.write_png(args.output, img)
    print(f"VIEWER: wrote {args.output} "
          f"({args.resolution[0]}x{args.resolution[1]}, mode={args.mode})")
    return 0


_COLOR_MODES = ("rgb", "class", "instance", "normal", "score")
_PLACEMENT_MODES = ("optimized", "proposals", "identity")

_INTERACTIVE_HELP = """\
VIEWER keys (reference shortcut surface, apps/rsdb_viewer/main.cpp:378-400
+ cloudvis.h:273-297 + debugvis.h:162-175; headless: every key re-renders
the PNG):
  c  cycle color mode (rgb/class/instance/normal/score)   [cldvis 'C']
  n  toggle normal-color mode                             [cldvis 'N']
  e  toggle Eye-Dome Lighting                             [cldvis 'E']
  v  cycle shader mode (points <-> surfel splats)         [cldvis 'V']
  a  toggle world axes                                    [dbgvis 'A']
  r  toggle floor grid                                    [dbgvis 'R']
  b  toggle placement bboxes
  p  cycle placement mode (optimized/proposals/identity)
  0  reset camera                                         [main 'NUM_0']
  s  save numbered screenshot                             [main 'S']
  h/l  orbit left/right   j/k  orbit down/up   -/+  zoom  (arcball subst.)
  ?  this help            q  quit
"""


def _read_keys():
    """Yield single keypresses (cbreak when stdin is a tty; otherwise
    consume characters line-wise so the loop is scriptable/testable)."""
    import contextlib

    if sys.stdin.isatty():
        import termios
        import tty

        @contextlib.contextmanager
        def cbreak():
            fd = sys.stdin.fileno()
            old = termios.tcgetattr(fd)
            try:
                tty.setcbreak(fd)
                yield
            finally:
                termios.tcsetattr(fd, termios.TCSADRAIN, old)

        with cbreak():
            while True:
                ch = sys.stdin.read(1)
                if not ch:
                    return
                yield ch
    else:
        for line in sys.stdin:
            for ch in line.strip():
                yield ch


def interactive_loop(db, args, cam_eye, cam_tgt) -> int:
    """Headless stand-in for the reference viewer's interactive window:
    the same keyboard shortcut set, but each keystroke re-renders the
    output PNG instead of swapping a GL framebuffer (this host has no
    display). The mouse arcball is substituted with orbit/zoom keys."""
    import numpy as np

    from . import render as r

    state = {
        "mode": args.mode, "edl": args.edl or 0.0, "surfels": args.surfels,
        "axes": args.show_axes, "grid": args.show_grid,
        "bboxes": args.show_bboxes, "placement_mode": args.placement_mode,
        "shot": 0,
    }
    scene = db.scenes[args.scene_idx].cloud
    bmin, bmax = scene.bbox
    center = (np.asarray(bmin) + np.asarray(bmax)) / 2.0
    diag = float(np.linalg.norm(np.asarray(bmax) - np.asarray(bmin)))
    home_eye = (np.asarray(cam_eye, np.float64) if cam_eye is not None
                else center + np.array([0.65, 0.9, 0.75]) * diag)
    target = (np.asarray(cam_tgt, np.float64) if cam_tgt is not None
              else center.astype(np.float64))
    eye = home_eye.copy()

    def orbit(yaw=0.0, pitch=0.0, zoom=1.0):
        v = eye - target
        rad = np.linalg.norm(v) * zoom
        el = np.arcsin(np.clip(v[1] / max(np.linalg.norm(v), 1e-9), -1, 1))
        az = np.arctan2(v[2], v[0])
        az += yaw
        el = np.clip(el + pitch, -1.45, 1.45)
        eye[:] = target + rad * np.array([
            np.cos(el) * np.cos(az), np.sin(el), np.cos(el) * np.sin(az)])

    def draw(path=None):
        img = r.render_rsdb(
            db, scene_idx=args.scene_idx, mode=state["mode"],
            level=args.level, width=args.resolution[0],
            height=args.resolution[1], camera_eye=eye, camera_target=target,
            show_placements=not args.no_placements,
            placement_mode=state["placement_mode"],
            max_proposals=args.max_proposals, show_bboxes=state["bboxes"],
            show_grid=state["grid"], show_axes=state["axes"],
            df_slice_y=args.df_slice_y, surfels=state["surfels"],
            edl_strength=state["edl"], device=args.device)
        r.write_png(path or args.output, img)
        print(f"VIEWER: {path or args.output} mode={state['mode']} "
              f"placements={state['placement_mode']} "
              f"edl={'on' if state['edl'] else 'off'} "
              f"{'surfels' if state['surfels'] else 'points'}")

    print(_INTERACTIVE_HELP)
    draw()
    step = np.pi / 12
    for ch in _read_keys():
        if ch == "q":
            break
        elif ch == "c":
            i = _COLOR_MODES.index(state["mode"])
            state["mode"] = _COLOR_MODES[(i + 1) % len(_COLOR_MODES)]
        elif ch == "n":
            state["mode"] = ("normal" if state["mode"] != "normal"
                             else args.mode)
        elif ch == "e":
            state["edl"] = 0.0 if state["edl"] else 1.0
        elif ch == "v":
            state["surfels"] = not state["surfels"]
        elif ch == "a":
            state["axes"] = not state["axes"]
        elif ch == "r":
            state["grid"] = not state["grid"]
        elif ch == "b":
            state["bboxes"] = not state["bboxes"]
        elif ch == "p":
            i = _PLACEMENT_MODES.index(state["placement_mode"])
            state["placement_mode"] = \
                _PLACEMENT_MODES[(i + 1) % len(_PLACEMENT_MODES)]
        elif ch == "0":
            eye[:] = home_eye
        elif ch == "s":
            state["shot"] += 1
            base, ext = os.path.splitext(args.output)
            draw(f"{base}_{state['shot']:03d}{ext or '.png'}")
            continue
        elif ch == "h":
            orbit(yaw=-step)
        elif ch == "l":
            orbit(yaw=step)
        elif ch == "j":
            orbit(pitch=-step)
        elif ch == "k":
            orbit(pitch=step)
        elif ch == "-":
            orbit(zoom=1.25)
        elif ch in "+=":
            orbit(zoom=0.8)
        elif ch == "?":
            print(_INTERACTIVE_HELP)
            continue
        else:
            continue
        draw()
    return 0


if __name__ == "__main__":
    sys.exit(main())
