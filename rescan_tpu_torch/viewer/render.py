"""Offline surfel renderer — the port of rescan_tpu/viewer/render.py, the
framework's rsdb inspection tool.

The reference ships an OpenGL/GLFW viewer (apps/rsdb_viewer/main.cpp)
whose pipeline role is scripted screenshots for visual debugging
(main.cpp:496-503, :1020-1028; vis modes proposals/optimized/identity
:81). This is a headless z-buffer point-splat renderer on the device:
projection, shading, the splat, Eye-Dome Lighting, overlays and the
distance-field slice are torch ops; PNG output is a dependency-free host
encoder. It renders the same things the reference viewer shows — scenes
and placed objects colored by RGB / class / instance / normal / score —
with the NYU40 palette, and the same images as the JAX package's
renderer:

* the splat is one scatter: each pixel keeps the write with the largest
  key (offset pass, far-to-near rank), so a later (dy, dx) pass
  overwrites an earlier one whatever its depth, offsets are clipped onto
  the border, and the z-buffer holds the last-written z, as the
  reference's pass loop does. Points are ranked by a stable sort of -z;
  the reference's quicksort orders equal depths arbitrarily;
* f32 object transforms are the reference's BLAS products, a chain of
  correctly rounded f32 FMAs in index order;
* every division by a constant divides by a device tensor: a CUDA
  tensor divided by a Python scalar is multiplied by its reciprocal.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import count_if_cpu, resolve_device
from ..ops.distance_field import build_distance_field
from ..ops.gnn import _fma32

# NYU40 color palette (scripts/util.py create_color_palette)
NYU40_PALETTE = np.array([
    (0, 0, 0), (174, 199, 232), (152, 223, 138), (31, 119, 180),
    (255, 187, 120), (188, 189, 34), (140, 86, 75), (255, 152, 150),
    (214, 39, 40), (197, 176, 213), (148, 103, 189), (196, 156, 148),
    (23, 190, 207), (178, 76, 76), (247, 182, 210), (66, 188, 102),
    (219, 219, 141), (140, 57, 197), (202, 185, 52), (51, 176, 203),
    (200, 54, 131), (92, 193, 61), (78, 71, 183), (172, 114, 82),
    (255, 127, 14), (91, 163, 138), (153, 98, 156), (140, 153, 101),
    (158, 218, 229), (100, 125, 154), (178, 127, 135), (120, 185, 128),
    (146, 111, 194), (44, 160, 44), (112, 128, 144), (96, 207, 209),
    (227, 119, 194), (213, 92, 176), (94, 106, 211), (82, 84, 163),
    (100, 85, 144)], dtype=np.uint8)


def _device(x, device) -> torch.device:
    """``device`` when named, else the tensor's own, else the default
    (cuda, raising without a card)."""
    if device is not None or not isinstance(x, torch.Tensor):
        return resolve_device(device)
    return x.device


def _t(x, dev, dtype=None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev) if dtype is None else x.to(dev, dtype)


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as a true division in x's dtype (s rounded to it, as numpy
    rounds a Python scalar)."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def _affine(p: torch.Tensor, M: np.ndarray, t=None) -> torch.Tensor:
    """p @ M.T (+ t) over the last axis of 3, each output a sum of
    products in index order."""
    cols = []
    for i in range(M.shape[0]):
        c = (p[..., 0] * float(M[i, 0]) + p[..., 1] * float(M[i, 1])) \
            + p[..., 2] * float(M[i, 2])
        cols.append(c if t is None else c + float(t[i]))
    return torch.stack(cols, dim=-1)


def _affine32(p: torch.Tensor, pose: np.ndarray, translate: bool
              ) -> torch.Tensor:
    """f32 ``p @ pose[:3, :3].T (+ pose[:3, 3])`` as the reference's BLAS
    computes it: fma(p2, R[i,2], fma(p1, R[i,1], p0 * R[i,0]))."""
    R = torch.from_numpy(np.asarray(pose, np.float32)[:3, :3].copy()
                         ).to(p.device)
    out = _fma32(p[:, 2:3], R[:, 2], _fma32(p[:, 1:2], R[:, 1],
                                            p[:, 0:1] * R[:, 0]))
    if translate:
        out = out + torch.from_numpy(np.asarray(pose, np.float32)[:3, 3]
                                     .copy()).to(p.device)
    return out


# ---------------------------------------------------------------------------
# Diverging colormap (score visualization)
#
# The reference bakes a cool-warm table (lib/rs/diverging_map.inl); here the
# same Moreland smooth cool-warm map is COMPUTED: sRGB -> CIELAB -> Msh,
# linear interpolation in Msh with a white control point at the midpoint
# (Moreland, "Diverging Color Maps for Scientific Visualization", 2009).
# The endpoints' Msh are host numpy on 3-vectors; the per-value map runs
# on the device in float64.
# ---------------------------------------------------------------------------

def _srgb_to_msh(rgb):
    rgb = np.asarray(rgb, np.float64)
    lin = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                   rgb / 12.92)
    M = np.array([[0.4124, 0.3576, 0.1805],
                  [0.2126, 0.7152, 0.0722],
                  [0.0193, 0.1192, 0.9505]])
    xyz = lin @ M.T
    white = np.array([0.95047, 1.0, 1.08883])
    r = xyz / white

    def f(t):
        return np.where(t > 0.008856, np.cbrt(t), 7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(r[..., 0]), f(r[..., 1]), f(r[..., 2])
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    Mm = np.sqrt(L * L + a * a + b * b)
    s = np.where(Mm > 1e-9, np.arccos(np.clip(L / np.maximum(Mm, 1e-9),
                                              -1, 1)), 0.0)
    h = np.arctan2(b, a)
    return np.stack([Mm, s, h], axis=-1)


def _msh_to_srgb(msh: torch.Tensor) -> torch.Tensor:
    Mm, s, h = msh[..., 0], msh[..., 1], msh[..., 2]
    L = Mm * torch.cos(s)
    a = Mm * torch.sin(s) * torch.cos(h)
    b = Mm * torch.sin(s) * torch.sin(h)
    fy = _div(L + 16.0, 116.0)
    fx = fy + _div(a, 500.0)
    fz = fy - _div(b, 200.0)

    def finv(t):
        t3 = t ** 3
        return torch.where(t3 > 0.008856, t3, _div(t - 16.0 / 116.0, 7.787))

    white = torch.tensor([0.95047, 1.0, 1.08883], dtype=torch.float64,
                         device=msh.device)
    xyz = torch.stack([finv(fx), finv(fy), finv(fz)], dim=-1) * white
    Minv = np.array([[3.2406, -1.5372, -0.4986],
                     [-0.9689, 1.8758, 0.0415],
                     [0.0557, -0.2040, 1.0570]])
    lin = _affine(xyz, Minv).clamp(0.0, 1.0)
    return torch.where(lin > 0.0031308,
                       1.055 * lin ** (1.0 / 2.4) - 0.055, 12.92 * lin)


def diverging_colors(t, low=(0.230, 0.299, 0.754),
                     high=(0.706, 0.016, 0.150), device=None) -> torch.Tensor:
    """Cool-warm diverging colors for t in [0, 1]; (..., 3) float64 in
    [0, 1] on ``t``'s device (or ``device``)."""
    dev = _device(t, device)
    count_if_cpu("render.diverging_colors", dev)
    t = _t(t, dev, torch.float64).clamp(0.0, 1.0)
    m_low = _srgb_to_msh(np.asarray(low))
    m_high = _srgb_to_msh(np.asarray(high))
    m_white = max(m_low[0], m_high[0], 88.0)

    def adjust_hue(sat_msh, m_unsat):
        Mm, s, h = sat_msh
        if Mm >= m_unsat - 0.1 or s < 0.05:
            return h
        spin = s * np.sqrt(m_unsat ** 2 - Mm ** 2) / (Mm * np.sin(s))
        return h + (spin if h > -np.pi / 3.0 else -spin)

    left = t < 0.5
    ti = torch.where(left, 2.0 * t, 2.0 * t - 1.0)
    # each half interpolates toward/from white with the hue carried from
    # that half's SATURATED endpoint (spin-adjusted), so hue stays stable
    lo = torch.tensor(m_low, dtype=torch.float64, device=dev)
    hi = torch.tensor(m_high, dtype=torch.float64, device=dev)
    w_hi = torch.tensor([m_white, 0.0, adjust_hue(m_high, m_white)],
                        dtype=torch.float64, device=dev)
    w_lo = torch.tensor([m_white, 0.0, adjust_hue(m_low, m_white)],
                        dtype=torch.float64, device=dev)
    a = torch.where(left[..., None], lo, w_hi)
    b = torch.where(left[..., None], w_lo, hi)
    msh = a + ti[..., None] * (b - a)
    return _msh_to_srgb(msh)


def write_png(path: str, image) -> None:
    """Minimal RGB8 PNG writer (no external deps)."""
    if isinstance(image, torch.Tensor):
        image = image.cpu().numpy()
    h, w, _ = image.shape
    raw = b"".join(b"\x00" + image[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = r, u, -f
    view[:3, 3] = -view[:3, :3] @ eye
    return view


def _to_u8(col: torch.Tensor) -> torch.Tensor:
    """[0,1] float colours as uint8 (clip, then truncation); uint8 as is."""
    if col.dtype == torch.uint8:
        return col
    return (col * 255.0).clamp(0, 255).to(torch.uint8)


def render_points(points, colors, view: np.ndarray, width: int = 1024,
                  height: int = 768, fov_deg: float = 55.0, point_px: int = 2,
                  bg: Tuple[int, int, int] = (20, 20, 24),
                  shade_normals=None, radii=None, edl_strength: float = 0.0,
                  return_zbuf: bool = False, device=None):
    """Z-buffered point splatting on ``points``' device (or ``device``).
    colors in [0,1] float or uint8. Returns an (H, W, 3) uint8 tensor.

    ``radii``: per-point world radii — splat size becomes the PROJECTED
    surfel size (clipped to [1, 6] px), the headless counterpart of the
    reference's geometry-shader surfels (lib/rs/cloudvis.h:4-20).
    ``edl_strength`` > 0 applies Eye-Dome Lighting: a screen-space depth
    shading pass (cloudvis EDL mode) on the finished z-buffer.
    With return_zbuf, returns (img, zbuf) so overlays can depth-test."""
    dev = _device(points, device)
    count_if_cpu("render.render_points", dev)
    p = _t(points, dev, torch.float64)
    cam = _affine(p, view[:3, :3], view[:3, 3])
    z = -cam[:, 2]
    vis = z > 1e-4
    cam, z = cam[vis], z[vis]
    col = _to_u8(_t(colors, dev)[vis])
    if shade_normals is not None:
        n = _t(shade_normals, dev, torch.float64)[vis]
        light = np.array([0.4, 0.8, 0.45])
        light /= np.linalg.norm(light)
        lum = 0.55 + 0.45 * _affine(n, light[None, :])[:, 0].abs()
        col = (col.double() * lum[:, None]).clamp(0, 255).to(torch.uint8)

    focal = 0.5 * height / np.tan(np.deg2rad(fov_deg) * 0.5)
    x = (cam[:, 0] / z) * focal + width * 0.5
    y = -(cam[:, 1] / z) * focal + height * 0.5
    xi = torch.round(x).long()
    yi = torch.round(y).long()
    inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    if radii is not None:
        r = _t(radii, dev, torch.float64)[vis]
        size = torch.round(2.0 * r * focal / z).clamp(1, 6).long()[inb]
    else:
        size = torch.full((int(inb.sum()),), point_px, dtype=torch.int64,
                          device=dev)
    xi, yi, z, col = xi[inb], yi[inb], z[inb], col[inb]

    # far to near, so the nearest is written last
    order = torch.sort(-z, stable=True).indices
    xi, yi, z, col, size = (xi[order], yi[order], z[order], col[order],
                            size[order])
    m = len(z)
    smax = int(size.max()) if m else 1
    offs = torch.arange(-(smax // 2), smax - smax // 2, device=dev)
    nd = len(offs)
    lo = -(size // 2)
    hi = size + lo
    inside = (offs[:, None] >= lo[None, :]) & (offs[:, None] < hi[None, :])
    iy, ix, k = torch.nonzero(inside[:, None, :] & inside[None, :, :],
                              as_tuple=True)
    yy = (yi[k] + offs[iy]).clamp(0, height - 1)
    xx = (xi[k] + offs[ix]).clamp(0, width - 1)
    key = (iy * nd + ix) * m + k
    win = torch.full((height * width,), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, yy * width + xx, key, "amax")
    hit = win >= 0
    top = torch.remainder(win[hit], max(m, 1))
    img = torch.tensor(bg, dtype=torch.uint8, device=dev).repeat(
        height * width, 1)
    img[hit] = col[top]
    zbuf = torch.full((height * width,), float("inf"), dtype=torch.float64,
                      device=dev)
    zbuf[hit] = z[top]
    img = img.view(height, width, 3)
    zbuf = zbuf.view(height, width)
    if edl_strength > 0.0:
        img = apply_edl(img, zbuf, strength=edl_strength)
    if return_zbuf:
        return img, zbuf
    return img


def apply_edl(img: torch.Tensor, zbuf: torch.Tensor,
              strength: float = 1.0) -> torch.Tensor:
    """Eye-Dome Lighting: darken pixels whose neighbors are closer to the
    eye (screen-space log-depth gradient), the shading the reference's GL
    viewer applies to point clouds (cloudvis.h EDL shader). float64 on
    the image's device."""
    count_if_cpu("render.apply_edl", img.device)
    have = torch.isfinite(zbuf)
    logz = torch.where(have, torch.log(zbuf.clamp_min(1e-6)), 0.0)
    acc = torch.zeros_like(logz)
    cnt = torch.zeros_like(logz)
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0),
                   (1, 1), (1, -1), (-1, 1), (-1, -1)):
        nz = torch.roll(torch.roll(logz, dy, 0), dx, 1)
        nh = torch.roll(torch.roll(have, dy, 0), dx, 1)
        acc += torch.where(nh, (logz - nz).clamp_min(0.0), 0.0)
        cnt += nh
    resp = acc / cnt.clamp_min(1)
    shade = torch.exp((-strength * 80.0) * resp)
    out = img.double() * torch.where(have, shade, 1.0)[..., None]
    return out.clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Debug overlays (the headless counterpart of lib/rs/debugvis.h:4-9 —
# thick lines, grids, axes, proposal bboxes)
# ---------------------------------------------------------------------------

def draw_segments(img: torch.Tensor, zbuf: torch.Tensor, view: np.ndarray,
                  segments, colors, fov_deg: float = 55.0,
                  z_bias: float = 0.01, px: int = 1) -> None:
    """Depth-tested world-space line segments drawn into ``img`` in place.

    segments: (S, 2, 3) endpoints; colors: (S, 3) uint8 or [0,1] float.
    Each segment is sampled at ~pixel density (np.linspace's samples),
    samples z-tested against the point splats' z-buffer (which they do not
    write) with a small bias so lines sitting ON geometry win; where
    samples share a pixel, the last one (by px pass, then segment, then
    sample) is drawn.
    """
    dev = img.device
    count_if_cpu("render.draw_segments", dev)
    height, width, _ = img.shape
    segments = np.asarray(segments, np.float64).reshape(-1, 2, 3)
    colors = np.asarray(colors)
    if colors.dtype != np.uint8:
        colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    focal = 0.5 * height / np.tan(np.deg2rad(fov_deg) * 0.5)

    def project(p):
        cam = _affine(p, view[:3, :3], view[:3, 3])
        z = -cam[:, 2]
        zc = z.clamp_min(1e-6)
        x = (cam[:, 0] / zc) * focal + width * 0.5
        y = -(cam[:, 1] / zc) * focal + height * 0.5
        return x, y, z

    S = len(segments)
    if S == 0:
        return
    seg = _t(segments, dev)
    ax, ay, _ = project(seg[:, 0])
    bx, by, _ = project(seg[:, 1])
    # sample counts at ~1 px spacing (camera-clipped segments kept coarse)
    n_samp = (torch.hypot(bx - ax, by - ay).long() + 2).clamp(2, 4096)
    sid = torch.repeat_interleave(torch.arange(S, device=dev), n_samp)
    start = torch.cumsum(n_samp, 0) - n_samp
    i = torch.arange(len(sid), device=dev) - start[sid]
    div = (n_samp - 1).double()
    step = torch.ones_like(div) / div
    t = torch.where(i == n_samp[sid] - 1, 1.0, i * step[sid])[:, None]
    p = seg[sid, 0] * (1 - t) + seg[sid, 1] * t
    x, y, z = project(p)
    ok = z > 1e-4
    x, y, z = x[ok], y[ok], z[ok]
    c = _t(colors, dev)[torch.remainder(sid[ok], len(colors))]
    K = len(z)
    keys, pix = [], []
    for dy in range(px):
        for dx in range(px):
            xi = torch.round(x).long() + dx
            yi = torch.round(y).long() + dy
            inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
            j = torch.nonzero(inb, as_tuple=True)[0]
            front = z[j] <= zbuf[yi[j], xi[j]] + z_bias
            j = j[front]
            keys.append((dy * px + dx) * K + j)
            pix.append(yi[j] * width + xi[j])
    win = torch.full((height * width,), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, torch.cat(pix), torch.cat(keys), "amax")
    hit = win >= 0
    flat = img.view(-1, 3)
    flat[hit] = c[torch.remainder(win[hit], max(K, 1))]


def bbox_segments(bmin: np.ndarray, bmax: np.ndarray,
                  pose: Optional[np.ndarray] = None) -> np.ndarray:
    """The 12 wireframe edges of an (optionally posed) axis-aligned box."""
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    c = np.array([[bmin[0], bmin[1], bmin[2]], [bmax[0], bmin[1], bmin[2]],
                  [bmax[0], bmax[1], bmin[2]], [bmin[0], bmax[1], bmin[2]],
                  [bmin[0], bmin[1], bmax[2]], [bmax[0], bmin[1], bmax[2]],
                  [bmax[0], bmax[1], bmax[2]], [bmin[0], bmax[1], bmax[2]]])
    if pose is not None:
        c = c @ np.asarray(pose, np.float64)[:3, :3].T + pose[:3, 3]
    e = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7)]
    return np.stack([np.stack([c[a], c[b]]) for a, b in e])


def grid_segments(bmin, bmax, y: float = 0.0, step: float = 0.5
                  ) -> np.ndarray:
    """Floor grid lines (dbgvis grid, debugvis.h)."""
    xs = np.arange(np.floor(bmin[0] / step) * step, bmax[0] + step, step)
    zs = np.arange(np.floor(bmin[2] / step) * step, bmax[2] + step, step)
    segs = [[[x, y, zs[0]], [x, y, zs[-1]]] for x in xs]
    segs += [[[xs[0], y, z], [xs[-1], y, z]] for z in zs]
    return np.asarray(segs, np.float64)


def axes_segments(origin=(0.0, 0.0, 0.0), length: float = 0.5) -> tuple:
    """World axes (dbgvis axes): returns (segments (3,2,3), colors (3,3))."""
    o = np.asarray(origin, np.float64)
    segs = np.array([[o, o + [length, 0, 0]],
                     [o, o + [0, length, 0]],
                     [o, o + [0, 0, length]]])
    cols = np.array([[230, 60, 60], [60, 220, 60], [70, 110, 255]],
                    np.uint8)
    return segs, cols


def colorize(cloud, mode: str = "rgb", device=None) -> torch.Tensor:
    """Per-point colors for a level dict, on ``device``: 'rgb' | 'class' |
    'instance' | 'normal' (n*0.5+0.5 — the cloudvis show_normals toggle,
    lib/rs/cloudvis.h:287-291)."""
    dev = resolve_device(device)
    if mode == "rgb":
        return _t(cloud["colors"], dev)
    palette = _t(NYU40_PALETTE, dev)
    if mode == "class":
        ids = _t(cloud["class_ids"], dev).long()
        return palette[ids.clamp(0, len(NYU40_PALETTE) - 1)]
    if mode == "instance":
        ids = _t(cloud["instance_ids"], dev).long()
        return palette[torch.remainder(ids, len(NYU40_PALETTE))]
    if mode == "normal":
        return _t(cloud["normals"], dev, torch.float64) * 0.5 + 0.5
    raise ValueError(f"unknown color mode {mode}")


def render_rsdb(db, scene_idx: int = -1, mode: str = "instance",
                level: int = 1, width: int = 1024, height: int = 768,
                camera_eye: Optional[Sequence[float]] = None,
                camera_target: Optional[Sequence[float]] = None,
                show_placements: bool = True,
                placement_mode: str = "optimized",
                max_proposals: int = 8,
                show_bboxes: bool = False,
                show_grid: bool = False,
                show_axes: bool = False,
                df_slice_y: Optional[float] = None,
                surfels: bool = False,
                edl_strength: float = 0.0,
                device=None) -> torch.Tensor:
    """Render a database scene + placed objects on ``device``; returns an
    (H, W, 3) uint8 tensor there. `placement_mode` mirrors the reference
    viewer's vis modes (apps/rsdb_viewer/main.cpp:81): 'optimized' draws
    the arrangement's poses, 'proposals' the top `max_proposals` proposals
    per object, 'identity' the objects at canonical pose. `mode` adds
    'score': placements colored by the diverging cool-warm map of their
    (proposal/placement) score — the reference viewer's score
    visualization (lib/rs/diverging_map.inl). Debug overlays
    (lib/rs/debugvis.h): placement bbox wireframes, floor grid, world
    axes, and an optional distance-field slice at height ``df_slice_y``
    (ops/distance_field, colored by the same diverging map)."""
    dev = resolve_device(device)
    scene = db.scenes[scene_idx].cloud
    L = scene.levels[level]
    pts = [_t(L["positions"], dev)]
    if mode == "score":
        # scene stays neutral gray; placements carry the score colors
        cols = [torch.full((len(L["positions"]), 3), 0.55,
                           dtype=torch.float64, device=dev)]
    else:
        cols = [colorize(L, mode, dev)]
    nrms = [_t(L["normals"], dev)]
    rads = [_t(L["radii"], dev)]

    def placements():
        arr_idx = scene_idx if scene_idx >= 0 else len(db.arrangements) - 1
        if placement_mode == "optimized":
            for p in db.arrangements[arr_idx]:
                yield p.object_idx, p.pose, p.uidx, p.score
        elif placement_mode == "proposals":
            poses = ((db.proposed_poses[arr_idx] or [])
                     if db.proposed_poses else [])
            scores = ((db.proposed_scores[arr_idx] or [])
                      if db.proposed_scores else [])
            for oi, obj_poses in enumerate(poses):
                sc = scores[oi] if oi < len(scores) else None
                for k in range(min(len(obj_poses), max_proposals)):
                    s = float(sc[k]) if sc is not None and k < len(sc) else 0.0
                    yield oi, np.asarray(obj_poses[k]), \
                        db.objects[oi].uidx, s
        elif placement_mode == "identity":
            for oi, o in enumerate(db.objects):
                yield oi, np.eye(4, dtype=np.float32), o.uidx, 1.0
        else:
            raise ValueError(f"unknown placement_mode {placement_mode}")

    overlay_boxes = []    # (segments, color float [0,1])
    if show_placements:
        drawn = [pl for pl in placements()
                 if db.objects[pl[0]].cloud is not None]
        if mode == "score":
            score_cols = diverging_colors(
                np.clip(np.array([pl[3] for pl in drawn], np.float64),
                        0.0, 1.0), device=dev)
            box_cols = score_cols.cpu().numpy()
        for k, (object_idx, pose, uidx, score) in enumerate(drawn):
            Lo = db.objects[object_idx].cloud.levels[level]
            w = _affine32(_t(Lo["positions"], dev), pose, True)
            pts.append(w)
            if mode == "score":
                cols.append(score_cols[k].expand(len(w), 3))
            else:
                fake = dict(Lo)
                fake["instance_ids"] = np.full(len(w), uidx, np.int32)
                cols.append(colorize(fake, mode, dev))
            nrms.append(_affine32(_t(Lo["normals"], dev), pose, False))
            rads.append(_t(Lo["radii"], dev))
            if show_bboxes:
                bmin_o = Lo["positions"].min(axis=0)
                bmax_o = Lo["positions"].max(axis=0)
                c = (box_cols[k] if mode == "score" else
                     NYU40_PALETTE[uidx % len(NYU40_PALETTE)] / 255.0)
                overlay_boxes.append((bbox_segments(bmin_o, bmax_o, pose),
                                      np.asarray(c, np.float64)))

    if df_slice_y is not None:
        # distance-field debug slice: sample a horizontal plane through the
        # scene's field, color by distance via the diverging map
        df = build_distance_field(scene.pos(2), voxel=0.05, max_dist=0.5,
                                  device=dev)
        bmin_s, bmax_s = scene.bbox
        gx = np.arange(bmin_s[0], bmax_s[0], 0.02)
        gz = np.arange(bmin_s[2], bmax_s[2], 0.02)
        gxx, gzz = np.meshgrid(gx, gz, indexing="ij")
        slice_pts = np.stack([gxx.ravel(),
                              np.full(gxx.size, df_slice_y),
                              gzz.ravel()], axis=1).astype(np.float32)
        d = df.lookup(slice_pts)
        pts.append(_t(slice_pts, dev))
        cols.append(diverging_colors(1.0 - _div(d, 0.5).clamp(0, 1)))
        nrms.append(torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float64,
                                 device=dev).expand(len(slice_pts), 3))
        rads.append(torch.full((len(slice_pts),), 0.01, dtype=torch.float32,
                               device=dev))

    pts = torch.cat(pts)
    cols = torch.cat([_div(c.double(), 255.0) if c.dtype == torch.uint8
                      else c.double() for c in cols])
    nrms = torch.cat([n.double() for n in nrms])

    bmin = pts.min(dim=0).values.cpu().numpy()
    bmax = pts.max(dim=0).values.cpu().numpy()
    center = (bmin + bmax) / 2
    diag = float(np.linalg.norm(bmax - bmin))
    eye = (np.asarray(camera_eye, np.float64) if camera_eye is not None
           else center + np.array([0.65, 0.9, 0.75]) * diag)
    target = (np.asarray(camera_target, np.float64)
              if camera_target is not None else center)
    view = look_at(eye, target)
    img, zbuf = render_points(pts, cols, view, width, height,
                              shade_normals=nrms,
                              radii=torch.cat(rads) if surfels else None,
                              edl_strength=edl_strength, return_zbuf=True)
    if show_grid:
        segs = grid_segments(bmin, bmax, y=float(bmin[1]))
        draw_segments(img, zbuf, view, segs,
                      np.full((len(segs), 3), 90, np.uint8))
    if show_axes:
        segs, axcols = axes_segments(origin=bmin, length=0.25 * diag)
        draw_segments(img, zbuf, view, segs, axcols, px=2)
    for segs, c in overlay_boxes:
        draw_segments(img, zbuf, view, segs,
                      np.tile(np.asarray(c).reshape(1, 3), (len(segs), 1)),
                      px=2)
    return img
