"""Debug artifact writer (the port's own copy of
``libviso_tpu/utils/debug_viz.py``: numpy and PIL, the same file names).

Host-side analog of the reference's OpenCV dump suite — corners (``save1``
src/viso.cpp:310-318), match blends (``save2blend`` :545-589), stacked
match lines (``save2`` :519-543), epipolar lines (``save2epip`` :591-614),
4-view circular matches (``save4`` :616-649), reprojection overlays
(``save1reproj`` :352-388) and the response histogram (``myhist``
:835-863) — implemented with PIL on numpy arrays (or CPU tensors) fed from
the device's tensors,
gated by a debug flag exactly like ``param.save_debug`` (src/viso.h:60).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _to_rgb(img) -> "Image.Image":
    from PIL import Image

    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return Image.fromarray(arr).convert("RGB")


def _valid_xy(kp_xy, valid):
    xy = np.asarray(kp_xy)
    if valid is not None:
        xy = xy[np.asarray(valid)]
    return xy


def save_corners(img, kp_xy, path, valid=None, color=(255, 0, 0), r=2):
    """Corner dots on the image (save1 analog)."""
    from PIL import ImageDraw

    im = _to_rgb(img)
    draw = ImageDraw.Draw(im)
    for x, y in _valid_xy(kp_xy, valid):
        draw.ellipse([x - r, y - r, x + r, y + r], outline=color)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    im.save(path)


def save_match_blend(img1, img2, kp1_xy, kp2_xy, match_idx, path,
                     valid=None, limit=None):
    """Blend both images 50/50 and draw match segments (save2blend analog)."""
    from PIL import Image, ImageDraw

    a = _to_rgb(img1)
    b = _to_rgb(img2)
    im = Image.blend(a, b, 0.5)
    draw = ImageDraw.Draw(im)
    idx = np.asarray(match_idx)
    kp1 = np.asarray(kp1_xy)
    kp2 = np.asarray(kp2_xy)
    ok = idx >= 0
    if valid is not None:
        ok &= np.asarray(valid)
    rows = np.nonzero(ok)[0]
    if limit:
        rows = rows[:limit]
    for i in rows:
        x1, y1 = kp1[i]
        x2, y2 = kp2[idx[i]]
        draw.line([x1, y1, x2, y2], fill=(0, 255, 0))
        draw.ellipse([x1 - 1, y1 - 1, x1 + 1, y1 + 1], outline=(255, 0, 0))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    im.save(path)


def save_stacked_matches(img1, img2, kp1_xy, kp2_xy, match_idx, path,
                         limit=50):
    """Vertically stacked pair with cross-image match lines (save2 analog)."""
    from PIL import Image, ImageDraw

    a = _to_rgb(img1)
    b = _to_rgb(img2)
    H = a.height
    im = Image.new("RGB", (max(a.width, b.width), a.height + b.height))
    im.paste(a, (0, 0))
    im.paste(b, (0, H))
    draw = ImageDraw.Draw(im)
    idx = np.asarray(match_idx)
    kp1 = np.asarray(kp1_xy)
    kp2 = np.asarray(kp2_xy)
    rows = np.nonzero(idx >= 0)[0][:limit]
    for i in rows:
        x1, y1 = kp1[i]
        x2, y2 = kp2[idx[i]]
        draw.line([x1, y1, x2, y2 + H], fill=(0, 255, 255))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    im.save(path)


def save_epipolar(img2, F, points1, path, color=(255, 255, 255)):
    """Epipolar lines of view-1 points drawn in view 2 (save2epip analog).

    Line of x1 in image 2: l = F x1 (with x2' F x1 = 0).
    """
    from PIL import ImageDraw

    im = _to_rgb(img2)
    draw = ImageDraw.Draw(im)
    F = np.asarray(F)
    W = im.width
    for x, y in np.asarray(points1):
        a, b, c = F @ np.array([x, y, 1.0])
        if abs(b) < 1e-12:
            continue
        y0 = -c / b
        y1 = -(c + a * W) / b
        draw.line([0, y0, W, y1], fill=color)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    im.save(path)


def save_circle_quad(im1, im1_prev, im2, im2_prev,
                     kp1_xy, kp1_prev_xy, kp2_xy, kp2_prev_xy,
                     circle, path, limit=None):
    """2x2 panel (cur/prev x left/right) with circular-match quads
    (save4 analog).  ``circle`` is a CircleResult."""
    from PIL import Image, ImageDraw

    tl, bl = _to_rgb(im1), _to_rgb(im1_prev)
    tr, br = _to_rgb(im2), _to_rgb(im2_prev)
    W, H = tl.width, tl.height
    im = Image.new("RGB", (2 * W, 2 * H))
    for tile, pos in [(tl, (0, 0)), (tr, (W, 0)), (bl, (0, H)),
                      (br, (W, H))]:
        im.paste(tile, pos)
    draw = ImageDraw.Draw(im)
    valid = np.asarray(circle.valid)
    rows = np.nonzero(valid)[0]
    if limit:
        rows = rows[:limit]
    kp1 = np.asarray(kp1_xy)
    kp1p = np.asarray(kp1_prev_xy)
    kp2 = np.asarray(kp2_xy)
    kp2p = np.asarray(kp2_prev_xy)
    r = np.asarray(circle.right)
    lp = np.asarray(circle.left_prev)
    rp = np.asarray(circle.right_prev)
    green = (0, 255, 0)
    for i in rows:
        p1 = kp1[i]
        p2 = kp2[r[i]] + [W, 0]
        p3 = kp1p[lp[i]] + [0, H]
        p4 = kp2p[rp[i]] + [W, H]
        draw.line([*p1, *p2], fill=green)
        draw.line([*p2, *p4], fill=green)
        draw.line([*p4, *p3], fill=green)
        draw.line([*p3, *p1], fill=green)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    im.save(path)


def save_reprojection(img, observed_xy, reprojected_xy, path, valid=None):
    """Observed (red) vs reprojected (green) points (save1reproj analog)."""
    from PIL import ImageDraw

    im = _to_rgb(img)
    draw = ImageDraw.Draw(im)
    obs = _valid_xy(observed_xy, valid)
    rep = _valid_xy(reprojected_xy, valid)
    for x, y in obs:
        draw.ellipse([x - 1, y - 1, x + 1, y + 1], outline=(255, 0, 0))
    for x, y in rep:
        draw.ellipse([x - 3, y - 3, x + 3, y + 3], outline=(0, 255, 0))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    im.save(path)


def save_histogram(values, path, bins=300, size=(1024, 800)):
    """Value histogram rendered as a line plot (myhist analog)."""
    from PIL import Image, ImageDraw

    vals = np.asarray(values).reshape(-1)
    hist, _ = np.histogram(vals, bins=bins)
    W, H = size
    im = Image.new("RGB", (W, H), (0, 0, 0))
    draw = ImageDraw.Draw(im)
    if hist.max() > 0:
        scaled = H - (hist / hist.max() * (H - 10)).astype(int)
        bw = max(1, W // bins)
        for i in range(1, bins):
            draw.line([bw * (i - 1), scaled[i - 1], bw * i, scaled[i]],
                      fill=(255, 0, 0), width=2)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    im.save(path)


class DebugDumper:
    """Per-frame artifact writer for the stereo pipeline, mirroring the
    dump points of sequence_odometry (src/viso.cpp:1232-1310)."""

    def __init__(self, dbg_dir: Optional[str]):
        self.dir = dbg_dir
        if dbg_dir:
            os.makedirs(dbg_dir, exist_ok=True)

    def _p(self, name):
        return os.path.join(self.dir, name)

    def frame(self, t, im1, im2, kp1, kp2, mlr, prev=None, circ=None,
              predict=None, obs=None, inliers=None):
        if not self.dir:
            return
        save_corners(im1, kp1.xy, self._p(f"corners1_{t:03d}.jpg"),
                     valid=kp1.valid)
        save_corners(im2, kp2.xy, self._p(f"corners2_{t:03d}.jpg"),
                     valid=kp2.valid)
        save_match_blend(im1, im2, kp1.xy, kp2.xy, mlr.idx,
                         self._p(f"blend12_{t:03d}.jpg"))
        if prev is not None and circ is not None:
            im1_prev, im2_prev, kp1_prev, kp2_prev = prev
            save_circle_quad(im1, im1_prev, im2, im2_prev,
                             kp1.xy, kp1_prev.xy, kp2.xy, kp2_prev.xy,
                             circ, self._p(f"circ_match_{t:03d}.jpg"))
        if predict is not None and obs is not None and inliers is not None:
            save_reprojection(im1, np.asarray(obs)[:, :2],
                              np.asarray(predict)[:, :2],
                              self._p(f"reproj1_{t:03d}.jpg"),
                              valid=inliers)


def save_trajectory(path, poses_est, poses_gt=None, size=(900, 900),
                    margin=40):
    """Top-down (x-z plane) trajectory plot: estimate in red, optional
    ground truth in white.  The standard KITTI-style sanity artifact the
    reference never produced."""
    from PIL import Image, ImageDraw

    est = np.asarray(poses_est)[:, [0, 2], 3]
    tracks = [("est", est, (255, 64, 64))]
    if poses_gt is not None:
        gt = np.asarray(poses_gt)[:, [0, 2], 3]
        tracks.insert(0, ("gt", gt, (255, 255, 255)))
    allpts = np.concatenate([t[1] for t in tracks])
    lo = allpts.min(axis=0)
    hi = allpts.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    scale = min((size[0] - 2 * margin) / span[0],
                (size[1] - 2 * margin) / span[1])

    img = Image.new("RGB", size, (24, 24, 24))
    draw = ImageDraw.Draw(img)

    def to_px(p):
        x = margin + (p[0] - lo[0]) * scale
        y = size[1] - margin - (p[1] - lo[1]) * scale  # +z up the image
        return (float(x), float(y))

    for name, pts, color in tracks:
        px = [to_px(p) for p in pts]
        if len(px) > 1:
            draw.line(px, fill=color, width=2)
        draw.ellipse([px[0][0] - 4, px[0][1] - 4, px[0][0] + 4,
                      px[0][1] + 4], outline=color)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    img.save(path)
    return path
