"""Perspective-correct textured-world renderer (the port's own copy of
``libviso_tpu/synthetic_world.py``: host-side numpy, the same arrays for
the same seed).

`synthetic.py` stamps screen-aligned texture sprites at projected landmark
positions — a controllable oracle, but three properties of real photographs
(the reference's operating domain, src/kitti.cpp:79-118) are missing:

  1. **dense texture everywhere** — real detectors pick 1200 corners out of
     a continuum of candidates, and the matcher faces distractors at every
     pixel, not a quiet noise floor between isolated patches;
  2. **perspective-correct appearance** — surface texture foreshortens,
     scales with distance, and shifts subpixel phase continuously as the
     camera moves (sprites keep constant pixel size and identical L/R
     appearance);
  3. **surface occlusion** — near geometry hides far geometry along rays,
     not by paint order.

This module renders a KITTI-like street — a ground plane with lane
markings plus facade-textured wall segments — by exact per-pixel
ray/plane intersection with a z-buffer and trilinear mipmap texture
sampling (band-limited minification: far texture blurs the way optics +
area sampling blur it, instead of aliasing).  Ground-truth poses stay
exact by construction, so trajectory error on these frames measures the
full pipeline's behavior on photograph-like evidence.

Geometry conventions match the rest of the repo: camera x right, y DOWN,
z forward; the ground plane sits at y = +height_above_ground.  The same
`Imaging` post-render model (exposure drift, sensor noise, blur,
occluders) composes on top, and the output is the same
`SyntheticSequence` the pipeline drivers and eval consume.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from libviso_torch.synthetic import Imaging, SyntheticSequence

# Pure-numpy pose helpers (the Euler-XYZ layout of geometry/se3.py and the
# reference tr2mat, src/viso.cpp:109-133).  This module is host-side scene
# generation and stays numpy end to end.


from libviso_torch.synthetic import _pose_matrix_np  # noqa: E402  (shared
#   host-side pose helper; lives in synthetic.py since the sprite
#   renderer's rolling-shutter path needs it too)


def _matrix_to_pose_np(T):
    """Inverse of `_pose_matrix_np` (away from ry = +-pi/2 gimbal lock)."""
    T = np.asarray(T, np.float64)
    R = T[..., :3, :3]
    ry = np.arcsin(np.clip(R[..., 0, 2], -1.0, 1.0))
    rx = np.arctan2(-R[..., 1, 2], R[..., 2, 2])
    rz = np.arctan2(-R[..., 0, 1], R[..., 0, 0])
    return np.concatenate(
        [np.stack([rx, ry, rz], axis=-1), T[..., :3, 3]], axis=-1)


# ---------------------------------------------------------------------------
# textures


def _band_limited_noise(rng, h, w, sigma, amp):
    from scipy.ndimage import gaussian_filter

    t = rng.normal(0.0, 1.0, (h, w))
    t = gaussian_filter(t, sigma, mode="wrap")
    s = t.std()
    return t * (amp / max(s, 1e-6))


def _pink_noise(rng, h, w, beta=2.0, amp=20.0):
    """Spectral-synthesis 1/f^beta noise — the defining second-order
    statistic of photographs.

    Natural-image power spectra follow P(f) ~ 1/f^beta with beta ~= 2
    (Ruderman/Field statistics); the Gaussian-filtered noise the r3
    textures used is BAND-PASS instead — it has a scale, where real
    surfaces have detail at every scale.  The practical difference for
    this engine: 1/f texture puts corner energy at all octaves, so
    detector response distributions, mip-level content under
    minification, and descriptor distinctiveness all behave like
    photographs rather than like a texture with one characteristic
    wavelength.

    Synthesis: white complex spectrum shaped by f^(-beta/2) (power then
    falls as f^-beta), DC zeroed, inverse FFT, normalized to ``amp``
    standard deviation.  Periodic by construction — fine for wrapped
    surface textures.
    """
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    spec = (rng.normal(size=(h, w // 2 + 1))
            + 1j * rng.normal(size=(h, w // 2 + 1))) * f ** (-beta / 2)
    spec[0, 0] = 0.0
    t = np.fft.irfft2(spec, s=(h, w))
    return t * (amp / max(t.std(), 1e-9))


def make_brick_texture(rng, h, w, px_per_m=40.0):
    """Running-bond brick wall: offset rows of per-brick albedo
    rectangles, mortar joints, 1/f surface modulation.

    The photographic property under test is REPETITIVE STRUCTURE: real
    brick facades put thousands of visually similar corners on a
    regular lattice, so the matcher's ratio test faces near-identical
    second-best candidates one brick pitch away — the classic aliased-
    match regime procedural facade noise never produces."""
    brick_h = max(4, int(0.08 * px_per_m))   # ~8 cm courses
    brick_w = max(8, int(0.20 * px_per_m))   # ~20 cm stretchers
    mortar = max(1, brick_h // 4)
    tex = np.full((h, w), 168.0)             # mortar base
    for row, y0 in enumerate(range(0, h, brick_h + mortar)):
        off = (row % 2) * (brick_w + mortar) // 2
        for x0 in range(-off, w, brick_w + mortar):
            alb = rng.uniform(95.0, 150.0)
            y1 = min(h, y0 + brick_h)
            x1 = min(w, x0 + brick_w)
            xs = max(0, x0)
            if y1 > y0 and x1 > xs:
                tex[y0:y1, xs:x1] = alb
    tex = tex + _pink_noise(rng, h, w, beta=2.0, amp=9.0)
    return np.clip(tex, 4.0, 251.0).astype(np.float32)


def make_foliage_texture(rng, h, w, px_per_m=40.0):
    """Vegetation-like isotropic clutter: saturated 1/f luminance with
    log-normal-ish local contrast and dark cavity blotches.

    The photographic property under test is CORNER INSTABILITY: foliage
    fires the Harris detector everywhere, but the 'corners' are noise
    maxima of an isotropic field — localization is weak and descriptors
    are self-similar, so detection budget drains into low-value
    features (the vegetation failure class of real KITTI suburbs)."""
    p = _pink_noise(rng, h, w, beta=1.8, amp=1.0)
    clump = _pink_noise(rng, h, w, beta=3.2, amp=1.0)
    tex = 88.0 + 46.0 * np.tanh(1.3 * p) + 22.0 * clump
    # cavity shadows: deep-shade holes where the canopy self-occludes
    holes = _pink_noise(rng, h, w, beta=2.4, amp=1.0)
    tex = np.where(holes < -1.1, tex * 0.35 + 8.0, tex)
    return np.clip(tex, 4.0, 251.0).astype(np.float32)


def make_glass_texture(rng, h, w, px_per_m=40.0):
    """Modern glass curtain wall: large near-featureless panels with
    smooth reflection gradients, separated by a strong mullion grid.

    The photographic property under test is TEXTURE STARVATION: inside
    a panel there is almost no corner energy (a faint 1/f film well
    below the detector's useful contrast), so the whole wall's
    detection budget collapses onto the sparse mullion intersections —
    the low-texture downtown regime where real VO loses its spatial
    corner spread."""
    panel_h = max(10, int(1.4 * px_per_m))
    panel_w = max(10, int(1.1 * px_per_m))
    mull = max(2, int(0.06 * px_per_m))
    # per-panel smooth reflection: low-frequency sky/street gradient
    tex = 118.0 + _pink_noise(rng, h, w, beta=3.6, amp=26.0) \
        + _pink_noise(rng, h, w, beta=2.0, amp=2.5)   # faint film
    for y0 in range(0, h, panel_h + mull):
        tex[y0:min(h, y0 + mull), :] = 52.0
    for x0 in range(0, w, panel_w + mull):
        tex[:, x0:min(w, x0 + mull)] = 52.0
    return np.clip(tex, 4.0, 251.0).astype(np.float32)


# wall-texture classes selectable by the scene builders ("photo" mixes
# draws so one street shows brick, foliage, glass, and classic facade
# segments side by side, like a real suburb block)
WALL_TEXTURES = {
    "facade": lambda rng, h, w, ppm: make_facade_texture(rng, h, w),
    "brick": make_brick_texture,
    "foliage": make_foliage_texture,
    "glass": make_glass_texture,
}
PHOTO_MIX = (("facade", 0.3), ("brick", 0.3), ("foliage", 0.2),
             ("glass", 0.2))


def _draw_wall_texture(rng, h, w, px_per_m, wall_texture):
    if wall_texture == "photo":
        names, probs = zip(*PHOTO_MIX)
        wall_texture = rng.choice(names, p=probs)
    return WALL_TEXTURES[wall_texture](rng, h, w, px_per_m)


def make_facade_texture(rng, h, w):
    """Building-facade-like texture: multi-octave band-limited noise plus
    a jittered grid of sharp-edged 'window' rectangles.  The rectangle
    corners are what Harris fires on; the noise gives every patch a
    distinctive descriptor."""
    tex = 120.0 + _band_limited_noise(rng, h, w, 1.5, 18.0) \
        + _band_limited_noise(rng, h, w, 9.0, 26.0)
    # window grid: rows/cols with per-window intensity and jitter
    wh, ww = max(8, h // 14), max(8, w // 22)
    for gy in range(1, h // (2 * wh)):
        for gx in range(1, w // (2 * ww)):
            if rng.uniform() < 0.18:
                continue  # skip some windows (irregularity)
            y0 = 2 * gy * wh + rng.integers(-wh // 3, wh // 3 + 1)
            x0 = 2 * gx * ww + rng.integers(-ww // 3, ww // 3 + 1)
            y1, x1 = min(h, y0 + wh), min(w, x0 + ww)
            if y1 <= y0 or x1 <= x0:
                continue
            level = rng.uniform(35.0, 90.0) if rng.uniform() < 0.7 \
                else rng.uniform(170.0, 235.0)
            tex[y0:y1, x0:x1] = level + tex[y0:y1, x0:x1] * 0.25
            # window frame: a 2-texel bright border (extra corners)
            tex[y0:y0 + 2, x0:x1] = 200.0
            tex[max(0, y1 - 2):y1, x0:x1] = 200.0
            tex[y0:y1, x0:x0 + 2] = 200.0
            tex[y0:y1, max(0, x1 - 2):x1] = 200.0
    return np.clip(tex, 4.0, 251.0).astype(np.float32)


def make_road_texture(rng, h, w, px_per_m):
    """Road surface: asphalt noise + a dashed center line and solid edge
    lines along the LENGTH (axis 0 = distance along the road)."""
    tex = 95.0 + _band_limited_noise(rng, h, w, 1.2, 12.0) \
        + _band_limited_noise(rng, h, w, 6.0, 10.0)
    lane_w = max(2, int(0.15 * px_per_m))
    dash = max(4, int(2.0 * px_per_m))
    mid = w // 2
    for x0 in (int(0.12 * w), int(0.88 * w)):        # solid edge lines
        tex[:, x0:x0 + lane_w] = 215.0 + tex[:, x0:x0 + lane_w] * 0.1
    for y0 in range(0, h, 2 * dash):                 # dashed center line
        tex[y0:y0 + dash, mid:mid + lane_w] = \
            218.0 + tex[y0:y0 + dash, mid:mid + lane_w] * 0.1
    return np.clip(tex, 4.0, 251.0).astype(np.float32)


def _mip_pyramid(tex, levels):
    from scipy.ndimage import gaussian_filter

    pyr = [tex]
    for _ in range(levels - 1):
        t = gaussian_filter(pyr[-1], 1.0, mode="nearest")[::2, ::2]
        if min(t.shape) < 2:
            break
        pyr.append(np.ascontiguousarray(t))
    return pyr


def _bilinear(tex, y, x):
    h, w = tex.shape
    y = np.clip(y, 0.0, h - 1.001)
    x = np.clip(x, 0.0, w - 1.001)
    y0 = y.astype(np.int64)
    x0 = x.astype(np.int64)
    ay, ax = y - y0, x - x0
    t00 = tex[y0, x0]
    t01 = tex[y0, x0 + 1]
    t10 = tex[y0 + 1, x0]
    t11 = tex[y0 + 1, x0 + 1]
    return ((1 - ay) * ((1 - ax) * t00 + ax * t01)
            + ay * ((1 - ax) * t10 + ax * t11))


def _sample_mip(pyr, s, t, level):
    """Trilinear: bilinear at floor(level) and floor(level)+1, lerped.
    s/t are texel coordinates at level 0."""
    lmax = len(pyr) - 1
    level = np.clip(level, 0.0, float(lmax))
    l0 = np.floor(level).astype(np.int64)
    frac = level - l0
    out = np.zeros_like(s, dtype=np.float32)
    for li in range(lmax + 1):
        sel0 = l0 == li
        sel1 = (l0 == li - 1) & (frac > 0)
        if not (sel0.any() or sel1.any()):
            continue
        scale = 1.0 / (1 << li)
        if sel0.any():
            v = _bilinear(pyr[li], t[sel0] * scale, s[sel0] * scale)
            out[sel0] += (1 - frac[sel0]) * v
        if sel1.any():
            v = _bilinear(pyr[li], t[sel1] * scale, s[sel1] * scale)
            out[sel1] += frac[sel1] * v
    # lerp target for the top level saturates (no level above): give the
    # remainder to the top level itself
    top = (l0 == lmax) & (frac > 0)
    if top.any():
        v = _bilinear(pyr[lmax], t[top] / (1 << lmax), s[top] / (1 << lmax))
        out[top] += frac[top] * v
    return out


# ---------------------------------------------------------------------------
# scene


@dataclasses.dataclass
class Plane:
    """A textured rectangle: origin + two edge vectors (meters)."""

    origin: np.ndarray    # (3,) world position of texel (0, 0)
    eu: np.ndarray        # (3,) edge along texture x (full extent)
    ev: np.ndarray        # (3,) edge along texture y (full extent)
    pyr: list             # mip pyramid, level-0 shape (Ht, Wt)
    px_per_m: float       # texel density along both edges

    @property
    def normal(self):
        n = np.cross(self.eu, self.ev)
        return n / np.linalg.norm(n)


@dataclasses.dataclass
class Mover:
    """A dynamic textured plane: rendered at ``plane.origin + k*velocity``
    on frame k (the dominant-mover regime).  Feature-rich
    coherent wrong motion is the classic VO failure on real roads
    (a truck filling a quarter of the frame); the reference has no
    defense either (its RANSAC simply follows the majority support,
    src/viso.cpp:1543-1580)."""

    plane: Plane
    velocity: np.ndarray   # (3,) world displacement per frame [m]


def make_truck_mover(rng, length=8.0, height=3.0, x=-3.2, z0=7.0,
                     ground_y=1.65, velocity=(0.0, 0.0, 0.55),
                     px_per_m=40.0) -> Mover:
    """A truck-sized facade-textured side panel in the adjacent lane,
    moving parallel to the road.  With the default camera speed
    (0.8 m/frame) velocity_z < speed reads as the camera overtaking a
    slower truck — its features form a large, internally consistent
    motion cluster that disagrees with the static world."""
    tex = make_facade_texture(rng, int(height * px_per_m),
                              int(length * px_per_m))
    return Mover(
        plane=Plane(
            origin=np.array([x, ground_y, z0]),
            eu=np.array([0.0, 0.0, length]),
            ev=np.array([0.0, -height, 0.0]),
            pyr=_mip_pyramid(tex, 6),
            px_per_m=px_per_m,
        ),
        velocity=np.asarray(velocity, np.float64),
    )


def build_street_scene(rng, length=120.0, half_width=9.0,
                       wall_height=7.0, ground_y=1.65, px_per_m=40.0,
                       segment_len=30.0, wall_texture="facade"):
    """KITTI-like street: road plane + jittered wall segments both sides
    + a far end wall.  Wall x-offsets vary per segment so the scene has
    depth structure (doorway-like setbacks), not a perfect corridor."""
    planes = []
    # road: along +z, width 2*half_width, from z=-10 to z=length
    road_len = length + 20.0
    h = int(road_len * px_per_m)
    w = int(2 * half_width * px_per_m)
    planes.append(Plane(
        origin=np.array([-half_width, ground_y, -10.0]),
        eu=np.array([2 * half_width, 0.0, 0.0]),
        ev=np.array([0.0, 0.0, road_len]),
        pyr=_mip_pyramid(make_road_texture(rng, h, w, px_per_m), 6),
        px_per_m=px_per_m,
    ))
    # wall segments
    n_seg = int(np.ceil(road_len / segment_len))
    for side in (-1.0, +1.0):
        for k in range(n_seg):
            z0 = -10.0 + k * segment_len
            x = side * (half_width + rng.uniform(-1.5, 2.5))
            hgt = wall_height + rng.uniform(-1.5, 2.0)
            th = int(hgt * px_per_m)
            tw = int(segment_len * px_per_m)
            tex = _draw_wall_texture(rng, th, tw, px_per_m, wall_texture)
            # eu runs along +z for the left wall and -z for the right so
            # both faces' texture x increases "into" the street view
            planes.append(Plane(
                origin=np.array([x, ground_y, z0 if side < 0
                                 else z0 + segment_len]),
                eu=np.array([0.0, 0.0, segment_len * (1 if side < 0
                                                      else -1)]),
                ev=np.array([0.0, -hgt, 0.0]),
                pyr=_mip_pyramid(tex, 6),
                px_per_m=px_per_m,
            ))
    # far end wall (fronto-parallel)
    ew = 2 * (half_width + 4.0)
    eh = wall_height + 6.0
    planes.append(Plane(
        origin=np.array([-ew / 2, ground_y, length + 8.0]),
        eu=np.array([ew, 0.0, 0.0]),
        ev=np.array([0.0, -eh, 0.0]),
        pyr=_mip_pyramid(
            _draw_wall_texture(rng, int(eh * px_per_m),
                               int(ew * px_per_m), px_per_m,
                               wall_texture), 6),
        px_per_m=px_per_m,
    ))
    return planes


def build_plaza_scene(rng, center_xz=(0.0, 0.0), radius=18.0,
                      wall_height=8.0, ground_y=1.65, n_walls=12,
                      px_per_m=40.0, wall_texture="facade"):
    """Enclosed plaza: a square ground slab + a regular-polygon perimeter
    of facade wall segments, each with its own texture draw.  Built for
    closed-circuit (loop-closure) drives: every heading sees distinctive
    facades, and a revisit sees the same facades again."""
    cx, cz = center_xz
    planes = []
    size = 2 * (radius + 8.0)
    h = w = int(size * px_per_m)
    planes.append(Plane(
        origin=np.array([cx - size / 2, ground_y, cz - size / 2]),
        eu=np.array([size, 0.0, 0.0]),
        ev=np.array([0.0, 0.0, size]),
        pyr=_mip_pyramid(make_road_texture(rng, h, w, px_per_m), 6),
        px_per_m=px_per_m,
    ))
    for k in range(n_walls):
        a0 = 2 * np.pi * k / n_walls
        a1 = 2 * np.pi * (k + 1) / n_walls
        p0 = np.array([cx + radius * np.cos(a0), ground_y,
                       cz + radius * np.sin(a0)])
        p1 = np.array([cx + radius * np.cos(a1), ground_y,
                       cz + radius * np.sin(a1)])
        seg = np.linalg.norm(p1 - p0)
        hgt = wall_height + rng.uniform(-1.5, 2.0)
        tex = _draw_wall_texture(rng, int(hgt * px_per_m),
                                 int(seg * px_per_m), px_per_m,
                                 wall_texture)
        planes.append(Plane(
            origin=p0, eu=p1 - p0, ev=np.array([0.0, -hgt, 0.0]),
            pyr=_mip_pyramid(tex, 6), px_per_m=px_per_m,
        ))
    return planes


# ---------------------------------------------------------------------------
# renderer


def _clip_z(poly, eps):
    """Sutherland-Hodgman clip of a camera-space polygon against z >= eps."""
    out = []
    m = len(poly)
    for i in range(m):
        a, b = poly[i], poly[(i + 1) % m]
        ain, bin_ = a[2] >= eps, b[2] >= eps
        if ain:
            out.append(a)
        if ain != bin_:
            s = (eps - a[2]) / (b[2] - a[2])
            out.append(a + s * (b - a))
    return out


def _plane_bbox(pl, C, R_wc, f, cu, cv, width, height, margin=3):
    """Conservative image-space bbox of a plane's visible region: project
    the quad's corners after clipping to the near plane.  Exact for
    convex quads (the image of a convex polygon fully in front of the
    camera is the convex hull of its projected vertices), so hits are
    unchanged — this only skips pixels that cannot hit."""
    corners = np.stack([pl.origin, pl.origin + pl.eu,
                        pl.origin + pl.eu + pl.ev, pl.origin + pl.ev])
    Xc = (corners - C) @ R_wc           # camera coords: R_wc^T (p - C)
    poly = _clip_z(list(Xc), 0.05)
    if not poly:
        return None
    P = np.stack(poly)
    uc = f * P[:, 0] / P[:, 2] + cu
    vc = f * P[:, 1] / P[:, 2] + cv
    x0 = max(0, int(np.floor(uc.min())) - margin)
    x1 = min(width, int(np.ceil(uc.max())) + margin + 1)
    y0 = max(0, int(np.floor(vc.min())) - margin)
    y1 = min(height, int(np.ceil(vc.max())) + margin + 1)
    if x0 >= x1 or y0 >= y1:
        return None
    return x0, x1, y0, y1


def render_view(planes, C, R_wc, f, cu, cv, width, height, sky=None,
                sky_noise=None):
    """Render one pinhole view by ray casting every pixel against every
    plane with a z-buffer and mipmapped texture sampling.  Per-plane work
    is restricted to the projected-quad bounding box (`_plane_bbox`) —
    an exact optimization: the hit set is unchanged, and the >=3 px
    margin keeps the mip-level finite differences central at every
    possible hit pixel.

    Args:
      C: (3,) camera center in world coordinates.
      R_wc: (3, 3) camera-to-world rotation.
      sky_noise: optional (H, W) array added where no plane is hit.
    """
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    dc = np.stack([(u - cu) / f, (v - cv) / f, np.ones_like(u)], axis=-1)
    d_full = dc @ R_wc.T                # (H, W, 3) world ray directions
    if sky is None:
        # bright overcast sky with a vertical gradient: skyline edges get
        # realistic high contrast against the facades
        sky = (198.0 - 36.0 * (v / max(height - 1, 1))).astype(np.float32)
    img = np.full((height, width), 0.0, np.float32) + sky
    if sky_noise is not None:
        img += sky_noise
    zbuf = np.full((height, width), np.inf)

    MAX_ANISO = 8.0   # blur at most this far past the minor axis (GPU-
    #                   style anisotropic clamp: grazing surfaces keep
    #                   detail along the uncompressed texture direction)
    for pl in planes:
        bbox = _plane_bbox(pl, C, R_wc, f, cu, cv, width, height)
        if bbox is None:
            continue
        x0, x1, y0, y1 = bbox
        d = d_full[y0:y1, x0:x1]
        n = pl.normal
        denom = d @ n                                   # (h, w) window
        num = float((pl.origin - C) @ n)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num / denom
            p = C + t[..., None] * d                    # world hit points
            rel = p - pl.origin
            su = (rel @ pl.eu) / float(pl.eu @ pl.eu)   # in [0, 1]
            sv = (rel @ pl.ev) / float(pl.ev @ pl.ev)
        imgw = img[y0:y1, x0:x1]                        # views: writes
        zw = zbuf[y0:y1, x0:x1]                         # go through
        hit = (t > 0.05) & np.isfinite(t) & (t < zw)
        hit &= (su >= 0) & (su < 1) & (sv >= 0) & (sv < 1)
        if not hit.any():
            continue
        Ht, Wt = pl.pyr[0].shape
        tx = su * Wt                                    # level-0 texels
        ty = sv * Ht
        # mip level from the texel-coordinate Jacobian (finite differences
        # on the full smooth su/sv maps — they extend smoothly past the
        # plane rectangle, so rect borders don't contaminate; only the
        # horizon line denom->0 does, and it can't be in-rect).  Column
        # norms approximate the footprint along image x and y; the level
        # uses the GPU anisotropic rule max(minor, major/MAX_ANISO) so
        # grazing incidence blurs along the compressed direction only.
        with np.errstate(invalid="ignore", over="ignore"):
            gy_x, gx_x = np.gradient(tx)
            gy_y, gx_y = np.gradient(ty)
            fx = np.hypot(gx_x, gx_y)                   # along image x
            fy = np.hypot(gy_x, gy_y)                   # along image y
            minor = np.minimum(fx, fy)
            major = np.maximum(fx, fy)
            foot = np.maximum(minor, major / MAX_ANISO)
            level = np.log2(np.clip(np.nan_to_num(foot, nan=1.0),
                                    1.0, 1 << 20))
        vals = _sample_mip(pl.pyr, tx[hit], ty[hit], level[hit])
        imgw[hit] = vals
        zw[hit] = t[hit]
    return img


def generate_world_sequence(num_frames=8, seed=0, width=620, height=188,
                            f=360.0, base=0.54, speed=0.8,
                            yaw_rate=0.004,
                            trajectory: Optional[np.ndarray] = None,
                            imaging: Optional[Imaging] = None,
                            px_per_m=40.0,
                            scene_kwargs: Optional[dict] = None,
                            movers: Optional[List[Mover]] = None,
                            wall_texture: str = "facade"
                            ) -> SyntheticSequence:
    """Render a stereo drive through a textured street world.

    Same trajectory/output contract as `synthetic.generate_sequence`
    (forward drive with gentle yaw by default, or an explicit
    (num_frames, 6) per-frame step list), but the frames are dense
    perspective-correct renders instead of sprite stamps;
    `gt_projections` is None (there are no discrete landmarks).
    ``movers``: dynamic textured planes rendered at
    ``origin + k*velocity`` per frame (make_truck_mover).

    Long drives: the default ``yaw_rate`` (0.004 rad/frame) is tuned
    for <=16-frame battery drives; past ~100 frames the accumulated
    turn steers the camera THROUGH the street's side wall (measured
    r5: 161-frame drive, ATE 18 m of "drift" that was really the
    camera exiting the scene).  Pass ``yaw_rate=0`` (or an explicit
    trajectory) for long street drives; the plaza generator is the
    long-circuit oracle.
    """
    rng = np.random.default_rng(seed)
    cu, cv = width / 2.0, height / 2.0
    P1 = np.array([[f, 0, cu, 0], [0, f, cv, 0], [0, 0, 1, 0]])
    P2 = P1.copy()
    P2[0, 3] = -f * base

    length = speed * num_frames + 60.0
    planes = build_street_scene(rng, length=length, px_per_m=px_per_m,
                                wall_texture=wall_texture,
                                **(scene_kwargs or {}))

    if trajectory is None:
        cam_steps = np.zeros((num_frames, 6))
        for k in range(1, num_frames):
            cam_steps[k] = [0.0,
                            yaw_rate * (1 + 0.2 * np.sin(k / 3.0)), 0.0,
                            0.02 * np.sin(k / 5.0), 0.0, speed]
    else:
        cam_steps = np.asarray(trajectory, np.float64)
        assert cam_steps.shape == (num_frames, 6)
    return _sequence_from_scene(planes, cam_steps, seed, width, height,
                                f, cu, cv, base, imaging, P1, P2,
                                movers=movers)


def generate_plaza_sequence(num_frames=40, seed=0, width=416, height=160,
                            f=360.0, base=0.54, radius=10.0,
                            plaza_radius=18.0,
                            imaging: Optional[Imaging] = None,
                            px_per_m=30.0,
                            circuits: int = 1,
                            wall_texture: str = "facade"
                            ) -> SyntheticSequence:
    """Render a closed-circuit drive around a plaza (loop-closure
    oracle): constant yaw + chord steps trace a circle of ``radius``
    inside a facade perimeter at ``plaza_radius``.  Frame num_frames-1
    returns to (and re-views) frame 0's pose heading, so revisit
    detection faces the same facades under accumulated VO drift.
    ``circuits > 1`` laps the same circle repeatedly (multi-revisit
    battery: every post-lap-1 keyframe can close against lap 1)."""
    rng = np.random.default_rng(seed)
    cu, cv = width / 2.0, height / 2.0
    P1 = np.array([[f, 0, cu, 0], [0, f, cv, 0], [0, 0, 1, 0]])
    P2 = P1.copy()
    P2[0, 3] = -f * base

    yaw = 2 * np.pi * circuits / (num_frames - 1)
    chord = 2 * radius * np.sin(yaw / 2)
    cam_steps = np.zeros((num_frames, 6))
    cam_steps[1:] = [0.0, yaw, 0.0, 0.0, 0.0, chord]

    # place the plaza around the measured trajectory centroid
    M = _pose_matrix_np(cam_steps)
    pos = np.zeros((num_frames, 3))
    P = np.eye(4)
    for k in range(1, num_frames):
        P = P @ M[k]
        pos[k] = P[:3, 3]
    cx, cz = pos[:, 0].mean(), pos[:, 2].mean()
    planes = build_plaza_scene(rng, center_xz=(cx, cz),
                               radius=plaza_radius, px_per_m=px_per_m,
                               wall_texture=wall_texture)
    return _sequence_from_scene(planes, cam_steps, seed, width, height,
                                f, cu, cv, base, imaging, P1, P2)


def _sequence_from_scene(planes, cam_steps, seed, width, height, f, cu,
                         cv, base, imaging, P1, P2,
                         movers: Optional[List[Mover]] = None
                         ) -> SyntheticSequence:
    """Chain GT poses from per-frame camera steps, render both views per
    frame, and apply the shared `synthetic.Imaging` post-render model.
    ``movers`` are re-positioned (origin + k*velocity) each frame and
    z-buffered against the static scene like any other plane."""
    num_frames = len(cam_steps)
    rng = np.random.default_rng((seed, 0xF1E1D))
    M = _pose_matrix_np(cam_steps)
    gt_poses = np.zeros_like(M)
    gt_poses[0] = np.eye(4)
    for k in range(1, num_frames):
        gt_poses[k] = gt_poses[k - 1] @ M[k]
    motions = _matrix_to_pose_np(np.linalg.inv(M))

    img_model = imaging or Imaging()
    irng = np.random.default_rng((seed, 0xD1CE))
    # (reuse synthetic.py's imaging semantics on rendered frames)
    from libviso_torch.synthetic import _gaussian_blur, _OccluderField

    occl = (_OccluderField(irng, img_model.num_occluders,
                           img_model.occluder_size,
                           img_model.occluder_speed, width, height)
            if img_model.num_occluders else None)
    log_gain = np.cumsum(np.concatenate(
        [[0.0], irng.normal(0, img_model.exposure_drift, num_frames - 1)]))
    bias = np.cumsum(np.concatenate(
        [[0.0], irng.normal(0, img_model.bias_drift, num_frames - 1)]))
    lr_dgain = irng.normal(0, img_model.lr_gain_mismatch, num_frames)

    frames: List[Tuple[np.ndarray, np.ndarray]] = []
    n_bands = 8   # rolling-shutter row bands (rs_fraction > 0)
    for k in range(num_frames):
        sky1 = rng.normal(0.0, 2.0, (height, width)).astype(np.float32)
        sky2 = rng.normal(0.0, 2.0, (height, width)).astype(np.float32)
        frame_planes = planes
        if movers:
            frame_planes = planes + [
                dataclasses.replace(m.plane,
                                    origin=m.plane.origin + k * m.velocity)
                for m in movers]

        def _views_at(pose):
            Rwc = pose[:3, :3]
            Cl = pose[:3, 3]
            Cr = Cl + Rwc @ np.array([base, 0.0, 0.0])
            v1 = render_view(frame_planes, Cl, Rwc, f, cu, cv, width,
                             height, sky_noise=sky1)
            v2 = render_view(frame_planes, Cr, Rwc, f, cu, cv, width,
                             height, sky_noise=sky2)
            return v1, v2

        if img_model.rs_fraction > 0 and num_frames > 1:
            # Rolling shutter (Imaging.rs_fraction): render the frame in
            # n_bands row bands, each from the camera pose advanced by
            # rs * (band_center/H) of the NEXT frame's motion — genuine
            # row-time geometry skew, not a post-render warp.  Both
            # views share row timing (synchronized stereo readout).
            step_next = cam_steps[min(k + 1, num_frames - 1)]
            im1 = np.zeros((height, width), np.float32)
            im2 = np.zeros((height, width), np.float32)
            for b in range(n_bands):
                r0 = b * height // n_bands
                r1 = (b + 1) * height // n_bands
                alpha = (img_model.rs_fraction
                         * ((r0 + r1) / 2.0) / max(height - 1, 1))
                pose_b = gt_poses[k] @ _pose_matrix_np(alpha * step_next)
                v1, v2 = _views_at(pose_b)
                im1[r0:r1] = v1[r0:r1]
                im2[r0:r1] = v2[r0:r1]
        else:
            im1, im2 = _views_at(gt_poses[k])
        if imaging is not None:
            if occl is not None:
                occl.paint(im1, im2, k)
            if img_model.blur_sigma > 0:
                im1 = _gaussian_blur(im1, img_model.blur_sigma)
                im2 = _gaussian_blur(im2, img_model.blur_sigma)
            g1 = np.exp(log_gain[k]) * img_model.overexposure_gain
            g2 = (np.exp(log_gain[k] + lr_dgain[k])
                  * img_model.overexposure_gain)
            im1 = g1 * im1 + bias[k]
            im2 = g2 * im2 + bias[k]
            if img_model.noise_sigma > 0:
                im1 = im1 + irng.normal(0, img_model.noise_sigma, im1.shape)
                im2 = im2 + irng.normal(0, img_model.noise_sigma, im2.shape)
        im1 = np.clip(im1, 0, 255).astype(np.float32)
        im2 = np.clip(im2, 0, 255).astype(np.float32)
        if img_model.quantize:
            im1, im2 = np.round(im1), np.round(im2)
        frames.append((im1, im2))

    return SyntheticSequence(frames=frames, gt_poses=gt_poses,
                             gt_motions=motions, P1=P1, P2=P2,
                             gt_projections=None)
