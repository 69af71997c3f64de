"""Multi-scale pyramid detection and subpixel corner refinement (port of
``libviso_tpu/ops/pyramid.py``).

  - Pyramid: repeated 2x2 average pooling.
  - Each level runs the binned Harris detection with a budget that halves
    per level; keypoint coordinates map back to level-0 pixels
    (x * 2^l + offset) and descriptors are sampled from the detection
    level's Sobel image, so a coarse corner is described at the scale it
    was found.
  - Subpixel: a quadratic fit to the 3x3 |response| neighbourhood of each
    corner; the offset is the Newton step of the fitted paraboloid,
    clamped to +-0.5 px.  Descriptor gathers stay integral; triangulation
    and the pose solve see the fractional coordinates.

Every function takes leading batch axes, (..., H, W) images and
(..., N, ...) keypoints, like the rest of the front-end.
"""

from __future__ import annotations

import dataclasses

import torch

from libviso_torch.config import DetectorConfig
from libviso_torch.ops.features import (
    Keypoints,
    detect_harris_binned,
    extract_descriptors,
    harris_response,
)


def downsample2(img):
    """2x2 average pooling of (..., H, W) (crops odd edges)."""
    H, W = img.shape[-2:]
    H2, W2 = H // 2, W // 2
    return img[..., : H2 * 2, : W2 * 2].reshape(
        *img.shape[:-2], H2, 2, W2, 2).mean((-3, -1))


def build_pyramid(img, levels: int):
    """List of ``levels`` images, level 0 = input."""
    pyr = [img]
    for _ in range(1, levels):
        pyr.append(downsample2(pyr[-1]))
    return pyr


def subpixel_refine(resp, kp: Keypoints) -> Keypoints:
    """Quadratic-fit subpixel refinement of corner positions: resp
    (..., H, W), kp of (..., N, ...) tensors.

    Fits a paraboloid to |response| on the 3x3 neighbourhood; the offset is
    clamped to [-0.5, 0.5].  Corners on the image border, where the fit
    would be centred on another pixel, keep their integer position.
    """
    a = resp.abs()
    H, W = a.shape[-2:]
    flat = a.reshape(*a.shape[:-2], H * W)
    xi = kp.xy[..., 0].long()
    yi = kp.xy[..., 1].long()
    x = torch.clamp(xi, 1, W - 2)
    y = torch.clamp(yi, 1, H - 2)
    unclamped = (x == xi) & (y == yi)

    def g(dy, dx):
        return torch.gather(flat, -1, (y + dy) * W + (x + dx))

    gx = (g(0, 1) - g(0, -1)) / 2.0
    gy = (g(1, 0) - g(-1, 0)) / 2.0
    gxx = g(0, 1) - 2.0 * g(0, 0) + g(0, -1)
    gyy = g(1, 0) - 2.0 * g(0, 0) + g(-1, 0)
    gxy = (g(1, 1) - g(1, -1) - g(-1, 1) + g(-1, -1)) / 4.0

    det = gxx * gyy - gxy * gxy
    safe = det.abs() > 1e-18
    det = torch.where(safe, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    dx = -(gyy * gx - gxy * gy) / det
    dy = -(gxx * gy - gxy * gx) / det
    dx = torch.clamp(torch.where(safe, dx, zero), -0.5, 0.5)
    dy = torch.clamp(torch.where(safe, dy, zero), -0.5, 0.5)
    apply = (kp.valid & unclamped)[..., None]
    new_xy = kp.xy + torch.stack([dx, dy], dim=-1) * apply
    return kp._replace(xy=new_xy)


def _level_budget(cfg: DetectorConfig, levels: int):
    """Slot budgets per level, proportional to 2^-level (level 0 richest),
    summing exactly to cfg.num_slots."""
    weights = [2.0 ** -lv for lv in range(levels)]
    total = sum(weights)
    budgets = [int(cfg.num_slots * w / total) for w in weights]
    budgets[0] += cfg.num_slots - sum(budgets)
    return budgets


def detect_and_describe_multiscale(img, cfg: DetectorConfig,
                                   levels: int = 2, subpixel: bool = True):
    """Pyramid detection + per-level description into one slot tensor.

    Returns (Keypoints in fractional level-0 coordinates, descriptors
    (..., num_slots, D), scales (num_slots,) int32: each slot's detection
    level, the same for every image of the batch).
    """
    img = img.to(torch.float32)
    pyr = build_pyramid(img, levels)
    budgets = _level_budget(cfg, levels)

    xs, resps, valids, descs, scales = [], [], [], [], []
    for lv, (im_l, slots_l) in enumerate(zip(pyr, budgets)):
        # per-level detector: bin counts halve with the image (the same bin
        # size in level pixels), which keeps the level's corner budget
        # k_l * nbins_l within its slots
        if slots_l < 1:
            continue  # a deeper level got no slot budget at all
        nbinx_l = max(1, cfg.nbinx >> lv)
        nbiny_l = max(1, cfg.nbiny >> lv)
        while nbinx_l * nbiny_l > max(slots_l, 1):  # coarsen further
            if nbinx_l >= nbiny_l and nbinx_l > 1:
                nbinx_l = max(1, nbinx_l // 2)
            else:
                nbiny_l = max(1, nbiny_l // 2)
        nbins_l = nbinx_l * nbiny_l
        k_l = max(1, min(cfg.corners_per_bin, slots_l // nbins_l))
        cfg_l = dataclasses.replace(
            cfg, max_features=k_l * nbins_l,
            nbinx=nbinx_l, nbiny=nbiny_l, num_slots=slots_l,
            pyramid_levels=1, subpixel=False,
        )
        kp_l = detect_harris_binned(im_l, cfg_l)
        if subpixel:
            resp_l = harris_response(im_l, cfg.block_size, cfg.aperture,
                                     cfg.harris_k)
            kp_l = subpixel_refine(resp_l, kp_l)
        d_l = extract_descriptors(im_l, kp_l, cfg_l)
        # level-0 coordinates: with average pooling the pixel centres
        # align at x0 = x * 2^l + (2^l - 1) / 2
        scale = 2.0 ** lv
        offset = (scale - 1.0) / 2.0
        xs.append(kp_l.xy * scale + offset)
        resps.append(kp_l.response)
        valids.append(kp_l.valid)
        descs.append(d_l)
        scales.append(torch.full((slots_l,), lv, dtype=torch.int32,
                                 device=img.device))

    kp = Keypoints(xy=torch.cat(xs, dim=-2), response=torch.cat(resps, -1),
                   valid=torch.cat(valids, dim=-1))
    return kp, torch.cat(descs, dim=-2), torch.cat(scales)
