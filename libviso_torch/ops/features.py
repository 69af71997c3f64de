"""Harris-corner detection and Sobel-patch description.

Port of ``libviso_tpu/ops/features.py``.  Every function takes (..., H, W)
images: a leading axis batches the two views of a stereo pair where the
JAX package vmaps.  Semantics follow OpenCV where the reference depends on
them: separable Sobel pairs, BORDER_REFLECT_101 (``F.pad(mode='reflect')``)
and cornerHarris' derivative scale with an unnormalized box window.  The
separable stencils are shifted multiply-adds in the JAX package's tap
order, so the Harris response rounds as the JAX one does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from libviso_torch.config import DetectorConfig
from libviso_torch.ops.topk import topk_iterative

_SOBEL_SMOOTH = {3: (1.0, 2.0, 1.0), 5: (1.0, 4.0, 6.0, 4.0, 1.0)}
_SOBEL_DERIV = {3: (-1.0, 0.0, 1.0), 5: (-1.0, -2.0, 0.0, 2.0, 1.0)}


class Keypoints(NamedTuple):
    """Fixed-size keypoint tensor (padded; ``valid`` marks real corners)."""

    xy: torch.Tensor        # (..., num_slots, 2) float pixel coords (x, y)
    response: torch.Tensor  # (..., num_slots) |Harris response|
    valid: torch.Tensor     # (..., num_slots) bool


def _reflect_pad(x, r, dim):
    """REFLECT_101 pad of the last two axes' ``dim`` (-2 rows, -1 cols)."""
    pad = (r, r, 0, 0) if dim == -1 else (0, 0, r, r)
    flat = x.reshape(-1, *x.shape[-2:])
    out = F.pad(flat, pad, mode="reflect")
    return out.reshape(*x.shape[:-2], *out.shape[-2:])


def _conv1d(img, kernel, axis):
    """Correlate (..., H, W) with a 1-D kernel along ``axis`` (0 rows,
    1 columns), REFLECT_101 border; zero taps are skipped and unit taps
    are not multiplied, as in the JAX package."""
    dim = axis - 2
    padded = _reflect_pad(img, len(kernel) // 2, dim)
    n = img.shape[dim]
    out = None
    for i, c in enumerate(kernel):
        if c == 0:
            continue
        shifted = padded.narrow(dim, i, n)
        term = shifted if c == 1 else shifted * c
        out = term if out is None else out + term
    return out


def _conv1d_multi(stack, kernels, axis):
    """Correlate a (..., C, H, W) stack with per-channel same-length 1-D
    kernels along ``axis`` (1 rows, 2 columns), REFLECT_101 border; every
    tap is multiplied and added in order, as in the JAX package."""
    dim = axis - 3
    padded = _reflect_pad(stack, len(kernels[0]) // 2, dim)
    n = stack.shape[dim]
    out = None
    for i in range(len(kernels[0])):
        coefs = torch.tensor([kern[i] for kern in kernels],
                             dtype=stack.dtype, device=stack.device)
        term = padded.narrow(dim, i, n) * coefs[:, None, None]
        out = term if out is None else out + term
    return out


def _gauss_taps(sigma: float, truncate: float = 4.0):
    """Normalized truncated-Gaussian taps, the kernel of
    scipy.ndimage.gaussian_filter (``unsharp_mask`` and ``blur_metric``
    were tuned against that operator)."""
    radius = int(truncate * sigma + 0.5)
    raw = [math.exp(-0.5 * (i / sigma) ** 2)
           for i in range(-radius, radius + 1)]
    s = sum(raw)
    return tuple(v / s for v in raw)


def unsharp_mask(img, sigma: float, amount: float):
    """Separable Gaussian unsharp mask of (..., H, W):
    ``img + amount * (img - G(img))`` clipped to [0, 255], REFLECT_101
    border (the defocus mitigation of ``DetectorConfig.sharpen_sigma``)."""
    taps = _gauss_taps(sigma)
    low = _conv1d(_conv1d(img, taps, 0), taps, 1)
    return torch.clamp(img + amount * (img - low), 0.0, 255.0)


def blur_metric(img):
    """Per-image defocus measure of (..., H, W) -> (...): the normalized
    gradient energy ``sqrt(mean |grad G1(I)|^2) / std(G1(I))`` of the
    sigma-1-smoothed image (the trigger of
    ``DetectorConfig.sharpen_auto``).  The deviation is the population
    one, as ``jnp.std``."""
    taps = _gauss_taps(1.0)
    sm = _conv1d(_conv1d(img, taps, 0), taps, 1)
    gx = sm[..., :, 1:] - sm[..., :, :-1]
    gy = sm[..., 1:, :] - sm[..., :-1, :]
    ge = torch.sqrt((gx * gx).mean((-2, -1)) + (gy * gy).mean((-2, -1)))
    return ge / (sm.std((-2, -1), unbiased=False) + 1e-6)


def sobel_derivatives(img, ksize=3, dx=True, scale=1.0):
    """OpenCV-compatible Sobel derivative of (..., H, W): d/dx when
    ``dx`` (the descriptor's signal), else d/dy."""
    smooth = _SOBEL_SMOOTH[ksize]
    deriv = _SOBEL_DERIV[ksize]
    if dx:
        out = _conv1d(_conv1d(img, deriv, axis=1), smooth, axis=0)
    else:
        out = _conv1d(_conv1d(img, deriv, axis=0), smooth, axis=1)
    if scale != 1.0:
        out = out * scale
    return out


def harris_response(img, block_size=3, aperture=5, k=0.04,
                    input_is_8bit=True):
    """Harris corner response of (..., H, W), cv::cornerHarris semantics:
    R = det(M) - k trace(M)^2 with M the box-summed structure tensor."""
    scale = 1.0 / ((1 << (aperture - 1)) * block_size)
    if input_is_8bit:
        scale /= 255.0
    scale = torch.tensor(scale, dtype=img.dtype, device=img.device)
    smooth = _SOBEL_SMOOTH[aperture]
    deriv = _SOBEL_DERIV[aperture]
    s1 = _conv1d_multi(torch.stack([img, img], dim=-3), [deriv, smooth],
                       axis=2)
    d = _conv1d_multi(s1, [smooth, deriv], axis=1)
    dx = d[..., 0, :, :] * scale
    dy = d[..., 1, :, :] * scale
    prods = torch.stack([dx * dx, dx * dy, dy * dy], dim=-3)
    ones = [(1.0,) * block_size] * 3
    s = _conv1d_multi(_conv1d_multi(prods, ones, 1), ones, 2)
    sxx, sxy, syy = s[..., 0, :, :], s[..., 1, :, :], s[..., 2, :, :]
    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return det - k * trace * trace


def detect_harris_binned(img, cfg: DetectorConfig = DetectorConfig(),
                         zero_eps=1e-30) -> Keypoints:
    """Spatially uniform Harris corners: per-bin top-k of |response|.

    The image is cropped to ``nbin * floor(size / nbin)`` on each axis and
    cut into nbiny x nbinx bins; each keeps its ``corners_per_bin``
    largest |response| pixels (ties to the lowest index).  With
    ``cfg.nms_radius`` > 0 only local maxima of |response| within that
    radius compete (tied maxima all stay).  Slots come in (biny, binx, k)
    order; slots past the detected corners, and zero responses, have
    ``valid=False`` and coordinates (0, 0).
    """
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    resp = harris_response(img, cfg.block_size, cfg.aperture, cfg.harris_k)
    sy, sx = H // cfg.nbiny, W // cfg.nbinx
    k = cfg.corners_per_bin
    nbins = cfg.nbiny * cfg.nbinx
    a = resp[..., : cfg.nbiny * sy, : cfg.nbinx * sx].abs()
    if cfg.nms_radius > 0:
        # window max of the cropped response; max_pool2d pads with -inf
        w = 2 * cfg.nms_radius + 1
        pooled = F.max_pool2d(a.reshape(-1, 1, *a.shape[-2:]), w, stride=1,
                              padding=cfg.nms_radius).reshape(a.shape)
        a = torch.where(a >= pooled, a, torch.zeros_like(a))
    bins = a.reshape(*lead, cfg.nbiny, sy, cfg.nbinx, sx).transpose(-3, -2)
    vals, flat_idx = topk_iterative(bins.reshape(*lead, nbins, sy * sx), k)

    b = torch.arange(nbins, device=img.device)
    y = (b // cfg.nbinx)[:, None] * sy + flat_idx // sx
    x = (b % cfg.nbinx)[:, None] * sx + flat_idx % sx
    xy = torch.stack([x, y], dim=-1).reshape(*lead, nbins * k, 2).to(
        img.dtype)
    response = vals.reshape(*lead, nbins * k)
    valid = response > zero_eps

    pad = cfg.num_slots - nbins * k
    if pad < 0:
        raise ValueError(
            f"num_slots={cfg.num_slots} < detected budget {nbins * k}")
    xy = F.pad(xy, (0, 0, 0, pad))
    response = F.pad(response, (0, pad))
    valid = F.pad(valid, (0, pad))
    xy = torch.where(valid[..., None], xy, torch.zeros_like(xy))
    return Keypoints(xy=xy, response=response, valid=valid)


def extract_descriptors(img, kp: Keypoints,
                        cfg: DetectorConfig = DetectorConfig()):
    """Sobel-patch descriptors: the (2r+1)^2 window of the horizontal
    Sobel response around each keypoint, zero outside the image, as one
    index gather.  Fractional (subpixel) coordinates round half to even
    onto the integral patch grid.  Returns
    (..., num_slots, descriptor_dim_padded); the 121 -> 128 tail and
    invalid slots are zero."""
    r = cfg.descriptor_radius
    d = 2 * r + 1
    sob = sobel_derivatives(img, ksize=3, dx=True, scale=1.0)
    padded = F.pad(sob, (r, r, r, r))  # zeros outside the image
    Hp, Wp = padded.shape[-2:]
    N = kp.xy.shape[-2]
    x = torch.clamp(torch.round(kp.xy[..., 0]).long(), 0, Wp - d)
    y = torch.clamp(torch.round(kp.xy[..., 1]).long(), 0, Hp - d)
    off = torch.arange(d, device=img.device)
    rows = y[..., :, None] + off                       # (..., N, d)
    cols = x[..., :, None] + off                       # (..., N, d)
    flat = (rows[..., :, :, None] * Wp + cols[..., :, None, :])
    flat = flat.reshape(*flat.shape[:-3], N * d * d)
    desc = torch.gather(padded.reshape(*padded.shape[:-2], Hp * Wp), -1,
                        flat).reshape(*flat.shape[:-1], N, d * d)
    desc = F.pad(desc, (0, cfg.descriptor_dim_padded - d * d))
    return torch.where(kp.valid[..., None], desc, torch.zeros_like(desc))


def detect_and_describe(img, cfg: DetectorConfig = DetectorConfig(),
                        sharpen_gate=None):
    """Detector + descriptor for (..., H, W) images of any real dtype
    (uint8 preferred: a quarter of f32's host-to-device traffic).

    ``sharpen_gate``: optional bool tensor that replaces
    ``sharpen_auto``'s per-image blur decision; its shape broadcasts
    against the images' leading axes.  The stereo front-end passes one
    gate per pair, so that a pair on either side of the trigger never has
    one view sharpened and the other not.
    """
    img = img.to(torch.float32)
    if cfg.sharpen_sigma > 0:
        sharp = unsharp_mask(img, cfg.sharpen_sigma, cfg.sharpen_amount)
        if cfg.sharpen_auto:
            # both are computed and one selected: no host sync, and a
            # sharp frame passes through unchanged
            gate = (blur_metric(img) < cfg.sharpen_trigger
                    if sharpen_gate is None else sharpen_gate)
            img = torch.where(gate[..., None, None], sharp, img)
        else:
            img = sharp
    if cfg.pyramid_levels > 1:
        from libviso_torch.ops.pyramid import detect_and_describe_multiscale

        kp, desc, _ = detect_and_describe_multiscale(
            img, cfg, levels=cfg.pyramid_levels, subpixel=cfg.subpixel)
        return kp, desc
    kp = detect_harris_binned(img, cfg)
    if cfg.subpixel:
        from libviso_torch.ops.pyramid import subpixel_refine

        resp = harris_response(img, cfg.block_size, cfg.aperture,
                               cfg.harris_k)
        kp = subpixel_refine(resp, kp)
    return kp, extract_descriptors(img, kp, cfg)
