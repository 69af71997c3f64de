"""Fixed-shape masked robust statistics (port of
``libviso_tpu/utils/stats.py``).

Padded slot tensors mean a reduction must ignore invalid rows without a
dynamic shape: sort with +inf padding and index by the valid count, a
tensor index, so that nothing waits for the host.
"""

from __future__ import annotations

import torch


def masked_quantile(x, valid, q):
    """q-quantile of ``x`` (..., N) over ``valid`` slots along the last
    axis: nearest rank ``int(q * (n - 1))``, truncated toward zero and
    clipped; +inf where no slot is valid.  q = 0.5 is the median."""
    n = valid.sum(-1, keepdim=True).to(torch.int32)
    xs = torch.sort(torch.where(valid, x, float("inf")), dim=-1).values
    # as the JAX package: q * (n - 1) in x's dtype, cast toward zero
    k = (q * (n - 1).to(x.dtype)).to(torch.int32)
    k = torch.clamp(k, 0, x.shape[-1] - 1).long()
    return torch.gather(xs, -1, k)[..., 0]


def masked_median(x, valid):
    return masked_quantile(x, valid, 0.5)


def masked_median_abs(x, valid):
    """Median of |x| over ``valid`` slots: the MAD building block."""
    return masked_median(x.abs(), valid)
