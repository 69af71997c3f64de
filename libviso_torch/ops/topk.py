"""Exact top-k with lowest-index ties (port of the semantics of
``libviso_tpu/ops/topk.py`` and of ``lax.top_k``).

``torch.topk`` promises no order among equal values on CUDA, but the
detector's flat bins hold equal |response| values and the slot order is
part of the result.  k rounds of ``argmax`` (which returns the first
maximum) + mask give the JAX order on every device.  As in the JAX
package's ``topk_auto``, a row whose remaining values are all -inf yields
index 0 again.  ``topk_sorted`` is ``lax.top_k`` itself: such a row
yields its remaining indices in ascending order.
"""

from __future__ import annotations

import torch


def topk_iterative(x, k: int):
    """Row-wise (values, indices) of the k largest entries of the last
    axis, equal values in ascending-index order."""
    vals, idxs = [], []
    b = x
    neg_inf = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    for _ in range(k):
        i = torch.argmax(b, dim=-1, keepdim=True)
        vals.append(torch.gather(b, -1, i)[..., 0])
        idxs.append(i[..., 0])
        b = b.scatter(-1, i, neg_inf.expand_as(i))
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def topk_sorted(x, k: int):
    """Row-wise (values, indices) of the k largest entries of the last
    axis with ``lax.top_k``'s semantics: equal values, -inf included, in
    ascending-index order.  A stable descending sort, truncated."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def first_argmax(x, dim: int = -1):
    """Index of the largest value along ``dim``, the lowest index among
    equal maxima, as JAX's argmax, on every device."""
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device).reshape(
        (n,) + (1,) * (x.dim() - 1 - (dim % x.dim())))
    return torch.where(x == x.amax(dim, keepdim=True), idx, n).amin(dim)
