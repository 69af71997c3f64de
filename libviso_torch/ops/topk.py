"""Small-k exact top-k with lowest-index ties (port of the semantics of
``libviso_tpu/ops/topk.py``).

``torch.topk`` promises no order among equal values on CUDA, but the
detector's flat bins hold equal |response| values and the slot order is
part of the result.  k rounds of ``argmax`` (which returns the first
maximum) + mask give the JAX order on every device.  As in the JAX
package, a row whose remaining values are all -inf yields index 0 again.
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
