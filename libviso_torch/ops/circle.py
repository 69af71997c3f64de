"""Circular-consistency match filter (port of ``libviso_tpu/ops/circle.py``).

A match list is an (..., N) integer tensor over view-1 slots holding the
matched view-2 slot or -1; leading dims index independent streams.  The
loop left -> right -> right_prev -> left_prev -> left is a composition of
these partial maps: three gathers and one equality test.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CircleResult(NamedTuple):
    valid: torch.Tensor       # (..., N) bool over current-left slots
    right: torch.Tensor       # (..., N) current-right slot (match_lr)
    left_prev: torch.Tensor   # (..., N) previous-left slot (match11)
    right_prev: torch.Tensor  # (..., N) previous-right slot
    count: torch.Tensor       # (...) number of circular matches


def _safe_gather(table, idx):
    """table[..., idx] with -1 indices mapping to -1."""
    safe = torch.clamp(idx, 0, table.shape[-1] - 1)
    return torch.where(idx >= 0, torch.gather(table, -1, safe), -1)


def circle_filter(match_lr, match_lr_prev, match11, match22) -> CircleResult:
    """Keep current-left slots l whose loop closes: with r = match_lr[l],
    lp = match11[l] and rp = match_lr_prev[lp], require match22[r] == rp.
    """
    r, lp = match_lr, match11
    rp = _safe_gather(match_lr_prev, lp)
    r_to_rp = _safe_gather(match22, r)
    valid = (r >= 0) & (lp >= 0) & (rp >= 0) & (r_to_rp == rp)
    return CircleResult(
        valid=valid,
        right=torch.where(valid, r, -1),
        left_prev=torch.where(valid, lp, -1),
        right_prev=torch.where(valid, rp, -1),
        count=valid.sum(-1),
    )
