"""Tensor-parallel descriptor matching (port of
``libviso_tpu/parallel/tp_matching.py``).

The match-cost matrix is split column-wise over the mesh's ``model``
entries:

  view-1 keypoints/descriptors : on every entry's device
  view-2 keypoints/descriptors : split along slots, N2/k per entry
  (N1, N2/k) gated distances   : each entry on its device (under 'l1' on
                                 the card, one launch of the L1 kernel a
                                 shard)
  row-wise (best, 2nd, argmin) : per shard, then the k triples gathered to
                                 the first entry, merged in closed form
                                 (O(k N1) moved instead of O(N1 N2)), and
                                 the ratio test applied.

The merge keeps the unsharded tie-breaking: the lowest global column
wins, since each shard's argmin takes its first minimum and the merge the
first shard among equals.  Under 'l1' the result equals
``match_descriptors`` bit for bit; under 'l2' the cross products of a
shard may be blocked differently from the whole matrix's.
"""

from __future__ import annotations

import torch

from libviso_torch.config import MatchConfig
from libviso_torch.ops.features import Keypoints
from libviso_torch.ops.matching import (
    MatchResult,
    finalize_match,
    row_two_min,
)


def merge_shard_minima(bests, seconds, idxs):
    """Merge per-shard row triples into global ones.

    Args:
      bests, seconds: (k, N1) per-shard row minima and runners-up.
      idxs: (k, N1) global column indices of the per-shard minima.

    Returns (best, second, idx), each (N1,): what ``two_smallest`` gives
    on the whole matrix.  Among equal minima the first shard wins.
    """
    k = bests.shape[0]
    w = torch.argmin(bests, dim=0, keepdim=True)        # (1, N1) winner
    best = torch.gather(bests, 0, w)[0]
    idx = torch.gather(idxs, 0, w)[0]
    second_within = torch.gather(seconds, 0, w)[0]
    shard = torch.arange(k, device=bests.device)[:, None]
    runner_across = torch.where(shard == w, float("inf"), bests).amin(0)
    return best, torch.minimum(second_within, runner_across), idx


def build_tp_matcher(mesh, cfg: MatchConfig = MatchConfig(),
                     use_F: bool = False, backend: str = "dense",
                     axis: str = "model"):
    """match(kp1, d1, kp2, d2[, F]) -> MatchResult with view-2 slots split
    over the mesh's ``axis`` entries; N2 must divide by their count.  The
    result lies on the first entry's device.  With one entry it is the
    local matcher."""
    devices = mesh.axis_devices(axis)
    k = len(devices)

    def match(kp1: Keypoints, d1, kp2: Keypoints, d2, *maybe_F):
        F = maybe_F[0] if use_F else None
        n2 = d2.shape[0]
        if n2 % k:
            raise ValueError(f"N2={n2} not divisible by the {k} entries of "
                             f"mesh axis {axis!r}")
        n = n2 // k
        bests, seconds, idxs = [], [], []
        for i, dev in enumerate(devices):
            cols = slice(i * n, (i + 1) * n)
            best, second, idx = row_two_min(
                Keypoints(*(x.to(dev) for x in kp1)), d1.to(dev),
                Keypoints(*(x[cols].to(dev) for x in kp2)),
                d2[cols].to(dev), cfg, None if F is None else F.to(dev),
                backend)
            bests.append(best)
            seconds.append(second)
            idxs.append(idx + i * n)
        home = devices[0]
        best, second, idx = merge_shard_minima(
            *(torch.stack([x.to(home) for x in xs])
              for xs in (bests, seconds, idxs)))
        return finalize_match(best, second, idx, kp1.valid.to(home), cfg)

    return match


def tp_match_descriptors(mesh, kp1: Keypoints, d1, kp2: Keypoints, d2,
                         cfg: MatchConfig = MatchConfig(), F=None,
                         backend: str = "dense",
                         axis: str = "model") -> MatchResult:
    """One-shot wrapper around ``build_tp_matcher``."""
    fn = build_tp_matcher(mesh, cfg, use_F=F is not None, backend=backend,
                          axis=axis)
    return fn(kp1, d1, kp2, d2, *(() if F is None else (F,)))
