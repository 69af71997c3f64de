#!/usr/bin/env python3
"""Does a row of the pose solve come out the same in a batch as alone?

  python3 tools/batch_invariance.py [--streams 4] [--frames 4]

Runs from the repository root on one CUDA card.  It builds the solve's
inputs of S KITTI-size synthetic streams (front-end, matcher and
correspondences of the serving step, metric l1), then holds, for every
timestep:

  1. ``ransac_pose`` on the stack of S problems against the S calls on one
     problem each, and against sub-batches (one row, two rows, three rows
     in another order): every field, the largest absolute difference;
  2. the operations of one Gauss-Newton step at the refit's shapes and at
     the hypothesis fits', batched against alone: the rotated points, the
     residuals and the Jacobian, the normal equations as matrix products
     and as ``gauss_newton._tree_sum`` does them, and the Cholesky solve;

and times the batched solve against the S solo solves (host clock, a
synchronise at each end, 5 repeats).  A difference other than 0 in part 1
is a failure: the script exits 1.  Part 2 is the evidence for the design:
it names the operations that a library sums differently for a lane in a
batch than alone.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libviso_torch.config import Calib, PipelineConfig  # noqa: E402
from libviso_torch.geometry.mvg import F_from_P_host  # noqa: E402
from libviso_torch.geometry.se3 import euler_to_rotation  # noqa: E402
from libviso_torch.ops.matching import match_frame_triple  # noqa: E402
from libviso_torch.pipeline import multistream  # noqa: E402
from libviso_torch.pipeline.stereo import (  # noqa: E402
    build_frontend,
    empty_state,
    gather_correspondences,
)
from libviso_torch.solvers import gauss_newton as gn  # noqa: E402
from libviso_torch.solvers import ransac  # noqa: E402
from libviso_torch.solvers.ransac import (  # noqa: E402
    frame_generator,
    sample_gumbel,
)
from libviso_torch.synthetic import generate_sequence  # noqa: E402

KITTI = dict(num_points=900, width=1241, height=376, f=718.856,
             base=0.5371657, speed=0.8)


def solve_inputs(S, T, device):
    """Per timestep 1..T-1 the S-stacked SolveInput, with the (S,)
    calibration and the list of float calibrations."""
    seqs = [generate_sequence(num_frames=T, seed=s, **KITTI)
            for s in range(S)]
    cfg = PipelineConfig().with_metric("l1")
    calibs = [Calib.from_projections(q.P1, q.P2) for q in seqs]
    F = torch.as_tensor(np.stack([F_from_P_host(q.P1, q.P2) for q in seqs]),
                        dtype=torch.float32, device=device)
    frontend = build_frontend(cfg)
    states = multistream.stack_states([empty_state(cfg, device)
                                       for _ in range(S)])
    calib = multistream.stream_calib(calibs, device)
    out = []
    for t in range(T):
        ims = [torch.tensor(np.stack([np.asarray(q.frames[t][v])
                                      for q in seqs]), device=device)
               for v in (0, 1)]
        feats = frontend(*ims)
        matches = match_frame_triple(
            feats.kp1, feats.d1, feats.kp2, feats.d2, states.kp1, states.d1,
            states.kp2, states.d2, cfg.stereo_match, cfg.temporal_match, F,
            backend="fused")
        states, si, _ = gather_correspondences(calib, feats, states,
                                               *matches)
        if t > 0:
            out.append(si)
    return cfg, calib, calibs, out


def worst(batched, singles):
    return max(float((batched[i].float() - singles[i].float()).abs().max())
               for i in range(len(singles)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("batch_invariance: torch sees no CUDA device")
    dev = "cuda"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    S = args.streams
    cfg, calib, calibs, sis = solve_inputs(S, args.frames, dev)
    rc = cfg.ransac
    H, N = rc.num_hypotheses, cfg.detector.num_slots
    fields = (calib.f, calib.cu, calib.cv, calib.base)

    failed = False
    for t, si in enumerate(sis, start=1):
        g = torch.stack([sample_gumbel((H, N), frame_generator(s, t))
                         for s in range(S)]).to(dev)
        whole = ransac.ransac_pose(si.Xp, si.obs, si.pts_valid, calib, rc,
                                   gumbel=g)
        alone = [ransac.ransac_pose(si.Xp[i], si.obs[i], si.pts_valid[i],
                                    calibs[i], rc, gumbel=g[i])
                 for i in range(S)]
        diffs = {f: worst(getattr(whole, f), [getattr(r, f) for r in alone])
                 for f in whole._fields}
        for rows in ([0], [1, S - 1], list(range(S - 1))[::-1]):
            ix = torch.tensor(rows, device=dev)
            sub = ransac.ransac_pose(
                si.Xp[ix], si.obs[ix], si.pts_valid[ix],
                Calib(*(c[ix] for c in fields)), rc, gumbel=g[ix])
            diffs[f"tr, rows {rows}"] = worst(sub.tr,
                                              [whole.tr[i] for i in rows])
        failed |= any(d != 0.0 for d in diffs.values())
        print(f"[solve] timestep {t}: batch of {S} against alone, largest "
              f"|difference| per field: {diffs}; inliers "
              f"{whole.num_inliers.tolist()}")

    # one Gauss-Newton step's operations, batched against alone
    si = sis[-1]
    cal = calib.on(dev)
    alone_cal = [c.on(dev) for c in calibs]
    tr = whole.tr
    w = si.pts_valid.float()
    R = euler_to_rotation(tr[..., :3])
    ops = {"X @ R' (S, N, 3) x (S, 3, 3)": worst(
        si.Xp @ R.transpose(-1, -2),
        [si.Xp[i] @ R[i].T for i in range(S)])}
    r, J, _ = gn.residual_jacobian(tr, si.Xp, si.obs, cal)
    rj = [gn.residual_jacobian(tr[i], si.Xp[i], si.obs[i], alone_cal[i])
          for i in range(S)]
    ops["residuals"] = worst(r, [x[0] for x in rj])
    ops["Jacobian"] = worst(J, [x[1] for x in rj])
    Jm = (J * w[..., None, None]).flatten(-3, -2)
    Jf = J.flatten(-3, -2)
    A = Jm.transpose(-1, -2) @ Jf
    ops[f"J' W J as a matrix product, {Jf.shape[-2]} rows"] = worst(
        A, [Jm[i].T @ Jf[i] for i in range(S)])
    prod = Jm[..., :, :, None] * Jf[..., :, None, :]
    ops["J' W J as a broadcast product and torch.sum"] = worst(
        prod.sum(-3), [prod[i].sum(-3) for i in range(S)])
    ops["J' W J by gauss_newton._tree_sum"] = worst(
        gn._tree_sum(prod, -3), [gn._tree_sum(prod[i], -3) for i in range(S)])
    At, bt = gn._normal_equations(J, r, w)
    ops["tree against matrix product, relative"] = float(
        (At - A).abs().max() / A.abs().max())
    step, _ = gn._solve_spd6(At, bt)
    ops["_solve_spd6"] = worst(step, [gn._solve_spd6(At[i], bt[i])[0]
                                      for i in range(S)])
    L = torch.linalg.cholesky_ex(At)[0]
    ops["cholesky_ex, a batch against one matrix"] = worst(
        L, [torch.linalg.cholesky_ex(At[i])[0] for i in range(S)])
    # the hypothesis fits' shapes: (S, H, 3 points)
    scores = torch.where(si.pts_valid[:, None, :], g,
                         torch.full_like(g, float("-inf")))
    from libviso_torch.ops.topk import topk_iterative

    _, idx = topk_iterative(scores, rc.model_size)
    Xs, obs_s = ransac._take_rows(si.Xp, idx), ransac._take_rows(si.obs, idx)
    tr_h = torch.zeros(S, H, 6, device=dev)
    r2, J2, _ = gn.residual_jacobian(tr_h, Xs, obs_s, cal)
    J2f = J2.flatten(-3, -2)
    ops[f"fit: J' J as a matrix product, {J2f.shape[-2]} rows, "
        f"{S * H} lanes against {H}"] = worst(
        J2f.transpose(-1, -2) @ J2f,
        [J2f[i].transpose(-1, -2) @ J2f[i] for i in range(S)])
    r2f = r2.flatten(-2, -1)[..., None]
    ops["fit: J' r as a matrix-vector product of its own"] = worst(
        J2f.transpose(-1, -2) @ r2f,
        [J2f[i].transpose(-1, -2) @ r2f[i] for i in range(S)])
    J2r = torch.cat([J2f, r2f], dim=-1)
    ops["fit: J' [J | r] as one matrix product"] = worst(
        J2f.transpose(-1, -2) @ J2r,
        [J2f[i].transpose(-1, -2) @ J2r[i] for i in range(S)])
    A2, b2 = gn._normal_equations(J2, r2, torch.ones(S, H, 3, device=dev))
    ops["fit: _solve_spd6"] = worst(
        gn._solve_spd6(A2, b2)[0],
        [gn._solve_spd6(A2[i], b2[i])[0] for i in range(S)])
    for name, d in ops.items():
        print(f"[op] {name}: {d:.3e}")

    def batched():
        return ransac.ransac_pose(si.Xp, si.obs, si.pts_valid, calib, rc,
                                  gumbel=g)

    def one_by_one():
        return [ransac.ransac_pose(si.Xp[i], si.obs[i], si.pts_valid[i],
                                   calibs[i], rc, gumbel=g[i])
                for i in range(S)]

    for name, fn in (("one batched solve", batched),
                     (f"{S} solo solves", one_by_one),
                     ("one batched solve", batched),
                     (f"{S} solo solves", one_by_one)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        print(f"[time] {name}: {(time.perf_counter() - t0) / 5 * 1e3:.3f} "
              f"ms, host clock")
    if failed:
        raise SystemExit("batch_invariance: FAILED: a row of ransac_pose "
                         "differs between a batch and alone")
    print("batch_invariance: every row of ransac_pose is the same in a "
          "batch as alone")


if __name__ == "__main__":
    main()
