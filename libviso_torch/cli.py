"""Command-line entry points of the PyTorch port (port of ``libviso_tpu/cli.py``).

  python -m libviso_torch.cli synth [--frames N] [--world | --world-loop]
      [--metric l1|l2|l2q8]
  python -m libviso_torch.cli kitti RESULT_SHA SEQ[,SEQ...] [BEGIN END]
      [--kitti-home DIR]        (default $KITTI_HOME)
      [--checkpoint-every N] [--save-debug]
      [--loop-closure [--keyframe-every N] [--loop-min-gap G] ...]
      [--ba-window W [--ba-stride S] [--ba-no-gate] ...]
                                (several sequences: each in turn)
  python -m libviso_torch.cli serve RESULT_SHA SEQ,SEQ[,...] [--pool N]
      [--begin B] [--end E] [--checkpoint-every N]
                                (several sequences, one step for all)
  python -m libviso_torch.cli mono [--image-mask MASK] [--calib K.txt]
      [--begin B] [--end E] [--out POSES] [--method 5pt|8pt] ...
      [--sim3-loop [--kf-every N] [--loop-min-gap G]]
                                (default $CBT_HOME/img-%04d.jpg from frame 1
                                 and $CBT_HOME/calib.txt)
  python -m libviso_torch.cli eval EST GT [--delta D] [--align A] [--plot P]

The subcommands take ``--device`` (default ``cuda``); ``--device cuda`` on a
machine without a card raises: CPU runs ask for ``--device cpu``.
``--backend`` picks the matcher route:
- ``dense`` (default): the distance matrix, then gates and row minima in
  PyTorch; with ``--metric l1`` on the card the matrix is the hand-written
  L1 kernel.  The JAX CLI's ``xla`` and ``pallas`` both correspond to it;
- ``fused``: one fused CUDA kernel for gates, L1 and row minima;
- ``sweep``: the fused kernel on x-sorted slots, skipping target tiles
  beyond the radius.
``fused`` and ``sweep`` compute L1 only and need ``--metric l1``.  The
pipeline flags (``--subpixel``, ``--pyramid``, ``--sharpen``,
``--sharpen-amount``, ``--sharpen-auto``, ``--nms``, ``--keep-on-failure``,
``--chunk``) and the health flags are the JAX CLI's, with its defaults.
``mono`` takes the JAX CLI's flags and, like the others, ``--device``,
``--metric`` and ``--backend``.  Loop closure (``kitti --loop-closure``,
``pipeline/loop.py``), windowed bundle adjustment (``kitti --ba-window``,
``pipeline/windowed.py``; with ``--loop-closure`` the composed back-end,
``pipeline/ba_loop.py``) and the mono Sim(3) back-end (``mono
--sim3-loop``, ``pipeline/mono_loop.py``) take the JAX CLI's flags and
print its JSON keys.  ``kitti`` first joins the process group that the
``VISO_COORDINATOR``/``VISO_NUM_PROCESSES``/``VISO_PROCESS_ID`` variables
describe (``parallel/distributed.py``), a no-op when they are unset.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

def _add_common_flags(parser):
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; without a card this raises: "
             "CPU runs ask for --device cpu)")
    parser.add_argument(
        "--metric", default=None, choices=["l1", "l2", "l2q8"],
        help="descriptor distance: l2 (the config default), l2q8 (l2 over "
             "int8-quantized descriptors) or l1, the reference metric, "
             "which runs the hand-written CUDA kernel on the card")
    parser.add_argument(
        "--hyp", default=None, choices=["gn", "procrustes"],
        help="RANSAC hypothesis estimator (default procrustes)")
    parser.add_argument(
        "--backend", default="dense", choices=["dense", "fused", "sweep"],
        help="matcher route: dense (distance matrix, then gates and row "
             "minima; the JAX CLI's xla and pallas both correspond to it on "
             "the card), fused (one fused L1 kernel) or sweep (the fused "
             "kernel on x-sorted slots); fused and sweep need --metric l1")
    parser.add_argument(
        "--subpixel", action="store_true",
        help="quadratic subpixel corner refinement")
    parser.add_argument(
        "--pyramid", type=int, default=None, metavar="L",
        help="multi-scale detection over L pyramid levels")
    parser.add_argument(
        "--sharpen", type=float, default=None, metavar="SIGMA",
        help="unsharp-mask preconditioner for defocused imagery: Gaussian "
             "sigma in px.  Enable when the per-frame `sharpness` stat "
             "collapses")
    parser.add_argument(
        "--sharpen-amount", type=float, default=None, metavar="A",
        help="high-pass gain for --sharpen (default 4.0)")
    parser.add_argument(
        "--sharpen-auto", action="store_true",
        help="with --sharpen: apply the mask only on frames whose blur "
             "metric says they are defocused (sharp frames pass through "
             "unchanged; alone it implies --sharpen 3)")
    parser.add_argument(
        "--chunk", type=int, default=1, metavar="K",
        help="frames per upload: K>1 uploads K frames as one stack and "
             "steps them in order; the same trajectory bit for bit, results "
             "K frames at a time; debug runs force K=1")
    parser.add_argument(
        "--nms", type=int, default=None, metavar="R",
        help="non-max suppression radius in px before the per-bin top-k: "
             "only local maxima compete for the bin's slots (0 = the "
             "reference's raw winners)")
    parser.add_argument(
        "--keep-on-failure", action="store_true",
        help="transient-dropout recovery: on a failed solve, keep the last "
             "good frame's features as the match target so the next frame "
             "recovers the spanning motion (streaming mode only)")


def _add_health_flags(parser):
    """Run-level health-alarm thresholds, shared by every subcommand that
    prints a `health` block."""
    from libviso_torch.config import HealthConfig

    d = HealthConfig()
    parser.add_argument(
        "--support-ratio-alarm", type=float,
        default=d.support_ratio_alarm, metavar="R",
        help="alarm when min per-frame num_inliers/num_circle over the "
             "run drops below R (default %(default)s)")
    parser.add_argument(
        "--motion-jump-alarm", type=float,
        default=d.motion_jump_alarm, metavar="J",
        help="alarm when the max weighted 6-dof delta between consecutive "
             "accepted motions exceeds J (default %(default)s)")


def _health_cfg(args):
    from libviso_torch.config import HealthConfig

    d = HealthConfig()
    return HealthConfig(
        support_ratio_alarm=getattr(args, "support_ratio_alarm",
                                    d.support_ratio_alarm),
        motion_jump_alarm=getattr(args, "motion_jump_alarm",
                                  d.motion_jump_alarm))


def _config(args):
    """PipelineConfig with the flags applied; None means the flag was not
    given and the config default stays."""
    import dataclasses

    from libviso_torch.config import PipelineConfig

    cfg = PipelineConfig()
    if args.metric is not None:
        cfg = cfg.with_metric(args.metric)
    if args.hyp is not None:
        cfg = dataclasses.replace(
            cfg, ransac=dataclasses.replace(cfg.ransac,
                                            hypothesis_method=args.hyp))
    det = {}
    if args.subpixel:
        det["subpixel"] = True
    if args.pyramid is not None:
        det["pyramid_levels"] = args.pyramid
    if args.sharpen is not None:
        det["sharpen_sigma"] = args.sharpen
    if args.sharpen_amount is not None:
        det["sharpen_amount"] = args.sharpen_amount
    if args.sharpen_auto:
        det["sharpen_auto"] = True
        # --sharpen-auto alone must protect, not do nothing: default to
        # sigma 3; an explicit --sharpen 0 still errors in the config
        det.setdefault("sharpen_sigma", 3.0)
    if args.nms is not None:
        det["nms_radius"] = args.nms
    if det:
        cfg = dataclasses.replace(
            cfg, detector=dataclasses.replace(cfg.detector, **det))
    if args.keep_on_failure:
        cfg = dataclasses.replace(cfg, keep_features_on_failure=True)
    return cfg


def _checkpoint_manager(directory, every):
    if every <= 0:
        return None
    from libviso_torch.utils.checkpoint import CheckpointManager

    return CheckpointManager(directory, every=every)


def _cmd_kitti(args):
    from libviso_torch.parallel.distributed import initialize_from_env
    from libviso_torch.pipeline.stereo import run_stereo_sequence

    initialize_from_env()   # the multi-process launch contract
    if args.keep_on_failure and args.ba_window > 0:
        # at the argv edge, before any frame is read
        sys.exit("--keep-on-failure is a streaming-mode feature and "
                 "cannot combine with --ba-window (the batched windows "
                 "match all frame pairs in parallel)")
    if "," in args.seq:
        if args.loop_closure:
            sys.exit("--loop-closure takes one sequence")
        # several sequences: each in turn, one JSON line each
        import copy

        for name in args.seq.split(","):
            sub = copy.copy(args)
            sub.seq = name
            _cmd_kitti(sub)
        return
    if args.ba_window > 0:
        _kitti_ba(args)
        return
    if args.loop_closure:
        _kitti_loop(args)
        return
    cfg = _config(args)
    kitti_home = args.kitti_home or os.environ.get("KITTI_HOME")
    if not kitti_home:
        sys.exit("KITTI_HOME not set (flag --kitti-home or env)")
    stream, P1, P2 = _open_sequence(kitti_home, args.seq, args.begin,
                                    args.end)
    result_dir = os.path.join(kitti_home, "results", args.seq,
                              args.result_sha)

    t0 = time.perf_counter()
    res = run_stereo_sequence(
        stream, P1, P2, cfg, seed=args.seed, device=args.device,
        backend=args.backend, chunk=args.chunk,
        checkpoint=_checkpoint_manager(
            os.path.join(result_dir, "checkpoints"), args.checkpoint_every),
        fingerprint_scope=f"{args.seq}:{args.begin}:{args.end}",
        dbg_dir=os.path.join(result_dir, "dbg") if args.save_debug else None)
    dt = time.perf_counter() - t0
    out = _write_results(kitti_home, args.result_sha, args.seq, res,
                         _health_cfg(args))
    n = len(res.poses)
    # frames per second over the frames computed in this run: a resumed
    # run does not claim the restored ones
    print(json.dumps({
        "sequence": args.seq, "frames": n, "device": args.device,
        "solved": out["solved"],
        "fps": res.processed / dt if dt > 0 else None,
        "poses": out["poses"], "health": out["health"],
    }))


def _kitti_loop(args):
    """``kitti --loop-closure``: streaming VO, revisit detection and the
    pose graph (``pipeline/loop.py``); loop checkpoints go under
    checkpoints/loop, apart from the frame-mode ones.  metrics.jsonl gets
    the per-frame stats and one ``loop_candidate`` row per verification;
    the output JSON adds ``loops`` and ``graph_cost``."""
    from libviso_torch.pipeline.loop import run_with_loop_closure

    cfg = _config(args)
    kitti_home = args.kitti_home or os.environ.get("KITTI_HOME")
    if not kitti_home:
        sys.exit("KITTI_HOME not set (flag --kitti-home or env)")
    stream, P1, P2 = _open_sequence(kitti_home, args.seq, args.begin,
                                    args.end)
    result_dir = os.path.join(kitti_home, "results", args.seq,
                              args.result_sha)
    t0 = time.perf_counter()
    res = run_with_loop_closure(
        stream, P1, P2, cfg, keyframe_every=args.keyframe_every,
        min_gap=args.loop_min_gap, min_matches=args.loop_min_matches,
        min_inliers=args.loop_min_inliers, robust=args.loop_robust,
        eviction=args.loop_eviction, seed=args.seed, backend=args.backend,
        device=args.device,
        checkpoint=_checkpoint_manager(
            os.path.join(result_dir, "checkpoints", "loop"),
            args.checkpoint_every),
        fingerprint_scope=f"{args.seq}:{args.begin}:{args.end}",
        dbg_dir=os.path.join(result_dir, "dbg") if args.save_debug else None)
    dt = time.perf_counter() - t0
    # every verification attempt, accepted or not (threshold tuning needs
    # the rejected ones)
    res.stats = res.stats + [{"loop_candidate": c} for c in res.candidates]
    out = _write_results(kitti_home, args.result_sha, args.seq, res,
                         _health_cfg(args))
    print(json.dumps({
        "sequence": args.seq, "frames": len(res.poses),
        "device": args.device, "solved": out["solved"],
        "fps": res.processed / dt if dt > 0 else None,
        "poses": out["poses"], **_loop_keys(res), "health": out["health"],
    }))


def _loop_keys(res):
    """The output JSON's ``loops`` (each verified edge with its final
    robust weight) and ``graph_cost`` of a loop-closing run."""
    return {
        "loops": [{"new": le.frame_new, "old": le.frame_old,
                   "inliers": le.num_inliers,
                   "edge_scale": float(res.loop_edge_scale[i])}
                  for i, le in enumerate(res.loops)],
        "graph_cost": list(res.graph_cost)}


def _kitti_ba(args):
    """``kitti --ba-window W``: windowed bundle adjustment
    (``pipeline/windowed.py``), or with ``--loop-closure`` the composed
    BA + loop back-end (``pipeline/ba_loop.py``); checkpoints go under
    checkpoints/ba or checkpoints/ba_loop, every N completed windows.  The
    output JSON adds ``ba_windows`` and ``ba_improved`` (windows accepted
    whose cost fell), and in composed mode ``loops`` and ``graph_cost``;
    metrics.jsonl gets the frames' ok flags and, composed, one
    ``loop_candidate`` row per verification."""
    from libviso_torch.config import BAConfig

    cfg = _config(args)
    kitti_home = args.kitti_home or os.environ.get("KITTI_HOME")
    if not kitti_home:
        sys.exit("KITTI_HOME not set (flag --kitti-home or env)")
    stream, P1, P2 = _open_sequence(kitti_home, args.seq, args.begin,
                                    args.end)
    result_dir = os.path.join(kitti_home, "results", args.seq,
                              args.result_sha)
    stride = (args.ba_stride if args.ba_stride > 0
              else max(args.ba_window // 2, 1))
    margin = ({} if args.ba_gate_margin is None
              else {"gate_margin": args.ba_gate_margin})
    ba = BAConfig(window=args.ba_window, stride=stride,
                  outlier_px=args.ba_outlier_px, rerank_px=args.ba_rerank_px,
                  prior_strength=args.ba_prior,
                  min_cam_obs=args.ba_min_cam_obs, gate=not args.ba_no_gate,
                  holdout_modulus=args.ba_holdout, **margin)
    mode = "ba_loop" if args.loop_closure else "ba"
    common = dict(
        seed=args.seed, backend=args.backend, device=args.device,
        checkpoint=_checkpoint_manager(
            os.path.join(result_dir, "checkpoints", mode),
            args.checkpoint_every),
        fingerprint_scope=f"{args.seq}:{args.begin}:{args.end}",
        dbg_dir=os.path.join(result_dir, "dbg") if args.save_debug else None)
    t0 = time.perf_counter()
    if args.loop_closure:
        from libviso_torch.pipeline.ba_loop import run_windowed_ba_loop

        res = run_windowed_ba_loop(
            list(stream), P1, P2, cfg, ba=ba,
            keyframe_every=args.keyframe_every, min_gap=args.loop_min_gap,
            min_matches=args.loop_min_matches,
            min_inliers=args.loop_min_inliers, robust=args.loop_robust,
            eviction=args.loop_eviction, **common)
    else:
        from libviso_torch.pipeline.windowed import run_windowed_ba

        res = run_windowed_ba(list(stream), P1, P2, cfg, ba=ba, **common)
    dt = time.perf_counter() - t0
    stats = [{"frame": t, "ok": bool(ok)} for t, ok in enumerate(res.frame_ok)]
    extra = {"ba_windows": len(res.window_costs),
             "ba_improved": sum(1 for c in res.window_costs
                                if c[2] and c[1] < c[0])}
    if args.loop_closure:
        stats += [{"loop_candidate": c} for c in res.candidates]
        extra.update(_loop_keys(res))
    out = _write_results(kitti_home, args.result_sha, args.seq, res,
                         _health_cfg(args), stats=stats)
    print(json.dumps({
        "sequence": args.seq, "frames": len(res.poses),
        "device": args.device, "solved": out["solved"],
        "fps": res.processed / dt if dt > 0 else None,
        "poses": out["poses"], **extra, "health": out["health"],
    }))


def _open_sequence(kitti_home, name, begin, end):
    """(frame stream, P1, P2) of KITTI sequence ``name``."""
    from libviso_torch.io.kitti import (
        StereoImageStream,
        kitti_sequence_paths,
        load_calib,
    )

    paths = kitti_sequence_paths(kitti_home, name)
    P1, P2 = load_calib(paths["calib"])
    stream = StereoImageStream(
        os.path.join(paths["image_0"], "%06d.png"),
        os.path.join(paths["image_1"], "%06d.png"), begin=begin, end=end)
    return stream, P1, P2


def _write_results(kitti_home, result_sha, name, res, hc, stats=None):
    """Write a sequence's metrics.jsonl and KITTI-format poses under
    results/NAME/RESULT_SHA; returns its summary for the output JSON.
    ``hc`` is the HealthConfig of the alarm thresholds; ``stats`` the
    metrics rows, by default ``res.stats``."""
    from libviso_torch.io.kitti import save_poses_kitti
    from libviso_torch.utils.metrics import MetricsLogger, health_summary

    if stats is None:
        stats = res.stats
    result_dir = os.path.join(kitti_home, "results", name, result_sha)
    os.makedirs(result_dir, exist_ok=True)
    with MetricsLogger(os.path.join(result_dir, "metrics.jsonl")) as ml:
        for s in stats:
            ml.log(s)
    poses_path = os.path.join(result_dir, "data", f"{name}.txt")
    save_poses_kitti(poses_path, res.poses)
    return {
        "sequence": name, "frames": len(res.poses),
        "solved": int(res.frame_ok.sum()), "poses": poses_path,
        "health": health_summary(
            stats, res.frame_ok,
            support_ratio_alarm=hc.support_ratio_alarm,
            motion_jump_alarm=hc.motion_jump_alarm)}


def _cmd_serve(args):
    """Multi-sequence serving: S KITTI sequences advanced in lockstep, one
    step for all (``pipeline/multistream.py``); per-stream results equal
    the solo runs'.  Sequences share one image shape and are held in
    memory.  ``--pool N`` works the sequences through N slots instead,
    re-seeding a finished slot with the next sequence."""
    from libviso_torch.pipeline.multistream import run_multistream

    kitti_home = args.kitti_home or os.environ.get("KITTI_HOME")
    if not kitti_home:
        sys.exit("KITTI_HOME not set (flag --kitti-home or env)")
    if args.chunk > 1:
        # the chunked serving step exists (pipeline/multistream.py::
        # build_multistream_chunk) but this subcommand steps per timestep:
        # refuse rather than ignore
        sys.exit("serve does not take --chunk (streams already share each "
                 "step)")
    seq_names = args.seqs.split(",")
    if len(seq_names) < 2:
        sys.exit("serve wants >=2 sequences (use `kitti` for one)")
    cfg = _config(args)
    if args.pool > 0:
        if args.checkpoint_every > 0:
            sys.exit("--pool does not take --checkpoint-every yet (the "
                     "lockstep mode checkpoints; the pool's slot state "
                     "is transient by design)")
        _serve_pool(args, kitti_home, seq_names, cfg)
        return

    loaded = [_open_sequence(kitti_home, name, args.begin, args.end)
              for name in seq_names]
    loaded = [(list(stream), P1, P2) for stream, P1, P2 in loaded]
    shapes = {frames[0][0].shape for frames, _, _ in loaded}
    if len(shapes) != 1:
        sys.exit(f"sequences must share one image shape, got {shapes}")
    t0 = time.perf_counter()
    results = run_multistream(
        [f for f, _, _ in loaded], [p for _, p, _ in loaded],
        [p for _, _, p in loaded], cfg,
        seeds=[args.seed + s for s in range(len(seq_names))],
        device=args.device, backend=args.backend,
        # one snapshot carries all streams, under a shared _serve
        # directory (the per-sequence result directories hold poses only)
        checkpoint=_checkpoint_manager(
            os.path.join(kitti_home, "results", "_serve", args.result_sha,
                         "checkpoints"), args.checkpoint_every),
        fingerprint_scope=f"{args.seqs}:{args.begin}:{args.end}")
    dt = time.perf_counter() - t0
    hc = _health_cfg(args)
    out = [_write_results(kitti_home, args.result_sha, name, res, hc)
           for name, res in zip(seq_names, results)]
    total = sum(res.processed for res in results)
    print(json.dumps({
        "streams": len(seq_names), "device": args.device,
        "aggregate_fps": total / dt if dt > 0 else None,
        "sequences": out,
    }))


def _serve_pool(args, kitti_home, seq_names, cfg):
    """Fleet serving: a fixed-slot StreamPool works through the queue of
    sequences, writing each one's results when it finishes and re-seeding
    its slot with the next; sequences load when attached, so memory stays
    O(pool)."""
    from libviso_torch.pipeline.multistream import StreamPool

    slots = min(args.pool, len(seq_names))
    pool = StreamPool(cfg, slots=slots, device=args.device,
                      backend=args.backend)
    queue = list(enumerate(seq_names))     # (index, name)
    slot_seq = {}                          # slot -> (index, name)
    t0 = time.perf_counter()

    def attach_next(slot):
        idx, name = queue.pop(0)
        frames, P1, P2 = _open_sequence(kitti_home, name, args.begin,
                                        args.end)
        # sequence i uses seed + i whatever its slot, as in its solo run
        pool.attach(slot, frames, P1, P2, seed=args.seed + idx)
        slot_seq[slot] = (idx, name)

    out = [None] * len(seq_names)
    total = 0
    for s in range(slots):
        attach_next(s)
    # finished slots are re-seeded inside the loop, so a drained slot
    # never idles while others run
    while pool.active() or pool.finished():
        if pool.active():
            pool.step()
        for s in pool.finished():
            idx, name = slot_seq.pop(s)
            res = pool.detach(s)
            out[idx] = _write_results(kitti_home, args.result_sha, name,
                                      res, _health_cfg(args))
            total += len(res.poses)
            if queue:
                attach_next(s)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "streams": len(seq_names), "pool": slots, "device": args.device,
        "aggregate_fps": total / dt if dt > 0 else None,
        "sequences": out,
    }))


def _cmd_synth(args):
    from libviso_torch.pipeline.stereo import run_stereo_sequence
    from libviso_torch.utils.metrics import ate_rmse, rpe_errors

    cfg = _config(args)
    if args.world_loop:
        from libviso_torch.synthetic_world import generate_plaza_sequence

        seq = generate_plaza_sequence(num_frames=args.frames, seed=args.seed)
    elif args.world:
        from libviso_torch.synthetic_world import generate_world_sequence

        seq = generate_world_sequence(num_frames=args.frames, seed=args.seed)
    else:
        from libviso_torch.synthetic import generate_sequence

        seq = generate_sequence(num_frames=args.frames, seed=args.seed)
    t0 = time.perf_counter()
    res = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg,
                              seed=args.seed, device=args.device,
                              backend=args.backend, chunk=args.chunk)
    dt = time.perf_counter() - t0
    terr, rerr = rpe_errors(res.poses, seq.gt_poses)
    print(json.dumps({
        "frames": args.frames, "device": args.device,
        "solved": int(res.frame_ok.sum()),
        "ate_rmse_m": ate_rmse(res.poses, seq.gt_poses),
        "rpe_trans_mean_m": float(terr.mean()),
        "rpe_rot_mean_rad": float(rerr.mean()),
        "fps": args.frames / dt,
    }))


def _cmd_mono(args):
    """Monocular SfM driver: a 3x3 K (or a 3x4 P whose left 3x3 is K) from
    a text file and a printf-style image mask.  With ``CBT_HOME`` set and
    no flags, the calibration is ``$CBT_HOME/calib.txt`` and the images
    ``$CBT_HOME/img-%04d.jpg`` from frame 1."""
    import dataclasses

    import numpy as np

    from libviso_torch.config import MonoConfig, PipelineConfig
    from libviso_torch.io.kitti import MonoImageStream, save_poses_kitti
    from libviso_torch.pipeline.mono import run_mono_sequence

    cbt_home = os.environ.get("CBT_HOME")
    if args.image_mask is None:
        if not cbt_home:
            sys.exit("either --image-mask or CBT_HOME must be set")
        args.image_mask = os.path.join(cbt_home, "img-%04d.jpg")
        if args.begin == 0:
            args.begin = 1
    if args.calib is None:
        if not cbt_home:
            sys.exit("either --calib or CBT_HOME must be set")
        args.calib = os.path.join(cbt_home, "calib.txt")

    overrides = {"method": args.method}
    if args.sampson_thresh is not None:
        overrides["sampson_thresh"] = args.sampson_thresh
    if args.min_good is not None:
        overrides["min_good"] = args.min_good
    if args.rematch_ratio is not None:
        overrides["rematch_ratio"] = args.rematch_ratio
    if args.hypotheses is not None:
        overrides["num_hypotheses"] = args.hypotheses
    if args.no_scale:
        overrides["scale_propagation"] = False
    mono = dataclasses.replace(MonoConfig(), **overrides)

    vals = np.loadtxt(args.calib, dtype=np.float64)
    K = vals.reshape(3, 4)[:, :3] if vals.size == 12 else vals.reshape(3, 3)
    cfg = PipelineConfig.mono()
    if args.metric is not None:
        cfg = cfg.with_metric(args.metric)
    if args.keep_on_failure:
        cfg = dataclasses.replace(cfg, keep_features_on_failure=True)
    stream = MonoImageStream(args.image_mask, begin=args.begin, end=args.end)

    t0 = time.perf_counter()
    summary = {}
    if args.sim3_loop:
        from libviso_torch.pipeline.mono_loop import run_mono_sim3_loop

        res = run_mono_sim3_loop(stream, K, cfg, mono=mono, seed=args.seed,
                                 backend=args.backend, device=args.device,
                                 keyframe_every=args.kf_every,
                                 min_gap=args.loop_min_gap)
        summary = {
            "loops": [{"frame_old": le.frame_old, "frame_new": le.frame_new,
                       "inliers": le.num_inliers,
                       "scale": round(le.s_rel, 4)} for le in res.loops],
            "keyframes": len(res.kf_frames),
            "graph_cost": [round(c, 6) for c in res.graph_cost]}
    else:
        res = run_mono_sequence(stream, K, cfg, seed=args.seed,
                                device=args.device, backend=args.backend,
                                mono=mono)
    dt = time.perf_counter() - t0
    if args.out:
        save_poses_kitti(args.out, res.poses)
    n = len(res.poses)
    print(json.dumps({
        "frames": n, "device": args.device,
        "solved": int(res.frame_ok.sum()),
        "fps": n / dt if dt else None,
        "poses": args.out,
        "note": ("monocular poses are correct up to one global scale "
                 "(relative scale propagated through shared landmarks)"
                 if mono.scale_propagation else
                 "monocular poses are scale-ambiguous (unit-norm steps)"),
        **summary,
    }))


def _cmd_eval(args):
    """Trajectory evaluation between two KITTI-format pose files."""
    import numpy as np

    from libviso_torch.io.kitti import load_poses_kitti
    from libviso_torch.utils.metrics import (
        ate_rmse,
        kitti_trajectory_errors,
        rpe_errors,
    )

    est = load_poses_kitti(args.est)
    gt = load_poses_kitti(args.gt)
    n = min(len(est), len(gt))
    if n < 2:
        sys.exit("need at least 2 poses in both files")
    est, gt = est[:n], gt[:n]
    terr, rerr = rpe_errors(est, gt, delta=args.delta)
    out = {
        "frames": n,
        "ate_rmse_m": ate_rmse(est, gt, align=args.align),
        "rpe_trans_mean_m": float(terr.mean()),
        "rpe_rot_mean_rad": float(rerr.mean()),
    }
    if args.align != "none":
        out["align"] = args.align
        out["ate_rmse_raw_m"] = ate_rmse(est, gt)
    out.update(kitti_trajectory_errors(est, gt))
    if args.plot:
        from libviso_torch.utils.debug_viz import save_trajectory

        out["plot"] = save_trajectory(args.plot, est, gt)
    # NaN (e.g. devkit-style errors on clips shorter than the 100 m
    # segment) is not valid strict JSON: emit null
    out = {k: (None if isinstance(v, float) and np.isnan(v) else v)
           for k, v in out.items()}
    print(json.dumps(out))


def main(argv=None):
    p = argparse.ArgumentParser(prog="libviso_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    k = sub.add_parser("kitti", help="KITTI stereo odometry")
    k.add_argument("result_sha")
    k.add_argument("seq", help="sequence name, or several separated by "
                                "commas, run in turn")
    k.add_argument("begin", nargs="?", type=int, default=0)
    k.add_argument("end", nargs="?", type=int, default=None)
    k.add_argument("--kitti-home")
    k.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="snapshot the loop state every N frames under "
                        "results/.../checkpoints and resume from the latest "
                        "matching checkpoint (0 = off); the files are this "
                        "package's own, not interchangeable with the JAX "
                        "package's checkpoints")
    k.add_argument("--save-debug", action="store_true",
                   help="write per-frame debug artifacts under "
                        "results/.../dbg")
    k.add_argument("--ba-window", type=int, default=0, metavar="W",
                   help="refine with sliding-window bundle adjustment of "
                        "W frames, stride W/2 (0 = off); with "
                        "--loop-closure the composed BA + loop back-end; "
                        "--checkpoint-every then counts windows")
    k.add_argument("--ba-stride", type=int, default=0,
                   help="window start spacing (default 0 = window/2; "
                        "stride < window overlaps consecutive windows)")
    k.add_argument("--ba-prior", type=float, default=1.0,
                   help="cross-window marginalization-prior strength: "
                        "each window's overlap motions are anchored at the "
                        "previous window's refined estimates (0 = "
                        "independent windows)")
    k.add_argument("--ba-outlier-px", type=float, default=30.0,
                   help="BA stage-1 observation gate on initial "
                        "reprojection error [px]")
    k.add_argument("--ba-rerank-px", type=float, default=2.0,
                   help="BA stage-2 re-gate on coarse-solution residuals "
                        "[px]")
    k.add_argument("--ba-no-gate", action="store_true",
                   help="disable the per-window acceptance gate (apply "
                        "every converged window; the gate keeps a window's "
                        "VO motions unless the refinement clearly beats "
                        "them on the gate observations)")
    k.add_argument("--ba-holdout", type=int, default=0, metavar="M",
                   help="gate population: 0 = all tracked observations "
                        "(default); M>1 = hold every M-th landmark out of "
                        "BA and gate on those only")
    k.add_argument("--ba-gate-margin", type=float, default=None,
                   help="clear-win bar: the mean of the two split-half "
                        "paired error ratios (refined/VO) must be <= "
                        "margin.  Default: BAConfig.gate_margin (0.90)")
    k.add_argument("--ba-min-cam-obs", type=int, default=24,
                   help="min post-gate observations per camera for its "
                        "adjacent motions to take the BA refinement")
    k.add_argument("--loop-closure", action="store_true",
                   help="detect revisits and remove accumulated drift with "
                        "pose-graph optimization (one sequence)")
    k.add_argument("--keyframe-every", type=int, default=5,
                   help="loop closure: store a keyframe every N frames")
    k.add_argument("--loop-min-gap", type=int, default=20,
                   help="loop closure: min frame separation for a revisit "
                        "candidate")
    k.add_argument("--loop-min-matches", type=int, default=60,
                   help="loop closure: appearance-match count gate (above "
                        "the aliasing floor)")
    k.add_argument("--loop-min-inliers", type=int, default=30,
                   help="loop closure: refined-verification inlier gate")
    k.add_argument("--loop-robust", default="cauchy",
                   choices=["cauchy", "huber", "none"],
                   help="pose-graph robust kernel on loop edges")
    k.add_argument("--loop-eviction", default="spatial",
                   choices=["spatial", "fifo"],
                   help="full keyframe store: 'spatial' keeps a coverage of "
                        "the trajectory, 'fifo' overwrites the oldest")
    _add_common_flags(k)
    _add_health_flags(k)
    k.set_defaults(fn=_cmd_kitti)

    s = sub.add_parser("synth", help="synthetic-sequence smoke run")
    s.add_argument("--frames", type=int, default=20)
    s.add_argument("--world", action="store_true",
                   help="drive the textured-world renderer instead of the "
                        "sprite oracle: dense perspective-correct street "
                        "frames (slower to render, photograph-like)")
    s.add_argument("--world-loop", action="store_true",
                   help="closed-circuit plaza drive through the world "
                        "renderer (the loop-closure oracle)")
    _add_common_flags(s)
    s.set_defaults(fn=_cmd_synth)

    v = sub.add_parser("serve", help="several KITTI sequences, one step "
                                      "for all")
    v.add_argument("result_sha")
    v.add_argument("seqs", help="comma-separated sequence names (>= 2)")
    v.add_argument("--pool", type=int, default=0,
                   help="work the sequences through this many slots, "
                        "re-seeding finished ones (default 0: all in "
                        "lockstep)")
    v.add_argument("--begin", type=int, default=0)
    v.add_argument("--end", type=int, default=None)
    v.add_argument("--kitti-home")
    v.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="snapshot the state of all streams every N lockstep "
                        "timesteps (one checkpoint carries all streams; "
                        "resume is bit-exact)")
    _add_common_flags(v)
    _add_health_flags(v)
    v.set_defaults(fn=_cmd_serve)

    m = sub.add_parser("mono", help="monocular SfM (calib_sfm.cpp analog)")
    m.add_argument("--image-mask", default=None,
                   help="printf-style mask, e.g. img-%%04d.jpg (default: "
                        "$CBT_HOME/img-%%04d.jpg)")
    m.add_argument("--calib", default=None,
                   help="3x3 K text file, or a 3x4 P whose left 3x3 is K "
                        "(default: $CBT_HOME/calib.txt)")
    m.add_argument("--begin", type=int, default=0)
    m.add_argument("--end", type=int, default=None)
    m.add_argument("--out", help="KITTI-format pose output path")
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("--device", default="cuda",
                   help="torch device (default cuda; without a card this "
                        "raises: CPU runs ask for --device cpu)")
    m.add_argument("--metric", default=None, choices=["l1", "l2"],
                   help="descriptor distance (default l2; l1 runs the "
                        "hand-written CUDA kernels on the card)")
    m.add_argument("--backend", default="dense",
                   choices=["dense", "fused", "sweep"],
                   help="matcher route, as for kitti; fused and sweep need "
                        "--metric l1")
    m.add_argument("--method", default="5pt", choices=["5pt", "8pt"],
                   help="essential-matrix minimal solver")
    m.add_argument("--sampson-thresh", type=float, default=None,
                   help="RANSAC Sampson gate in normalized coordinates "
                        "(default MonoConfig.sampson_thresh = 2e-5)")
    m.add_argument("--min-good", type=int, default=None,
                   help="cheirality gate: min points in front of both "
                        "cameras (default 10)")
    m.add_argument("--rematch-ratio", type=float, default=None,
                   help="Lowe ratio for the epipolar re-match (default .9)")
    m.add_argument("--hypotheses", type=int, default=None,
                   help="RANSAC sample count (default: 64 for 5pt, 128 "
                        "for 8pt)")
    m.add_argument("--no-scale", action="store_true",
                   help="disable relative-scale propagation (unit-norm "
                        "steps)")
    m.add_argument("--keep-on-failure", action="store_true",
                   help="transient-dropout recovery: hold the last good "
                        "frame's features across a failed solve")
    m.add_argument("--sim3-loop", action="store_true",
                   help="scale-drift-aware loop closure: Sim(3) pose graph "
                        "over keyframe nodes with landmark-cloud Umeyama "
                        "loop edges")
    m.add_argument("--kf-every", type=int, default=4,
                   help="keyframe cadence in frames for --sim3-loop")
    m.add_argument("--loop-min-gap", type=int, default=20,
                   help="min frame separation for a loop candidate")
    m.set_defaults(fn=_cmd_mono)

    e = sub.add_parser("eval", help="ATE/RPE + KITTI devkit-style errors "
                                    "between two pose files")
    e.add_argument("est", help="estimated poses (KITTI 3x4 rows)")
    e.add_argument("gt", help="ground-truth poses (KITTI 3x4 rows)")
    e.add_argument("--delta", type=int, default=1, help="RPE frame gap")
    e.add_argument("--align", default="none", choices=["none", "se3", "sim3"],
                   help="pre-align est to gt before ATE: se3 = Horn rigid "
                        "alignment, sim3 = also solve scale")
    e.add_argument("--plot", help="write a top-down trajectory PNG here")
    e.set_defaults(fn=_cmd_eval)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
