"""Command-line drivers of the PyTorch port (port of ``libviso_tpu/cli.py``,
stereo subcommands).

  python -m libviso_torch.cli synth [--frames N] [--metric l1|l2]
  python -m libviso_torch.cli kitti RESULT_SHA SEQ [BEGIN END]
      [--kitti-home DIR]        (default $KITTI_HOME)
  python -m libviso_torch.cli serve RESULT_SHA SEQ,SEQ[,...] [--pool N]
      [--begin B] [--end E]     (several sequences, one step for all)

All take ``--device`` (default ``cuda``); ``--device cuda`` on a machine
without a card raises: CPU runs ask for ``--device cpu``.  ``--backend``
picks the matcher route:
- ``dense`` (default): the distance matrix, then gates and row minima in
  PyTorch; with ``--metric l1`` on the card the matrix is the hand-written
  L1 kernel.  The JAX CLI's ``xla`` and ``pallas`` both correspond to it;
- ``fused``: one fused CUDA kernel for gates, L1 and row minima;
- ``sweep``: the fused kernel on x-sorted slots, skipping target tiles
  beyond the radius.
``fused`` and ``sweep`` compute L1 only and need ``--metric l1``.  Flags of
the JAX CLI that the port does not run yet are recognised and raise
NotImplementedError naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_OPTIONS = "Queue 1 item 8 (main-path options)"
# (flag, takes a value, ROADMAP.md item that ports it)
_NOT_PORTED_CFG = (
    ("--subpixel", False, _OPTIONS), ("--pyramid", True, _OPTIONS),
    ("--sharpen", True, _OPTIONS), ("--sharpen-amount", True, _OPTIONS),
    ("--sharpen-auto", False, _OPTIONS), ("--nms", True, _OPTIONS),
    ("--keep-on-failure", False, _OPTIONS),
    ("--chunk", True, "Queue 1 item 7 (stereo pipeline and drivers)"),
)
_NOT_PORTED_KITTI = (
    ("--checkpoint-every", True, _OPTIONS), ("--save-debug", False, _OPTIONS),
    ("--ba-window", True, "Queue 1 item 12 (windowed BA)"),
    ("--loop-closure", False, "Queue 1 item 11 (loop closure)"),
)
_NOT_PORTED_SYNTH = (
    ("--world", False, "Queue 1 item 3 (front-end, world frames)"),
    ("--world-loop", False, "Queue 1 item 11 (loop closure)"),
)


def _add_not_ported(parser, entries):
    for flag, takes_value, _ in entries:
        if takes_value:
            parser.add_argument(flag, default=None, help=argparse.SUPPRESS)
        else:
            parser.add_argument(flag, action="store_true", default=None,
                                help=argparse.SUPPRESS)


def _reject_not_ported(args, entries):
    for flag, _, item in entries:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise NotImplementedError(
                f"{flag} is not ported to libviso_torch yet: ROADMAP.md "
                f"{item}")


def _add_common_flags(parser):
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; without a card this raises: "
             "CPU runs ask for --device cpu)")
    parser.add_argument(
        "--metric", default=None, choices=["l1", "l2", "l2q8"],
        help="descriptor distance: l2 (the config default) or l1, the "
             "reference metric, which runs the hand-written CUDA kernel on "
             "the card (l2q8 is not ported yet)")
    parser.add_argument(
        "--hyp", default=None, choices=["gn", "procrustes"],
        help="RANSAC hypothesis estimator (default procrustes)")
    parser.add_argument(
        "--backend", default="dense", choices=["dense", "fused", "sweep"],
        help="matcher route: dense (distance matrix, then gates and row "
             "minima; the JAX CLI's xla and pallas both correspond to it on "
             "the card), fused (one fused L1 kernel) or sweep (the fused "
             "kernel on x-sorted slots); fused and sweep need --metric l1")
    _add_not_ported(parser, _NOT_PORTED_CFG)


def _config(args):
    import dataclasses

    from libviso_torch.config import PipelineConfig

    _reject_not_ported(args, _NOT_PORTED_CFG)
    cfg = PipelineConfig()
    if args.metric is not None:
        cfg = cfg.with_metric(args.metric)
    if args.hyp is not None:
        cfg = dataclasses.replace(
            cfg, ransac=dataclasses.replace(cfg.ransac,
                                            hypothesis_method=args.hyp))
    return cfg


def _cmd_kitti(args):
    from libviso_torch.pipeline.stereo import run_stereo_sequence

    _reject_not_ported(args, _NOT_PORTED_KITTI)
    cfg = _config(args)
    kitti_home = args.kitti_home or os.environ.get("KITTI_HOME")
    if not kitti_home:
        sys.exit("KITTI_HOME not set (flag --kitti-home or env)")
    stream, P1, P2 = _open_sequence(kitti_home, args.seq, args.begin,
                                    args.end)

    t0 = time.perf_counter()
    res = run_stereo_sequence(stream, P1, P2, cfg, seed=args.seed,
                              device=args.device, backend=args.backend)
    dt = time.perf_counter() - t0
    out = _write_results(kitti_home, args.result_sha, args.seq, res)
    n = len(res.poses)
    print(json.dumps({
        "sequence": args.seq, "frames": n, "device": args.device,
        "solved": out["solved"], "fps": n / dt if dt > 0 else None,
        "poses": out["poses"], "health": out["health"],
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


def _write_results(kitti_home, result_sha, name, res):
    """Write a sequence's metrics.jsonl and KITTI-format poses under
    results/NAME/RESULT_SHA; returns its summary for the output JSON."""
    from libviso_torch.config import HealthConfig
    from libviso_torch.io.kitti import save_poses_kitti
    from libviso_torch.utils.metrics import MetricsLogger, health_summary

    result_dir = os.path.join(kitti_home, "results", name, result_sha)
    os.makedirs(result_dir, exist_ok=True)
    with MetricsLogger(os.path.join(result_dir, "metrics.jsonl")) as ml:
        for s in res.stats:
            ml.log(s)
    poses_path = os.path.join(result_dir, "data", f"{name}.txt")
    save_poses_kitti(poses_path, res.poses)
    hc = HealthConfig()
    return {
        "sequence": name, "frames": len(res.poses),
        "solved": int(res.frame_ok.sum()), "poses": poses_path,
        "health": health_summary(
            res.stats, res.frame_ok,
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
    if args.chunk is not None and int(args.chunk) > 1:
        sys.exit("serve does not take --chunk (streams already share each "
                 "step)")
    args.chunk = None    # --chunk 1 is the default step, not a chunked one
    if args.checkpoint_every is not None:
        raise NotImplementedError(
            "--checkpoint-every is not ported to libviso_torch yet: "
            "ROADMAP.md Queue 1 item 8 (main-path options)")
    seq_names = args.seqs.split(",")
    if len(seq_names) < 2:
        sys.exit("serve wants >=2 sequences (use `kitti` for one)")
    cfg = _config(args)
    if args.pool > 0:
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
        device=args.device, backend=args.backend)
    dt = time.perf_counter() - t0
    out = [_write_results(kitti_home, args.result_sha, name, res)
           for name, res in zip(seq_names, results)]
    total = sum(len(res.poses) for res in results)
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
                                      res)
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
    from libviso_torch.synthetic import generate_sequence
    from libviso_torch.utils.metrics import ate_rmse, rpe_errors

    _reject_not_ported(args, _NOT_PORTED_SYNTH)
    cfg = _config(args)
    seq = generate_sequence(num_frames=args.frames, seed=args.seed)
    t0 = time.perf_counter()
    res = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg,
                              seed=args.seed, device=args.device,
                              backend=args.backend)
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


def main(argv=None):
    p = argparse.ArgumentParser(prog="libviso_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    k = sub.add_parser("kitti", help="KITTI stereo odometry")
    k.add_argument("result_sha")
    k.add_argument("seq")
    k.add_argument("begin", nargs="?", type=int, default=0)
    k.add_argument("end", nargs="?", type=int, default=None)
    k.add_argument("--kitti-home")
    _add_common_flags(k)
    _add_not_ported(k, _NOT_PORTED_KITTI)
    k.set_defaults(fn=_cmd_kitti)

    s = sub.add_parser("synth", help="synthetic-sequence smoke run")
    s.add_argument("--frames", type=int, default=20)
    _add_common_flags(s)
    _add_not_ported(s, _NOT_PORTED_SYNTH)
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
    v.add_argument("--checkpoint-every", default=None, help=argparse.SUPPRESS)
    _add_common_flags(v)
    v.set_defaults(fn=_cmd_serve)

    m = sub.add_parser("mono", help="not ported yet: ROADMAP.md Queue 1 "
                                    "item 10 (mono)")
    m.add_argument("rest", nargs=argparse.REMAINDER)
    m.set_defaults(fn=lambda _: _not_ported("mono",
                                            "Queue 1 item 10 (mono)"))

    args = p.parse_args(argv)
    args.fn(args)


def _not_ported(name, item):
    raise NotImplementedError(
        f"the {name} mode is not ported to libviso_torch yet: ROADMAP.md "
        f"{item}")


if __name__ == "__main__":
    main()
