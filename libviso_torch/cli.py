"""Command-line drivers of the PyTorch port (port of ``libviso_tpu/cli.py``,
stereo subcommands).

  python -m libviso_torch.cli synth [--frames N] [--metric l1|l2]
  python -m libviso_torch.cli kitti RESULT_SHA SEQ [BEGIN END]
      [--kitti-home DIR]        (default $KITTI_HOME)

Both take ``--device`` (default ``cuda``); ``--device cuda`` on a machine
without a card raises: CPU runs ask for ``--device cpu``.  On the card,
``--metric l1`` runs the hand-written L1 kernel.  Flags of the JAX CLI that
the port does not run yet are recognised and raise NotImplementedError
naming the ROADMAP.md item that ports them.
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
    from libviso_torch.config import HealthConfig
    from libviso_torch.io.kitti import (
        StereoImageStream,
        kitti_sequence_paths,
        load_calib,
        save_poses_kitti,
    )
    from libviso_torch.pipeline.stereo import run_stereo_sequence
    from libviso_torch.utils.metrics import MetricsLogger, health_summary

    _reject_not_ported(args, _NOT_PORTED_KITTI)
    cfg = _config(args)
    kitti_home = args.kitti_home or os.environ.get("KITTI_HOME")
    if not kitti_home:
        sys.exit("KITTI_HOME not set (flag --kitti-home or env)")
    paths = kitti_sequence_paths(kitti_home, args.seq)
    P1, P2 = load_calib(paths["calib"])
    stream = StereoImageStream(
        os.path.join(paths["image_0"], "%06d.png"),
        os.path.join(paths["image_1"], "%06d.png"),
        begin=args.begin, end=args.end)
    result_dir = os.path.join(kitti_home, "results", args.seq,
                              args.result_sha)
    os.makedirs(result_dir, exist_ok=True)

    t0 = time.perf_counter()
    res = run_stereo_sequence(stream, P1, P2, cfg, seed=args.seed,
                              device=args.device)
    dt = time.perf_counter() - t0
    with MetricsLogger(os.path.join(result_dir, "metrics.jsonl")) as ml:
        for s in res.stats:
            ml.log(s)
    hc = HealthConfig()
    poses_path = os.path.join(result_dir, "data", f"{args.seq}.txt")
    save_poses_kitti(poses_path, res.poses)
    n = len(res.poses)
    print(json.dumps({
        "sequence": args.seq, "frames": n, "device": args.device,
        "solved": int(res.frame_ok.sum()),
        "fps": n / dt if dt > 0 else None, "poses": poses_path,
        "health": health_summary(
            res.stats, res.frame_ok,
            support_ratio_alarm=hc.support_ratio_alarm,
            motion_jump_alarm=hc.motion_jump_alarm),
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
                              seed=args.seed, device=args.device)
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

    for name, item in (("serve", "Queue 1 item 9 (throughput modes)"),
                       ("mono", "Queue 1 item 10 (mono)")):
        m = sub.add_parser(name, help=f"not ported yet: ROADMAP.md {item}")
        m.add_argument("rest", nargs=argparse.REMAINDER)
        m.set_defaults(fn=lambda _, name=name, item=item: _not_ported(
            name, item))

    args = p.parse_args(argv)
    args.fn(args)


def _not_ported(name, item):
    raise NotImplementedError(
        f"the {name} mode is not ported to libviso_torch yet: ROADMAP.md "
        f"{item}")


if __name__ == "__main__":
    main()
