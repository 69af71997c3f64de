#!/usr/bin/env python3
"""Time the port's L1, fused gated and sweep kernels against variants of
their tiling, and the matcher kernels against an older copy of their
sources, on one CUDA card.

  python3 tools/kernel_variants.py [--baseline DIR] [--shipped-only]
      [--only WORD[,WORD...]] [--out chiprun_out/kernel_variants.json]

Each variant is ``libviso_torch/csrc/l1_distance.cu``, ``fused_two_min.cu``
or ``fused_sweep.cu`` with some of its tiling constants replaced (tile
rows and columns, rows per thread, cluster split, ring stages, CTAs per
SM), compiled with the build's nvcc flags into a library of its own;
``--only WORD[,WORD...]`` keeps the variants whose name holds one of them.
``--baseline DIR`` adds the ``l1_distance.cu``, ``fused_two_min.cu`` and
``fused_sweep.cu`` found in DIR (with the headers they include), built the
same way: for example an earlier commit unpacked with ``git archive`` into
``build/``.  A sweep kernel is timed alone: the current one reads the slots
through permutations and boxes computed beforehand (at its own tiling),
an older one that takes slots sorted by x gets them sorted, with its boxes.
Beside them, the order kernel and the whole sweep route
(``sorted_fused_two_min``) of the shipped build.  Every kernel is first
held against the plain PyTorch version, bitwise, on the match problems of
two KITTI-size frames (the detector output of uint8 frames, integer
descriptors) at (3, 1280, 128) and (12, 1280, 128), then timed in turns,
forward and backward through the list, with CUDA events around 50
launches queued behind a sleep kernel (device time: no host time between
launches).  ptxas' registers, shared memory and spills are printed for
each, and the instruction mix of each kernel's largest loop in the
shipped build, from cuobjdump where the toolkit has it.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (the repository root's smoke run)

CSRC = os.path.join(ROOT, "libviso_torch", "csrc")

# name: (source, {constant: value}); {} is the shipped kernel
VARIANTS = {
    "l1 shipped": ("l1_distance.cu", {}),
    "l1 5 CTAs a SM": ("l1_distance.cu", {"kMinCTAs": 5}),
    "l1 3 stages": ("l1_distance.cu", {"kStages": 3}),
    "l1 64x128 tile": ("l1_distance.cu", {"kTN": 128, "kMinCTAs": 2}),
    "l1 32x64 tile": ("l1_distance.cu", {"kTM": 32, "kMinCTAs": 8}),
    "l1 128x128, 8x8 micro-tile": ("l1_distance.cu", {
        "kTM": 128, "kTN": 128, "kMR": 8, "kMinCTAs": 2}),
    "l1 128x64, 8x8, 3 stages": ("l1_distance.cu", {
        "kTM": 128, "kMR": 8, "kStages": 3, "kMinCTAs": 3}),
    "gated shipped": ("fused_two_min.cu", {}),
    "sweep shipped": ("fused_sweep.cu", {}),
    "gated split 1": ("fused_two_min.cu", {"kSplit": 1}),
    "gated split 4": ("fused_two_min.cu", {"kSplit": 4}),
    "gated split 5": ("fused_two_min.cu", {"kSplit": 5}),
    "gated 64-slot tiles, split 4": ("fused_two_min.cu", {
        "kCols": 64, "kSplit": 4, "kMinCTAs": 4}),
    "gated 32 rows, 64-slot tiles, split 4": ("fused_two_min.cu", {
        "kRows": 32, "kCols": 64, "kSplit": 4, "kMinCTAs": 6}),
    "gated 128 rows, split 4": ("fused_two_min.cu", {
        "kRows": 128, "kSplit": 4, "kMinCTAs": 1}),
    "order shipped": ("sweep_order.cu", {}),
    "order, dependents launched at the start": ("sweep_order.cu", {
        "kLaunchDependents": 0}),
    "order, dependents launched after the sort": ("sweep_order.cu", {
        "kLaunchDependents": 1}),
    "sweep no split": ("fused_sweep.cu", {"kMaxSplit": 1}),
    "sweep to 3 CTAs a SM": ("fused_sweep.cu", {"kCTAsPerSM": 3}),
    "sweep to 4 CTAs a SM": ("fused_sweep.cu", {"kCTAsPerSM": 4}),
    "sweep 32-slot boxes": ("fused_sweep.cu", {"kBox": 32}),
    "sweep batches of 2": ("fused_sweep.cu", {"kBatch": 2}),
    "sweep 3 stages": ("fused_sweep.cu", {"kStages": 3}),
}


def substitute(text, consts):
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"no constant {name} to replace")
    return text


def build_all(jobs, out_dir):
    """jobs: name -> (source path, include dir); returns name -> (CDLL,
    ptxas summary)."""
    from libviso_torch import _build

    nvcc = _build._nvcc()
    procs = {}
    for i, (name, (src, inc)) in enumerate(jobs.items()):
        so = os.path.join(out_dir, f"v{i}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, f"-I{inc}", "-shared", src, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[1]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        used = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln]
        libs[name] = (ctypes.CDLL(so), " | ".join(used))
    return libs


def loop_mix(so):
    """Per kernel: the instruction counts of its largest loop body."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True).stdout
    mixes = {}
    for fn in re.split(r"\n\s+Function : ", sass)[1:]:
        name = cs._kernel_name(fn.split("\n")[0].strip())
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,5})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
            r"(\S*[^;]*);", fn)]
        loops = []
        for addr, op, rest in ins:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and target and int(target.group(1), 16) < addr:
                loops.append((int(target.group(1), 16), addr))
        if not loops:
            continue
        lo, hi = max(loops, key=lambda ab: ab[1] - ab[0])
        body = [op for addr, op, _ in ins if lo <= addr <= hi]
        counts = {}
        for op in body:
            counts[op] = counts.get(op, 0) + 1
        mixes[name] = {"instructions": len(body),
                      "FADD share": counts.get("FADD", 0) / len(body),
                      "top": dict(sorted(counts.items(),
                                         key=lambda kv: -kv[1])[:8])}
    return mixes


def bind(lib, sorted_sweep=False):
    """[(kind, launch function)] of the kernels the library exports; with
    sorted_sweep its sweep kernel takes slots sorted by x and boxes (kind
    "sorted sweep"), else permutations and boxes ("sweep")."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    found = []
    for kind, symbol, args in (
            ("l1", "l1_distance_launch", [P, P, P] + [I] * 4 + [P]),
            ("order", "sweep_order_launch", [P] * 9 + [I] * 6 + [P]),
            ("gated", "fused_gated_two_min_launch",
             [P] * 11 + [I] * 4 + [F, F, P]),
            ("sorted sweep", "fused_sweep_two_min_launch",
             [P] * 13 + [I] * 4 + [F, F, P]) if sorted_sweep else
            ("sweep", "fused_sweep_two_min_launch",
             [P] * 15 + [I] * 4 + [F, F, P])):
        if hasattr(lib, symbol):
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = args, I
            found.append((kind, fn))
    return found


def tiling(lib):
    """The (query rows, target slots) a sweep kernel's boxes cover: its
    block and box (current sources) or its block and tile (older ones,
    which leave the third value unset)."""
    rows, box, cols = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.fused_sweep_tiling(ctypes.byref(rows), ctypes.byref(box),
                           ctypes.byref(cols))
    return rows.value, box.value


def launch(kind, fn, pb):
    """One launch on the problems pb (for a sweep, with its order or
    sorted, with its boxes)."""
    stream = torch.cuda.current_stream().cuda_stream
    B, N1 = pb["q_valid"].shape
    N2 = pb["t_valid"].shape[1]
    if kind == "order":
        from libviso_torch.ops import fused_matching as fm

        rows, box = fm.SWEEP_TILING
        outs = (torch.empty((B, N1), dtype=torch.int32, device="cuda"),
                torch.empty((B, N2), dtype=torch.int32, device="cuda"),
                torch.empty((B, 4, -(-N1 // rows)), device="cuda"),
                torch.empty((B, 4, -(-N2 // box)), device="cuda"))
        rc = fn(*(pb[k].data_ptr() for k in ("q_xy", "q_valid", "t_xy",
                                             "t_valid")),
                *(x.data_ptr() for x in outs), None, B, N1, N2, rows, box,
                1, stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError_t {rc}")
        return outs
    D = pb["q_d"].shape[2]
    if kind == "l1":
        out = torch.empty((B, N1, N2), device="cuda")
        rc = fn(pb["q_d"].data_ptr(), pb["t_d"].data_ptr(), out.data_ptr(),
                B, N1, N2, D, stream)
        outs = (out,)
    else:
        outs = (torch.empty((B, N1), device="cuda"),
                torch.empty((B, N1), device="cuda"),
                torch.empty((B, N1), dtype=torch.int32, device="cuda"))
        rc = fn(*(x.data_ptr() for x in pb.values()),
                *(x.data_ptr() for x in outs), B, N1, N2, D, 80.0, 1.0,
                stream)
    if rc:
        raise RuntimeError(f"launch failed: cudaError_t {rc}")
    return outs


def sm_clocks(work):
    """Run work() while sampling the SM clock (MHz) with nvidia-smi."""
    import threading

    clocks, done = [], threading.Event()

    def sample():
        while True:
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True).stdout
            clocks.append(int(out.split()[0]))
            if done.wait(0.05):
                return

    thread = threading.Thread(target=sample)
    thread.start()
    try:
        work()
    finally:
        done.set()
        thread.join()
    return clocks


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="directory with older sources")
    ap.add_argument("--shipped-only", action="store_true")
    ap.add_argument("--only", default="",
                    help="keep the variants whose name holds one of "
                    "these comma-separated words")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "kernel_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")

    from libviso_torch.ops import cuda_matching as cm
    from libviso_torch.ops import fused_matching as fm
    from libviso_torch.synthetic import generate_sequence

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    words = args.only.split(",")

    def kept(name):
        return any(w in name for w in words)

    variants = {k: v for k, v in VARIANTS.items()
                if (not args.shipped_only or "shipped" in k) and kept(k)}
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build")
                           if os.path.isdir(os.path.join(ROOT, "build"))
                           else None)
    jobs = {}
    for name, (src, consts) in variants.items():
        path = os.path.join(tmp, f"{len(jobs)}_{src}")
        with open(os.path.join(CSRC, src)) as fh:
            text = substitute(fh.read(), consts)
        with open(path, "w") as fh:
            fh.write(text)
        jobs[name] = (path, CSRC)
    if args.baseline:
        for src in ("l1_distance.cu", "fused_two_min.cu", "fused_sweep.cu"):
            if os.path.exists(os.path.join(args.baseline, src)) and \
                    kept(f"baseline {src}"):
                jobs[f"baseline {src}"] = (os.path.join(args.baseline, src),
                                           args.baseline)
    libs = build_all(jobs, tmp)
    for name, (_, used) in libs.items():
        print(f"[ptxas] {name}: {used}")
    shipped = [os.path.join(tmp, f"v{i}.so") for i, k in enumerate(jobs)
               if "shipped" in k]
    mixes = {}
    for so in shipped:
        mixes.update(loop_mix(so))
    for k, v in mixes.items():
        print(f"[sass] {k}: largest loop {v['instructions']} instructions, "
              f"FADD share {v['FADD share']:.3f}, {v['top']}")

    seqs = cs._serve_sequences(generate_sequence(**cs.KITTI_SEQUENCE))
    report = {"device": smi, "ptxas": {k: u for k, (_, u) in libs.items()},
              "loop_mix": mixes, "ms": {}}
    for S in (1, 4):
        pb = cs._match_problems(seqs, S, integer=True)
        shape = tuple(pb["q_d"].shape)
        sides = (pb["q_xy"], pb["q_valid"], pb["t_xy"], pb["t_valid"])
        want = {"l1": (cm.l1_distance_matrix_plain(pb["q_d"], pb["t_d"]),),
                "gated": fm.fused_gated_two_min_plain(*pb.values(), 1.0,
                                                      80.0),
                "sweep": fm.sorted_fused_two_min(
                    *pb.values(), 1.0, 80.0,
                    sweep=fm.fused_sweep_two_min_plain)}

        def sweep_inputs(kind, lib):
            """A sweep's inputs at its library's tiling, and its result:
            the permutations and boxes, or the slots sorted by them."""
            qperm, tperm, qbox, tbox = fm.sweep_order_plain(
                *sides, tiling=tiling(lib))
            if kind == "sweep":
                return (dict(pb, qperm=qperm, tperm=tperm, qbox=qbox,
                             tbox=tbox), want["sweep"])
            srt = {k: torch.take_along_dim(
                x, (qperm if k[0] == "q" else tperm).long().reshape(
                    x.shape[:2] + (1,) * (x.dim() - 2)), dim=1)
                for k, x in pb.items() if k[:2] in ("q_", "t_")}
            srt = dict(srt, F=pb["F"], use_epi=pb["use_epi"], qbox=qbox,
                       tbox=tbox)
            return srt, fm.fused_sweep_two_min_plain(
                *list(srt.values())[:8], 1.0, 80.0)

        fns = {}
        for name, (lib, _) in libs.items():
            for kind, fn in bind(lib, sorted_sweep=name == "baseline "
                                 "fused_sweep.cu"):
                if kind in ("sweep", "sorted sweep"):
                    inputs, ref = sweep_inputs(kind, lib)
                elif kind == "order":
                    inputs, ref = pb, fm.sweep_order_plain(*sides)
                else:
                    inputs, ref = pb, want[kind]
                got = launch(kind, fn, inputs)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                    raise SystemExit(f"{name} {kind} {shape}: kernel != "
                                     f"plain bitwise")
                fns[f"{name} [{kind}]"] = (
                    lambda k=kind, f=fn, a=inputs: launch(k, f, a))
                if kind == "order":   # and the shipped sweep kernel after it
                    fns[f"{name} [order, then the shipped sweep]"] = (
                        lambda f=fn: fm.swept_two_min(
                            *pb.values(), launch("order", f, pb), 1.0,
                            80.0))
        # what the two kernels cost without their work: the order kernel
        # not sorting, the sweep kernel with no live tile (radius 0)
        order = fm.sweep_order(*sides)
        fns["order kernel (shipped)"] = lambda: fm.sweep_order(*sides)
        fns["order kernel (shipped), no sort"] = lambda: fm.sweep_order(
            *sides, sort=False)
        fns["sweep kernel (shipped), radius 0"] = lambda: fm.swept_two_min(
            *pb.values(), order, 1.0, 0.0)
        fns["sweep route (shipped)"] = lambda: fm.sorted_fused_two_min(
            *pb.values(), 1.0, 80.0)
        fns["torch.cdist(p=1)"] = lambda: torch.cdist(pb["q_d"], pb["t_d"],
                                                      p=1)
        for f in fns.values():
            f()
        ms = {k: [] for k in fns}
        clocks = sm_clocks(lambda: [
            ms[k].append(cs._time_ms(fns[k], reps=50))
            for k in list(fns) + list(fns)[::-1]])
        print(f"[clock] {shape}: SM clock {min(clocks)}-{max(clocks)} MHz "
              f"over {len(clocks)} samples while timing")
        print(f"[check] {shape}: every library == plain bitwise")
        for k, v in ms.items():
            print(f"[time] {shape} {k}: {sum(v) / 2:.4f} ms "
                  f"({v[0]:.4f}, {v[1]:.4f})")
        report["ms"][str(shape)] = {k: sum(v) / 2 for k, v in ms.items()}
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)


if __name__ == "__main__":
    main()
