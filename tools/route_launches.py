#!/usr/bin/env python3
"""Count the device launches of one call of the sweep matcher route,
``libviso_torch.ops.fused_matching.sorted_fused_two_min``, on one CUDA
card, by torch.profiler.

  python3 tools/route_launches.py [--tree DIR]

``--tree DIR`` imports ``libviso_torch`` from DIR instead of this
checkout: for example an earlier commit unpacked with ``git archive`` into
``build/``, to count its route beside this one's.  The inputs are 3 and 12
KITTI-size match problems (1280 slots a side, D = 128, x-sorted route,
Sampson gate on every third problem) drawn from a seed.  Prints, per
shape, the count and the name of every device activity (kernels, copies,
fills) of a call after a warm-up call.  The trace is read by this
checkout's ``libviso_torch/utils/profiling.py`` whichever tree the route
comes from, and raises where it lost a kernel record.
"""

import argparse
import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def checkout_profiling():
    """This checkout's ``libviso_torch/utils/profiling.py``, loaded by its
    path, so that ``--tree`` replaces the route but not the reader."""
    path = os.path.join(ROOT, "libviso_torch", "utils", "profiling.py")
    spec = importlib.util.spec_from_file_location("checkout_profiling", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def route_activities(fn):
    """The device activities of one call of ``fn`` after a warm-up call,
    by torch.profiler through the checked reader (``traced``)."""
    prof = checkout_profiling()
    return prof.device_activities(prof.traced(fn, where="the route's trace"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("route_launches: needs a CUDA card")
    from libviso_torch.ops import fused_matching as fm

    print(f"[tree] {os.path.relpath(fm.__file__)}")
    rng = np.random.default_rng(0)
    for B in (3, 12):
        N, D = 1280, 128

        def side():
            xy = rng.uniform(0, [1240, 375], (B, N, 2)).astype(np.float32)
            return (torch.tensor(xy, device="cuda"),
                    torch.tensor(rng.random((B, N)) > 0.1, device="cuda"),
                    torch.tensor(rng.integers(0, 4, (B, N, D)),
                                 dtype=torch.float32, device="cuda"))

        F = torch.tensor(rng.standard_normal((B, 3, 3)), dtype=torch.float32,
                         device="cuda")
        use_epi = torch.tensor(np.arange(B) % 3 == 0, device="cuda")
        call_args = (*side(), *side(), F, use_epi, 1.0, 80.0)
        names = route_activities(
            lambda: fm.sorted_fused_two_min(*call_args))
        print(f"[launches] ({B}, {N}, {D}): {len(names)} device launches "
              f"per call")
        for name in names:
            print(f"  {name[:120]}")


if __name__ == "__main__":
    main()
