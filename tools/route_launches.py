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
fills) of a call after a warm-up call.
"""

import argparse
import os
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    from torch.profiler import ProfilerActivity, profile

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
        fm.sorted_fused_two_min(*call_args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fm.sorted_fused_two_min(*call_args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"[launches] ({B}, {N}, {D}): {len(names)} device launches "
              f"per call")
        for name in names:
            print(f"  {name[:120]}")


if __name__ == "__main__":
    main()
