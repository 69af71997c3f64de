"""Card-only tests of libviso_torch: the CUDA L1 kernel against its plain
version, and the pipeline on the card against the pipeline on the CPU.

Every test is marked ``cuda`` and skips without a card.  The file imports
no JAX, so it runs on a machine that has none; the suite's conftest.py
does import JAX, hence on the card's machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Tolerances: the kernel equals the plain version bitwise on
integer-valued descriptors (every sum is an integer below 2^24, exact in
float32 in any order) and within rtol 1e-5 on random floats (sums in
another order); card and CPU pipelines agree on every discrete per-frame
output and within atol 1e-4 on the motions.
"""

import numpy as np
import pytest
import torch

from libviso_torch.config import PipelineConfig
from libviso_torch.ops import cuda_matching as cm
from libviso_torch.pipeline.stereo import run_stereo_sequence
from libviso_torch.synthetic import generate_sequence

pytestmark = pytest.mark.cuda


def require_cuda():
    """Skip where torch sees no card (decided in the test body, so every
    xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _pair(shape1, shape2, integer, seed=0):
    rng = np.random.default_rng(seed)
    if integer:
        a = rng.integers(-1020, 1021, size=shape1)
        b = rng.integers(-1020, 1021, size=shape2)
    else:
        a = rng.normal(size=shape1) * 100
        b = rng.normal(size=shape2) * 100
    return (torch.tensor(a, dtype=torch.float32, device="cuda"),
            torch.tensor(b, dtype=torch.float32, device="cuda"))


@pytest.mark.parametrize("shapes,integer", [
    (((3, 1280, 128), (3, 1280, 128)), True),
    (((3, 1280, 128), (3, 1280, 128)), False),
    (((2, 1000, 128), (2, 777, 128)), False),
    (((1, 5, 4), (1, 3, 4)), True),
])
def test_kernel_matches_plain(shapes, integer):
    require_cuda()
    a, b = _pair(*shapes, integer)
    before = cm.launches
    out = cm.l1_distance_matrix(a, b)
    torch.cuda.synchronize()
    assert cm.launches == before + 1
    ref = cm.l1_distance_matrix_plain(a, b)
    if integer:
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=0.0)


def test_kernel_takes_unbatched_descriptors():
    require_cuda()
    a, b = _pair((300, 128), (200, 128), True)
    assert torch.equal(cm.l1_distance_matrix(a, b),
                       cm.l1_distance_matrix_plain(a, b))


def test_kernel_rejects_what_it_does_not_take():
    require_cuda()
    a, b = _pair((1, 64, 128), (1, 64, 128), True)
    with pytest.raises(TypeError):
        cm.l1_distance_matrix(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        cm.l1_distance_matrix(a.transpose(1, 2), b.transpose(1, 2))
    with pytest.raises(ValueError, match="D % 4"):
        cm.l1_distance_matrix(a[..., :126].contiguous(),
                              b[..., :126].contiguous())


def test_card_run_matches_cpu_run():
    require_cuda()
    seq = generate_sequence(num_frames=4, num_points=500, seed=3, width=416,
                            height=160)
    cfg = PipelineConfig().with_metric("l1")
    cpu = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg, device="cpu")
    before = cm.launches
    gpu = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg,
                              device="cuda")
    assert cm.launches == before + len(seq.frames)
    keys = ("ok", "num_lr", "num_circle", "num_inliers")
    for a, b in zip(gpu.stats, cpu.stats):
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    assert gpu.frame_ok[1:].all()
    np.testing.assert_allclose(gpu.motions, cpu.motions, atol=1e-4)
