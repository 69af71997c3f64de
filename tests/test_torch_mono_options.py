"""The options of the mono slice in libviso_torch: the chunked step
against the per-frame run bit for bit, the four scale estimators against
libviso_tpu (with the 8-point solver), the hold on a failed frame
(``keep_features_on_failure``) and the mono image stream.

The JAX runs get the same draws as the port (``tests/torch_parity.py``);
tolerances are stated per test, with the measured values printed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from libviso_tpu.config import MonoConfig as JMonoConfig
from libviso_torch.config import from_jax_config
from libviso_torch.pipeline import mono as tmono
from libviso_torch.pipeline.stereo import state_leaves
from tests.test_mono import mono_config
from tests.test_torch_mono import _draws, _jax_run, seq  # noqa: F401


def test_chunk_equals_per_frame_bit_for_bit(seq):
    cfg = from_jax_config(mono_config())
    K = seq.P1[:, :3]
    frames = [torch.tensor(f[0]) for f in seq.frames[:4]]
    n = cfg.detector.num_slots
    draws = [tmono.mono_draws(0, t, (64, n), (64, n)) for t in range(4)]
    step = tmono.build_mono_step(K, cfg)
    state = tmono.empty_mono_state(cfg)
    outs = []
    for im, dr in zip(frames, draws):
        state, out = step(state, im, dr)
        outs.append(out)
    chunk = tmono.build_mono_chunk(K, cfg, 2)
    cstate = tmono.empty_mono_state(cfg)
    couts = []
    for i in (0, 2):
        cstate, o = chunk(cstate, torch.stack(frames[i:i + 2]),
                          draws[i:i + 2])
        couts += [tmono.MonoOutput(*(x[j] for x in o)) for j in range(2)]
    for a, b in zip(couts, outs):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for u, v in zip(state_leaves(cstate), state_leaves(state)):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="2 frames"):
        chunk(cstate, torch.stack(frames[:1]), draws[:1])


@pytest.mark.parametrize("estimator", ["bundle", "regression", "median",
                                       "pnp"])
def test_scale_estimators_equal_jax(seq, estimator):
    """Each scale estimator, on 4 frames with the 8-point solver (a small
    program for JAX to compile): equal ok flags, scale ratios and speeds
    within 1e-2 relative (measured: 3e-5 for bundle and median, 5e-3 for
    regression and pnp, which amplify the near-tie differences of the
    128-hypothesis RANSAC through an 11x11 and a 6x6 solve)."""
    cfg = mono_config()
    mono = JMonoConfig(method="8pt", scale_estimator=estimator)
    frames = [f[0] for f in seq.frames[:4]]
    K = seq.P1[:, :3]
    _, _, jres = _jax_run(frames, K, cfg, mono)
    tres = tmono.run_mono_sequence(frames, K, from_jax_config(cfg), seed=0,
                                   device="cpu", mono=from_jax_config(mono),
                                   draws=_draws(cfg, mono))
    np.testing.assert_array_equal(tres.frame_ok, jres.frame_ok)
    assert tres.frame_ok[1:].all()
    rel = max(abs(a["scale_ratio"] / b["scale_ratio"] - 1.0)
              for a, b in zip(tres.stats[2:], jres.stats[2:]))
    err = float(np.abs(tres.speeds / np.maximum(jres.speeds, 1e-12)
                       - 1.0)[1:].max())
    print(f"{estimator}: scale ratios relative {rel}, speeds relative {err}")
    assert rel <= 1e-2 and err <= 1e-2


def test_keep_features_on_failure(seq):
    """Frame 3 blanked: with the hold, frame 4 matches against frame 2
    (span 2) and solves; without it frame 4 fails too; on clean frames the
    hold changes nothing (bit for bit)."""
    cfg = from_jax_config(mono_config())
    keep = dataclasses.replace(cfg, keep_features_on_failure=True)
    K = seq.P1[:, :3]
    frames = [np.asarray(f[0]) for f in seq.frames[:6]]
    clean = tmono.run_mono_sequence(frames, K, cfg, device="cpu")
    clean_keep = tmono.run_mono_sequence(frames, K, keep, device="cpu")
    np.testing.assert_array_equal(clean_keep.poses, clean.poses)
    bad = list(frames)
    bad[3] = np.zeros_like(frames[3])
    held = tmono.run_mono_sequence(bad, K, keep, device="cpu")
    drop = tmono.run_mono_sequence(bad, K, cfg, device="cpu")
    assert held.frame_ok.tolist() == [False, True, True, False, True, True]
    assert drop.frame_ok.tolist() == [False, True, True, False, False, True]
    assert [s["span"] for s in held.stats] == [1, 1, 1, 1, 2, 1]
    # the held pair's step spans two frames: about twice a clean step
    step = np.linalg.norm(held.poses[4][:3, 3] - held.poses[2][:3, 3])
    one = np.linalg.norm(clean.poses[2][:3, 3] - clean.poses[1][:3, 3])
    assert 1.6 < step / one < 2.4, step / one


def test_mono_image_stream(tmp_path):
    from PIL import Image

    from libviso_torch.io.kitti import MonoImageStream

    rng = np.random.default_rng(0)
    ims = [rng.integers(0, 255, (12, 16), dtype=np.uint8) for _ in range(5)]
    for i, im in enumerate(ims):
        Image.fromarray(im).save(tmp_path / f"img-{i + 1:04d}.png")
    mask = str(tmp_path / "img-%04d.png")
    got = list(MonoImageStream(mask, begin=1))
    assert len(got) == 5 and all(np.array_equal(a, b)
                                 for a, b in zip(got, ims))
    assert len(list(MonoImageStream(mask, begin=2, end=3))) == 2
    skipped = list(MonoImageStream(mask, begin=1, prefetch=0).skipped(3))
    assert len(skipped) == 2 and np.array_equal(skipped[0], ims[3])


def test_distortion_option(seq):
    """D = 0 gives the run without D bit for bit (undistortion reduces to
    normalization); a mild distortion still solves every frame."""
    cfg = from_jax_config(mono_config())
    K = seq.P1[:, :3]
    frames = [f[0] for f in seq.frames[:3]]
    plain = tmono.run_mono_sequence(frames, K, cfg, device="cpu")
    zero = tmono.run_mono_sequence(frames, K, cfg, device="cpu",
                                   D=(0.0, 0.0, 0.0, 0.0))
    np.testing.assert_array_equal(zero.poses, plain.poses)
    bent = tmono.run_mono_sequence(frames, K, cfg, device="cpu",
                                   D=(-0.01, 0.001, 0.0, 0.0))
    assert bent.frame_ok[1:].all()
