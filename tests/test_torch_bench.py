"""bench_torch.py, the port's bench, on the CPU at a small size.

Each mode's timed loop runs on a 416x160 sequence with a narrow detector
(256 slots, 16 RANSAC hypotheses; 2 reps, windows of 4 frames, 2 streams)
and gives a finite positive rate; ``main``'s line has exactly bench.py's
keys and mode strings for its mode.  The loops time the production steps:
their calls, warm-up first, equal ``run_stereo_sequence``,
``run_multistream`` and ``run_mono_sequence`` on the same frames and
(seed, t) draws, bit for bit.  With the JAX package's draws injected,
the chunked stereo loop equals libviso_tpu's ``build_frame_chunk`` and
the serving loop its ``build_multistream_step`` under metric l1 (JAX's
XLA L1 is the kernel's reference): discrete stats exact, motions within
atol 1e-4, the stereo slice's tolerance against JAX
(tests/test_torch_pipeline.py).  The card's run is
tests/test_torch_cuda.py's and chip_smoke.py's (phase 27).
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch as bt
from libviso_tpu.config import Calib as JCalib
from libviso_tpu.config import DetectorConfig as JDetectorConfig
from libviso_tpu.config import PipelineConfig as JPipelineConfig
from libviso_tpu.config import RansacConfig as JRansacConfig
from libviso_tpu.geometry.mvg import F_from_P_host
from libviso_tpu.pipeline import multistream as jms
from libviso_tpu.pipeline import stereo as jstereo
from libviso_torch.config import (
    DetectorConfig,
    MatchConfig,
    MonoConfig,
    PipelineConfig,
    from_jax_config,
)
from libviso_torch.pipeline.mono import mono_draws, run_mono_sequence
from libviso_torch.pipeline.multistream import run_multistream
from libviso_torch.pipeline.stereo import FrameOutput, run_stereo_sequence
from libviso_torch.synthetic import generate_sequence
from tests.torch_parity import jax_frame_gumbel

SMALL = dict(num_points=500, seed=3, width=416, height=160)
JAX_CFG = JPipelineConfig(
    detector=JDetectorConfig(max_features=240, nbinx=8, nbiny=3,
                             num_slots=256),
    ransac=JRansacConfig(num_hypotheses=16, gn_iters=10))
H, N = 16, 256
MOTION_ATOL = 1e-4
DISCRETE = ("ok", "num_circle", "num_inliers", "num_lr", "num_kp1")
KEYS = ["metric", "value", "unit", "vs_baseline"]
STREAM_KEYS = KEYS + ["value_best_window", "mode"]


def narrow(metric="l2", hyp=None):
    cfg = from_jax_config(JAX_CFG).with_metric(metric)
    if hyp is not None:
        cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(
            cfg.ransac, hypothesis_method=hyp))
    return cfg


def narrow_mono():
    return PipelineConfig(
        detector=DetectorConfig(max_features=240, nbinx=8, nbiny=3,
                                num_slots=256, descriptor_radius=5),
        temporal_match=MatchConfig(radius=60.0, use_ratio=True, ratio=0.9))


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(num_frames=6, **SMALL)


@pytest.fixture(scope="module")
def uint8_frames(seq):
    return [tuple(np.asarray(im).astype(np.uint8) for im in pair)
            for pair in seq.frames]


@pytest.fixture
def small_bench(monkeypatch, seq):
    """main() at the small size: the 416x160 generator, the narrow
    detector, K of the small camera."""
    monkeypatch.setattr(bt, "SEQUENCE", SMALL)
    monkeypatch.setattr(bt, "stereo_config", narrow)
    monkeypatch.setattr(bt, "mono_config", narrow_mono)
    monkeypatch.setattr(bt, "MONO_K", seq.P1[:, :3])


def _positive(rates):
    return len(rates) == bt.WINDOWS and all(
        math.isfinite(r) and r > 0 for r in rates)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("argv,mode", [
    ([], "streaming_chunk4"),
    (["--chunk=1"], "streaming_per_frame"),
    (["--streams=2"], "serving_streams2_chunk4"),
    (["--streams=2", "--chunk=1", "--metric=l1", "--backend=fused"],
     "serving_streams2_chunk1"),
    (["--metric=l1", "--backend=sweep", "--hyp=gn"], "streaming_chunk4"),
    (["--staged"], None),
    (["--upload", "--metric=l2q8"], None),
    (["--mono", "--chunk=2", "--mono-first-pass=8pt", "--mono-hyp=16"],
     "mono_5pt_chunk2_fp8pt_h16"),
    (["--mono", "--mono-8pt", "--chunk=2"], "mono_8pt_chunk2"),
])
def test_main_prints_bench_py_line(small_bench, capsys, argv, mode):
    line = bt.main(["--device=cpu", "--reps=2", "--window=4", *argv])
    out = capsys.readouterr()
    assert out.out.splitlines() == [json.dumps(line)]
    assert out.err.startswith("device: cpu")
    mono = "--mono" in argv
    assert list(line) == (STREAM_KEYS if mode else KEYS)
    assert line["metric"] == ("mono_sfm_fps" if mono else "stereo_vo_fps")
    assert line["unit"] == "frames/s"
    assert math.isfinite(line["value"]) and line["value"] > 0
    base = bt.MONO_BASELINE_FPS if mono else bt.BASELINE_FPS
    assert line["vs_baseline"] == round(line["value"] / base, 3)
    if mode:
        assert line["mode"] == mode
        assert line["value_best_window"] >= line["value"]


def test_profile_goes_to_stderr(small_bench, capsys, monkeypatch):
    """--profile prints the device's peaks and three KernelStats lines on
    stderr; stdout keeps the one line (the frame step's profile chained
    over 1 step instead of 16, for time)."""
    from libviso_torch.utils import profiling

    real = profiling.profile_frame_step
    monkeypatch.setattr(profiling, "profile_frame_step",
                        lambda cfg, reps, device: real(
                            cfg, reps=1, chain=1, device=device))
    line = bt.main(["--device=cpu", "--reps=2", "--chunk=1", "--profile"])
    out = capsys.readouterr()
    assert out.out.splitlines() == [json.dumps(line)]
    err = out.err.splitlines()
    assert err[1] == "device: cpu peak=None TFLOP/s bw=None GB/s"
    assert err[2].startswith("match_dist[l2/kernel] 256x256x128: ")
    assert err[3].startswith("ransac_gn K=16 iters=10 N=256: ")
    assert err[4].startswith("frame_step: ")


def test_main_without_a_card_raises(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.main([])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("backend", ["fused", "sweep"])
def test_fused_routes_under_l2_raise(capsys, backend):
    with pytest.raises(ValueError, match="L1 only"):
        bt.main(["--device=cpu", f"--backend={backend}"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("chunk", [1, 2])
def test_streaming_loop_is_run_stereo_sequence(seq, uint8_frames, chunk):
    """The loop's calls, warm-up first, on frames (bench.py's schedule:
    chunk 2, reps 4: group g of window w with draws 100 + 4 w + 2 g + i;
    per frame: frame t with draw 100 + 2 w + t) equal a streaming run of
    the same frames and draws."""
    cfg, reps = narrow(), 4 if chunk > 1 else 2
    draws = bt.frame_draws(cfg)
    outs = []
    rates = bt.streaming_rates(seq, cfg, reps, chunk, device="cpu",
                               on_output=outs.append)
    assert _positive(rates)
    if chunk > 1:
        outs = [FrameOutput(*(x[i] for x in o))
                for o in outs for i in range(chunk)]
        order = [(i, i) for i in range(chunk)] + [
            (g * chunk + i, 100 + w * reps + g * chunk + i)
            for w in range(2) for g in range(reps // chunk)
            for i in range(chunk)]
    else:
        order = [(t, t) for t in range(bt.WARMUP_STEPS)] + [
            (t, 100 + w * reps + t) for w in range(2) for t in range(reps)]
    want = []
    run_stereo_sequence(
        [uint8_frames[f] for f, _ in order], seq.P1, seq.P2, cfg,
        device="cpu", draws=lambda t: draws(order[t][1]),
        on_frame=lambda t, out: want.append(out))
    assert len(want) == len(order)
    for got, ref in zip(outs, want):
        assert _same(got, ref)


@pytest.mark.parametrize("chunk", [1, 2])
def test_serving_loop_is_run_multistream(seq, uint8_frames, chunk):
    """2 streams, K = chunk: stream s at call c (warm-up c = 0..2 on image
    stack c, then window w's call g on stack g) reads frame (K j + i + 7 s)
    mod n of stack j with draw i of index base + i, and equals
    run_multistream of those frames with those draws, timestep by
    timestep."""
    cfg, S, K, reps = narrow(), 2, chunk, 2
    n = len(uint8_frames)
    per_window = max(1, reps // K)
    calls = [(c, c * K) for c in range(bt.WARMUP_STEPS)] + [
        (g, 100 + (w * per_window + g) * K)
        for w in range(2) for g in range(per_window)]
    outs = []
    rates = bt.serving_rates(seq, cfg, reps, K, S, device="cpu",
                             on_output=outs.append)
    assert _positive(rates)
    if K > 1:   # outs[s][k] -> one list of S outputs a timestep
        outs = [[o[s][k] for s in range(S)] for o in outs for k in range(K)]
    steps = [(j * K + i, base + i) for j, base in calls for i in range(K)]
    sequences = [[uint8_frames[(f + 7 * s) % n] for f, _ in steps]
                 for s in range(S)]
    draws = bt._default_draws(cfg, [0, 1])
    want = []
    run_multistream(sequences, [seq.P1] * S, [seq.P2] * S, cfg,
                    device="cpu", draws=lambda s, t: draws(s, steps[t][1]),
                    on_step=lambda t, o: want.append(o))
    assert len(want) == len(steps)
    for got, ref in zip(outs, want):
        assert all(_same(a, b) for a, b in zip(got, ref))


def test_mono_loop_is_run_mono_sequence(seq):
    """chunk 2, reps 2: the warm-up call on frames 0-1 (draws 0, 1), then
    window w's call on frames 0-1 with draws 100 + 2 w + i."""
    cfg, mono = narrow_mono(), MonoConfig(num_hypotheses=16)
    frames = [np.asarray(f[0]).astype(np.uint8) for f in seq.frames]
    outs = []
    rates = bt.mono_rates(frames, seq.P1[:, :3], cfg, mono, 2, 2,
                          device="cpu", on_output=outs.append)
    assert _positive(rates)
    outs = [type(o)(*(x[i] for x in o)) for o in outs[:3] for i in range(2)]
    order = [(0, 0), (1, 1), (0, 100), (1, 101), (0, 102), (1, 103)]
    want = []
    run_mono_sequence(
        [frames[f] for f, _ in order], seq.P1[:, :3], cfg, device="cpu",
        mono=mono, draws=lambda t: mono_draws(0, order[t][1], (16, 256),
                                              (16, 256)),
        on_frame=lambda t, out: want.append(out))
    for got, ref in zip(outs, want):
        assert _same(got, ref)


@pytest.mark.parametrize("upload", [False, True])
def test_window_loop_rate(seq, upload):
    outs = []
    fps = bt.window_rate(seq, narrow(), 2, 4, device="cpu", upload=upload,
                         on_output=outs.append)
    assert math.isfinite(fps) and fps > 0
    assert len(outs) == 3 and outs[0].motions.shape == (4, 6)


def _assert_matches_jax(got, want):
    for name in DISCRETE:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)),
            np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(np.asarray(got.tr), np.asarray(want.tr),
                               rtol=0, atol=MOTION_ATOL)


def test_chunk_loop_equals_jax_build_frame_chunk(seq, uint8_frames):
    """Chunk 2, reps 4, JAX's draws injected: the warm-up call and the
    first window's two calls equal jax.jit(build_frame_chunk) on the same
    frame groups and fold_in keys."""
    cfg = JAX_CFG.with_metric("l1")
    outs = []
    bt.streaming_rates(seq, from_jax_config(cfg), 4, 2, device="cpu",
                       draws=lambda t: jax_frame_gumbel(0, t, H, N),
                       on_output=outs.append)
    cstep = jax.jit(jstereo.build_frame_chunk(
        JCalib.from_projections(seq.P1, seq.P2),
        F_from_P_host(seq.P1, seq.P2), cfg, 2))
    key = jax.random.PRNGKey(0)
    state = jstereo.empty_state(cfg)
    for (group, base), got in zip([(0, 0), (0, 100), (1, 102)], outs):
        ims = [jnp.stack([jnp.asarray(uint8_frames[2 * group + i][c])
                          for i in range(2)]) for c in (0, 1)]
        keys = jnp.stack([jax.random.fold_in(key, base + i)
                          for i in range(2)])
        state, want = cstep(state, *ims, keys)
        _assert_matches_jax(got, want)
    assert bool(np.asarray(outs[1].ok).all())


def test_serving_loop_equals_jax_build_multistream_step(seq, uint8_frames):
    """2 streams, chunk 1, JAX's draws injected (stream s's key
    fold_in(PRNGKey(s), t)): the three warm-up calls and the first
    window's calls equal jax.jit(build_multistream_step)."""
    cfg = JAX_CFG.with_metric("l1")
    S, n = 2, len(uint8_frames)
    outs = []
    bt.serving_rates(seq, from_jax_config(cfg), 2, 1, S, device="cpu",
                     draws=lambda s, t: jax_frame_gumbel(s, t, H, N),
                     on_output=outs.append)
    c = JCalib.from_projections(seq.P1, seq.P2)
    calib4 = jnp.asarray(np.tile(np.array([c.f, c.cu, c.cv, c.base],
                                          np.float32), (S, 1)))
    Fs = jnp.asarray(np.tile(F_from_P_host(seq.P1, seq.P2)[None],
                             (S, 1, 1)))
    mstep = jax.jit(jms.build_multistream_step(cfg))
    states = jms.stack_states([jstereo.empty_state(cfg) for _ in range(S)])
    for (t, index), got in zip([(0, 0), (1, 1), (2, 2), (0, 100),
                                (1, 101)], outs):
        ims = [jnp.stack([jnp.asarray(uint8_frames[(t + 7 * s) % n][v])
                          for s in range(S)]) for v in (0, 1)]
        keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(s), index)
                          for s in range(S)])
        states, want = mstep(calib4, Fs, states, *ims, keys)
        for s in range(S):
            _assert_matches_jax(got[s], type(want)(*(x[s] for x in want)))
