"""libviso_torch.utils.profiling against libviso_tpu.utils.profiling: the
same cost models, stats fields and reports, on the CPU at small sizes;
and the roofline bounds of the port's kernel table from the H100 row of
the peak table."""

import dataclasses
import itertools
import os

import pytest
import torch

from libviso_torch.config import DetectorConfig, PipelineConfig
from libviso_torch.utils import profiling
from libviso_tpu.utils import profiling as jprofiling

H100 = profiling.PEAKS["H100 80GB HBM3"]


@pytest.mark.parametrize("n1,n2,d,metric", list(itertools.product(
    (1, 100, 1280), (7, 200, 1536), (64, 128, 384), ("l1", "l2", "l2q8"))))
def test_match_cost_model_equals_jax(n1, n2, d, metric):
    assert profiling.match_cost_model(n1, n2, d, metric=metric) == \
        jprofiling.match_cost_model(n1, n2, d, metric=metric)


@pytest.mark.parametrize("K,iters,N", list(itertools.product(
    (1, 32, 64), (3, 20, 100), (64, 1280))))
def test_gn_cost_model_equals_jax(K, iters, N):
    assert profiling.gn_cost_model(K, iters, N) == \
        jprofiling.gn_cost_model(K, iters, N)


def test_cost_models_scale_linearly():
    f1, b1 = profiling.match_cost_model(100, 200, 64)
    f2, _ = profiling.match_cost_model(200, 200, 64)
    assert f2 == 2 * f1
    assert f1 == 3.0 * 100 * 200 * 64
    assert b1 == 4 * (100 * 64 + 200 * 64 + 100 * 200)
    fl2, _ = profiling.match_cost_model(100, 200, 64, metric="l2")
    assert fl2 == 2.0 * 100 * 200 * 64
    g1, _ = profiling.gn_cost_model(8, 10, 100)
    g2, _ = profiling.gn_cost_model(16, 10, 100)
    assert g2 == 2 * g1


def test_kernel_stats_fields_equal_jax():
    names = [f.name for f in dataclasses.fields(profiling.KernelStats)]
    assert names == [f.name for f in
                     dataclasses.fields(jprofiling.KernelStats)]
    kw = dict(name="k", seconds=2e-3, flops=4e9, bytes=1e6, gflops=2000.0,
              gbytes_per_s=0.5, flop_util=0.25, bw_util=None)
    mine, theirs = profiling.KernelStats(**kw), jprofiling.KernelStats(**kw)
    assert mine.pretty() == theirs.pretty()
    assert mine.as_dict() == theirs.as_dict()
    chained = profiling._per_iteration(mine, 4)
    assert chained.as_dict() == \
        jprofiling._per_iteration(theirs, 4).as_dict()
    assert chained.gflops == mine.gflops
    assert chained.flops / chained.seconds == mine.flops / mine.seconds


def test_device_peaks_unknown_on_cpu():
    assert profiling.device_peaks("cpu") == (None, None)
    assert profiling.device_peaks(torch.device("cpu")) == (None, None)
    if not torch.cuda.is_available():
        assert profiling.device_peaks() == (None, None)


@pytest.mark.parametrize("shape,want_ms", [
    ((3, 1280, 128), 0.0376), ((12, 1280, 128), 0.1504)])
def test_l1_bound_equals_perf_table(shape, want_ms):
    """PERF.md's bound of kernel #1: 2 FP32 instructions an L1 step over
    the issue rate; the bytes bound is smaller."""
    P, N, D = shape
    ms, by = profiling.bound_ms(2 * P * N * N * D,
                                4 * P * (2 * N * D + N * N), H100)
    assert by == "operations"
    assert round(ms, 4) == want_ms


@pytest.mark.parametrize("B,pairs,want_ms", [
    (3, 100_000, 0.0012), (12, 400_000, 0.0048)])
def test_two_min_bound_is_bytes_bound_of_perf_table(B, pairs, want_ms):
    """PERF.md's bound of kernels #2/#3 at (3 / 12, 1280, 128): the bytes
    of the inputs and outputs, the pairs through the gates being few."""
    ms, by = profiling.two_min_bound(B, 1280, 1280, 128, pairs, H100)
    assert by == "bytes"
    assert round(ms, 4) == want_ms


def test_bound_ms_needs_known_peaks():
    with pytest.raises(ValueError):
        profiling.bound_ms(1.0, 1.0, (None, None))


def test_time_call_host_clock():
    calls = []
    sec = profiling.time_call(lambda x: calls.append(x), reps=4, warmup=2,
                              make_args=lambda i: (i,))
    assert sec >= 0
    assert calls == [1_000_000, 1_000_001, 0, 1, 2, 3]
    with pytest.raises(ValueError):
        profiling.time_call(lambda: None, clock="wall")


def test_profile_matcher_runs():
    st = profiling.profile_matcher(n1=128, n2=128, d=64, reps=3,
                                   device="cpu")
    assert st.seconds > 0 and st.gflops > 0
    assert st.flop_util is None and st.bw_util is None
    assert "match_dist" in st.pretty()
    assert st.flops == profiling.match_cost_model(128, 128, 64)[0]


@pytest.mark.parametrize("metric,backend,chain", [
    ("l1", "plain", 2), ("l2", "kernel", 1), ("l2q8", "kernel", 3)])
def test_profile_matcher_variants_per_iteration(metric, backend, chain):
    st = profiling.profile_matcher(n1=64, n2=96, d=32, metric=metric,
                                   backend=backend, reps=2, chain=chain,
                                   device="cpu")
    flops, nbytes = profiling.match_cost_model(64, 96, 32, metric=metric)
    assert (st.flops, st.bytes) == (flops, nbytes)
    assert st.gflops == pytest.approx(flops * chain / (st.seconds * chain)
                                      / 1e9)
    assert f"[{metric}/{backend}]" in st.name


def test_profile_matcher_rejects_plain_l2():
    with pytest.raises(ValueError):
        profiling.profile_matcher(n1=8, n2=8, d=8, metric="l2",
                                  backend="plain", device="cpu")


def test_profile_solver_runs():
    st = profiling.profile_solver(num_hypotheses=4, gn_iters=5,
                                  n_points=64, reps=3, device="cpu")
    assert st.seconds > 0 and st.gflops > 0
    assert set(st.as_dict()) == {f.name for f in
                                 dataclasses.fields(jprofiling.KernelStats)}
    assert st.name == "ransac_gn K=4 iters=5 N=64"


def test_trace_writes_dir(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        torch.ones((8, 8)) @ torch.ones((8, 8))
    assert os.path.isdir(logdir) and os.listdir(logdir)
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0


def _events(*rows):
    """Trace events from (category, name, correlation id) rows."""
    return [{"ph": "X", "cat": cat, "name": name,
             "args": {"correlation": corr}} for cat, name, corr in rows]


@pytest.mark.parametrize("events", [
    _events(("cpu_op", "aten::mm", None)),
    _events(("cuda_runtime", "cudaLaunchKernel", 7),
            ("kernel", "l1_distance_kernel", 7)),
    _events(("cuda_runtime", "cudaDeviceSynchronize", 3)),
    _events(("cuda_driver", "cuLaunchKernelEx", 4), ("kernel", "k", 4),
            ("cuda_runtime", "cudaLaunchKernelExC", 5), ("kernel", "k", 5)),
])
def test_check_device_records_passes(events):
    profiling.check_device_records(events)


@pytest.mark.parametrize("launch", [
    ("cuda_runtime", "cudaLaunchKernel", 9),
    ("cuda_runtime", "cudaLaunchKernelExC", 9),
    ("cuda_driver", "cuLaunchKernel", 9),
    ("cuda_runtime", "cudaLaunchCooperativeKernel", 9),
])
def test_check_device_records_raises_on_lost_kernels(launch):
    # the first launch's kernel is traced, the second's is not
    events = _events(("cpu_op", "aten::mm", None),
                     ("cuda_runtime", "cudaLaunchKernel", 8),
                     ("kernel", "k", 8), launch,
                     ("cuda_runtime", "cudaDeviceSynchronize", 10),
                     ("ac2g", "ac2g", None))
    with pytest.raises(RuntimeError, match="1 of 2 kernel launches"):
        profiling.check_device_records(events, "t.json")


SMALL = DetectorConfig(max_features=240, nbinx=8, nbiny=3, num_slots=256)


def test_profile_frame_step_runs():
    cfg = dataclasses.replace(PipelineConfig(), detector=SMALL)
    st = profiling.profile_frame_step(cfg, reps=1, chain=2, device="cpu")
    assert st.name == "frame_step" and st.seconds > 0
    mf, mb = profiling.match_cost_model(256, 256, 128)
    gf, gb = profiling.gn_cost_model(cfg.ransac.num_hypotheses,
                                     cfg.ransac.fit_gn_iters, 256)
    assert (st.flops, st.bytes) == (3 * mf + gf, 3 * mb + gb)


def test_profile_mono_step_runs():
    base = PipelineConfig.mono()
    cfg = dataclasses.replace(base, detector=dataclasses.replace(
        base.detector, max_features=240, nbinx=8, nbiny=3, num_slots=256))
    st = profiling.profile_mono_step(cfg, reps=1, chain=2, device="cpu")
    assert st.name == "mono_step[5pt]" and st.seconds > 0
    d = cfg.detector.descriptor_dim_padded
    assert st.flops == profiling.match_cost_model(256, 256, d)[0]
