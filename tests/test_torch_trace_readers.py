"""Every reader of a trace's device counts goes through the lost-record
check: ``libviso_torch.utils.profiling.trace_events`` (which
``tools/profile_torch_step.py`` uses), ``traced`` and ``trace``,
``chip_smoke.py``'s fresh-process tracer and ``tools/route_launches.py``.

On the CPU with hand-made trace events (torch.profiler's ``profile``
replaced by one that exports them): a trace where one kernel launch lost
its kernel record raises, and a complete trace counts as before (kernels,
stream and device syncs, host-to-device copies, the device activities'
names in order).
"""

import json
import os

import pytest
import torch

import chip_smoke
from libviso_torch.utils import profiling
from tools import profile_torch_step, route_launches


def _x(cat, name, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": 0, "dur": 1,
            "args": {"correlation": corr}}


COMPLETE = [
    _x("cpu_op", "aten::abs", None),
    _x("cuda_runtime", "cudaLaunchKernel", 1),
    _x("kernel", "sweep_order_kernel", 1),
    _x("cuda_runtime", "cudaLaunchKernelExC", 2),
    _x("kernel", "fused_sweep_kernel", 2),
    _x("cuda_runtime", "cudaMemcpyAsync", 3),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 3),
    _x("cuda_runtime", "cudaStreamSynchronize", 4),
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 2, "ts": 0},
]
# the second launch's kernel record is missing
LOST = [e for e in COMPLETE if e["name"] != "fused_sweep_kernel"]
COUNTS = {"kernel_launches": 2, "stream_syncs": 1, "device_syncs": 0,
          "h2d_copies": 1}
NAMES = ["sweep_order_kernel", "fused_sweep_kernel",
         "Memcpy HtoD (Pageable -> Device)"]
LOST_MESSAGE = "1 of 2 kernel launches have no kernel record"


class _FakeProfile:
    """torch.profiler.profile stand-in whose export writes ``events``."""

    events = COMPLETE

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        with open(path, "w") as fh:
            json.dump({"traceEvents": self.events}, fh)


@pytest.fixture
def exports(monkeypatch):
    """exports(events): torch.profiler.profile from here on exports
    ``events``."""
    def use(events):
        monkeypatch.setattr(torch.profiler, "profile", type(
            "Profile", (_FakeProfile,), {"events": events}))
    return use


def test_profile_tool_reads_through_the_checked_reader():
    assert profile_torch_step.trace_events is profiling.trace_events
    assert profile_torch_step.device_counts is profiling.device_counts


def test_trace_events_counts_a_complete_trace():
    events = profiling.trace_events(_FakeProfile())
    assert events == [e for e in COMPLETE if e["ph"] == "X"]
    assert profiling.device_counts(events) == COUNTS
    assert profiling.device_activities(events) == NAMES


def test_trace_events_raises_on_a_lost_record():
    prof = type("Profile", (_FakeProfile,), {"events": LOST})()
    with pytest.raises(RuntimeError, match=LOST_MESSAGE):
        profiling.trace_events(prof, "the tool's trace")


@pytest.mark.parametrize("events", [COMPLETE, LOST], ids=["complete",
                                                          "lost"])
def test_traced_warms_up_then_reads_checked(exports, events):
    exports(events)
    calls = []
    if events is LOST:
        with pytest.raises(RuntimeError, match=LOST_MESSAGE):
            profiling.traced(lambda: calls.append(1))
    else:
        got = profiling.traced(lambda: calls.append(1))
        assert profiling.device_counts(got) == COUNTS
    assert calls == [1, 1]


def test_trace_context_raises_on_a_lost_record(exports, tmp_path):
    exports(LOST)
    with pytest.raises(RuntimeError, match=LOST_MESSAGE):
        with profiling.trace(str(tmp_path)):
            pass
    assert os.path.exists(tmp_path / "trace.json")


def _saved_route_call(path):
    """One small sweep-route call on the CPU (the plain versions), saved
    as chip_smoke.traced_in_fresh_process saves it."""
    g = torch.Generator().manual_seed(0)
    B, N, D = 1, 8, 4

    def side():
        return (torch.rand((B, N, 2), generator=g) * 40,
                torch.ones((B, N), dtype=torch.bool),
                torch.randint(0, 4, (B, N, D), generator=g).float())

    args = (*side(), *side(), torch.eye(3)[None],
            torch.zeros(B, dtype=torch.bool), 1.0, 80.0)
    torch.save([("sorted_fused_two_min", args, {})], path)


@pytest.mark.parametrize("events", [COMPLETE, LOST], ids=["complete",
                                                          "lost"])
def test_chip_smoke_fresh_process_tracer(exports, tmp_path, events):
    exports(events)
    path = str(tmp_path / "route.pt")
    _saved_route_call(path)
    if events is LOST:
        with pytest.raises(RuntimeError, match=LOST_MESSAGE):
            chip_smoke._trace_saved(path)
        return
    chip_smoke._trace_saved(path)
    with open(path + ".json") as fh:
        assert json.load(fh) == [{"activities": NAMES, **COUNTS}]


@pytest.mark.parametrize("events", [COMPLETE, LOST], ids=["complete",
                                                          "lost"])
def test_route_launches_reader(exports, events):
    exports(events)
    if events is LOST:
        with pytest.raises(RuntimeError, match=LOST_MESSAGE):
            route_launches.route_activities(lambda: None)
    else:
        assert route_launches.route_activities(lambda: None) == NAMES
