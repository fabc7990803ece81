"""The port's tracing and phase timers (`acas2d_tpu_torch/utils/
profiling.py`) on the CPU: the busy share and kernel times read from a
Chrome trace, `Trace` and `train.py --profile`, and `PhaseTimers`
against JAX's on the same phases."""

import json
import os

import pytest
import torch

from acas2d_tpu.utils import profiling as jprofiling
from acas2d_tpu_torch import train
from acas2d_tpu_torch.utils import profiling

B = 64 * 16
TINY = ["--preset", "tpu", "--fused-rollout", "--fused-update",
        "--device", "cpu", "--n-envs", "64", "--n-steps", "16", "--minibatch-size", "512", "--n-epochs", "1",
        "--eval-episodes", "2", "--run-name", "r"]


def _write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _ev(ts, dur, cat, name="k"):
    return {"ph": "X", "ts": ts, "dur": dur, "cat": cat, "name": name}


def test_busy_share_is_the_union_of_kernels_over_the_window(tmp_path):
    """Host events span 0-100 µs; kernels 10-30 and 20-40 overlap (30 µs
    busy), 50-60 and 60-70 touch (20 µs), one inside another adds
    nothing: 50 of 100."""
    path = _write(tmp_path, [
        _ev(0, 100, "cpu_op"), _ev(10, 20, "kernel"), _ev(20, 20, "kernel"),
        _ev(50, 10, "kernel"), _ev(60, 10, "kernel"), _ev(52, 3, "kernel"),
        {"ph": "M", "name": "process_name"}])
    share, kernels, window = profiling.kernel_busy_share(path)
    assert (share, kernels, window) == (0.5, 5, 100.0)


def test_a_trace_without_kernels_is_idle(tmp_path):
    path = _write(tmp_path, [_ev(5, 10, "cpu_op")])
    assert profiling.kernel_busy_share(path) == (0.0, 0, 10.0)
    assert profiling.kernel_busy_share(_write(tmp_path, [])) == (0.0, 0,
                                                                 0.0)


def test_kernel_times_are_summed_by_name(tmp_path):
    path = _write(tmp_path, [_ev(0, 4, "kernel", "gemm"),
                             _ev(9, 6, "kernel", "gemm"),
                             _ev(20, 1, "kernel", "add"),
                             _ev(0, 50, "cpu_op", "gemm")])
    assert profiling.kernel_times(path) == {"gemm": (10.0, 2),
                                            "add": (1.0, 1)}


def test_trace_writes_a_chrome_trace(tmp_path):
    """`Trace` writes the host's operations and the program's spans of its
    session, on the trace's own clock, into one Chrome trace; a span
    recorded before it started is left out."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("before"):
            pass
    t = profiling.Trace(str(tmp_path / "t"), cuda=False)
    t.start()
    with profiling.span("outer", call=1):
        with profiling.span("inner"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert t.stop() == t.path == str(tmp_path / "t" / profiling.TRACE_FILE)
    with open(t.path) as f:
        data = json.load(f)
    events = data["traceEvents"]
    mm = next(e for e in events if "mm" in e.get("name", "")
              and e.get("ph") == "X")
    program = {e["name"]: e for e in events if e.get("cat") == "program"}
    assert set(program) == {"outer", "inner"}
    outer, inner = program["outer"], program["inner"]
    assert outer["args"]["call"] == 1
    assert inner["args"]["parent"] == outer["args"]["id"]
    assert outer["ts"] <= inner["ts"] <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= inner["ts"] + inner["dur"] + 1.0


def test_phase_timers_report_as_jax(monkeypatch):
    """The same phases, each of a fixed length on a stubbed clock, give
    JAX's report."""
    reports = []
    for mod in (jprofiling, profiling):
        clock = iter(range(0, 100, 1))
        monkeypatch.setattr(mod.time, "perf_counter",
                            lambda: float(next(clock)))
        t = mod.PhaseTimers()
        for name in ("dispatch", "train_step", "dispatch", "log"):
            with t(name):
                pass
        reports.append(t.report())
    assert reports[0] == reports[1] == {
        "dispatch_s": 2.0, "dispatch_calls": 2, "train_step_s": 1.0,
        "train_step_calls": 1, "log_s": 1.0, "log_calls": 1}


def test_device_memory_stats_are_empty_on_the_cpu():
    assert profiling.device_memory_stats("cpu") == {}


@pytest.mark.parametrize("population", [0, 2])
def test_train_profiles_calls_2_to_4(population, tmp_path, capsys):
    """--profile traces calls 2-4 of five (one iteration each on the CPU)
    to <run>/trace/trace.json; summary.json's phases count the calls."""
    argv = TINY + ["--out-dir", str(tmp_path), "--total-steps", str(5 * B),
                   "--profile", "--eval-every", str(10 ** 9)] + (
        ["--population", str(population), "--reval-episodes", "0"]
        if population else [])
    rows = train.run(train.parse_args(argv))
    assert len(rows) == 5
    path = tmp_path / "r" / "trace" / profiling.TRACE_FILE
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    program = [e["name"] for e in events if e.get("cat") == "program"]
    # three traced calls of one eager iteration: the driver's phases and
    # the iteration's
    for name in ("dispatch", "train_step", "iteration.rollout",
                 "iteration.gae", "iteration.update"):
        assert program.count(name) == 3, name
    assert "log" in program
    with open(tmp_path / "r" / "summary.json") as f:
        phases = json.load(f)["phases"]
    assert phases["dispatch_calls"] == 5
    assert phases["train_first_call_calls"] == 1
    assert phases["train_step_calls"] == 4
    assert os.path.exists(tmp_path / "r" / "trace")
