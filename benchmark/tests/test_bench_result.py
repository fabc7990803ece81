"""The result line: exactly the keys the driver reads, `checks` last, the
per-layer metrics only with `--trace 1` and only where a reader found
something; `correct` false where a number passes its limit."""

import json

import pytest

from benchmark import run, tracing
from conftest import measure, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_line_keys_untraced():
    cell = tiny("solo_tpu.train")
    rec = measure(cell)
    out = run.result(cell, rec, False, {"platform": "gpu"})
    assert list(out) == KEYS
    assert set(out["metrics"]) == {"train_env_steps_per_s", "setup_s"}
    assert out["correct"] is True
    json.loads(json.dumps(out))


def test_line_keys_traced():
    cell = tiny("envstep.obs")
    rec = measure(cell, trace=True)
    out = run.result(cell, rec, True, {"platform": "gpu"})
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert set(out["device"]) >= {"busy_s", "window_s"}
    # no card: no device metric is read
    assert out["metrics"] == {}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name,number,limit,value", [
    ("envstep.obs", "env_err", -1.0, None),
    ("solo_tpu.train", "launch_gap", None, 1.0)])
def test_limit_fails(name, number, limit, value):
    """A number past its limit fails the run: a limit set below the
    reading, or a launch that the window's iterations do not hold."""
    cell = tiny(name)
    rec = measure(cell)
    assert run.result(cell, rec, False, {})["correct"] is True
    if limit is not None:
        cell.limits[number] = limit
    if value is not None:
        rec["numbers"][number] = value
    assert run.result(cell, rec, False, {})["correct"] is False


def test_trace_reduction(tmp_path):
    """Busy time is the union of the device's intervals in the slice, and
    an idle gap is named by the innermost span around its middle; the
    trace's times are placed on the host clock by its base time."""
    base = 1_000_000_000
    ev = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "cpu_op", "name": "c", "ts": 40, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 70, "dur": 10}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev,
                                "baseTimeNanoseconds": base}))
    spans = [("bench.call", base, base + 60_000),
             ("bench.eval", base + 60_000, base + 100_000)]
    tr = tracing.read(str(path), spans, base, base + 100_000)
    assert abs(tr.busy_s() - 40e-6) < 1e-12
    assert abs(tr.window_s - 100e-6) < 1e-12
    br = tr.breakdown()
    assert br["device_ops"][0][0] == "a"
    assert abs(br["device_ops"][0][1] - 30e-6) < 1e-12
    idle = dict(br["idle_gaps"])
    # gaps 0-10 and 40-70 (middle 55) in the call, 80-100 in the eval
    assert abs(idle["bench.call"] - 40e-6) < 1e-12
    assert abs(idle["bench.eval"] - 20e-6) < 1e-12
