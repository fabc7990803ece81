"""The readers of the program's spans, counters and phase marks
(`benchmark/metrics/_program.py` and the seven metrics on it), each given
a synthetic traced slice and synthetic spans: the value, and nothing where
the spans or marks fall outside the slice or the program records none (a
program older than its spans)."""

import pytest

from acas2d_tpu_torch.utils import profiling
from benchmark import spec, tracing

BASE = 1_000_000.0          # the slice's start on the host clock, us
PROGRAM = ("learner.host_idle_ms", "iteration.rollout_ms",
           "iteration.gae_ms", "iteration.update_ms", "greedy_eval.host_ms",
           "greedy_eval.device_ms", "greedy_eval.chunks")


def _trace(device, t1=1000.0):
    """A slice [0, t1] us after BASE holding `device` (name, start, end)."""
    return tracing.Trace(BASE, BASE + t1,
                         [tracing.Event(n, BASE + a, b - a)
                          for n, a, b in device], [], {})


def _spans(items, shift=0.0):
    """Program spans (name, start us, end us, id, parent) after BASE."""
    return [profiling.Span(n, int((BASE + a + shift) * 1e3),
                           int((BASE + b + shift) * 1e3), i, p, 0, {})
            for n, a, b, i, p in items]


@pytest.fixture
def program(monkeypatch):
    """Set what the program recorded: program(spans, counters)."""
    def put(spans, counters=None):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
        monkeypatch.setattr(profiling, "counters",
                            lambda: dict(counters or {}))
    return put


def read(name, trace, **record):
    return spec.reader(name).read({"trace": trace, **record})


CALL = [("learner.call", 50, 950, 0, -1), ("learner.inputs", 50, 150, 1, 0),
        ("learner.load", 150, 200, 2, 0), ("learner.replay", 200, 800, 3, 0),
        ("learner.unpack", 800, 950, 4, 0)]
CALL_DEVICE = [("k", 100, 300), ("k", 400, 900)]


def test_host_idle_is_the_untraced_call_wall_less_its_device_time(program):
    """The window's 3 calls took 2.7 ms with 0.3 ms of evals: 0.8 ms a
    call.  The card is busy 0.73 ms of the slice, 0.03 ms of it in an
    eval, so 0.7 ms in its one call: 0.1 ms idle a call."""
    program(_spans(CALL + [("eval", 950, 990, 20, -1)]))
    window = dict(window_s=2.7e-3, eval_s=[1e-4, 2e-4], work={"calls": 3})
    got = read("learner.host_idle_ms",
               _trace(CALL_DEVICE + [("e", 955, 985)]), **window)
    assert got == pytest.approx(0.1)
    # two calls in the slice halve the device time a call
    program(_spans(CALL + [("learner.call", 960, 990, 5, -1)]))
    assert read("learner.host_idle_ms", _trace(CALL_DEVICE),
                **window) == pytest.approx(0.8 - 0.35)
    # a window without evals (a train cell): the whole wall a call
    assert read("learner.host_idle_ms", _trace(CALL_DEVICE),
                window_s=2.4e-3, work={"calls": 3}) \
        == pytest.approx(0.8 - 0.35)


MARKS = [("phase_mark_start", 100, 101), ("k", 101, 140),
         ("phase_mark_rollout", 150, 151), ("phase_mark_gae", 160, 161),
         ("phase_mark_update", 300, 301),
         ("phase_mark_start", 320, 321), ("phase_mark_rollout", 380, 381),
         ("phase_mark_gae", 390, 391), ("phase_mark_update", 600, 601),
         # a call cut by the slice's end, and marks out of order
         ("phase_mark_start", 700, 701), ("phase_mark_rollout", 750, 751),
         ("phase_mark_start", 800, 801), ("phase_mark_gae", 810, 811),
         ("phase_mark_update", 820, 821)]


@pytest.mark.parametrize("name,want", [("iteration.rollout_ms", 0.055),
                                       ("iteration.gae_ms", 0.010),
                                       ("iteration.update_ms", 0.175)])
def test_phases_are_timed_between_marks_of_whole_iterations(name, want):
    assert read(name, _trace(MARKS)) == pytest.approx(want)
    # a mark before the slice's start leaves its iteration out
    assert read(name, tracing.Trace(BASE + 200, BASE + 1000, [
        tracing.Event(n, BASE + a, b - a) for n, a, b in MARKS], [], {})) \
        == pytest.approx({"iteration.rollout_ms": 0.060,
                          "iteration.gae_ms": 0.010,
                          "iteration.update_ms": 0.210}[name])


EVAL = [("eval", 0, 1000, 10, -1), ("eval.reset", 0, 100, 11, 10),
        ("eval.chunk", 100, 300, 12, 10), ("eval.chunk", 300, 500, 13, 10),
        ("eval.result", 500, 1000, 14, 10),
        # a chunk of another eval, outside the slice's evals
        ("eval.chunk", 1000, 1001, 15, 99)]
EVAL_DEVICE = [("k", 100, 200), ("k", 350, 400)]


def test_eval_host_time_device_time_and_chunks(program):
    """One eval of 1 ms with two chunks of 0.2 ms: 0.6 ms outside them;
    the card busy 0.15 ms in it; 5 chunks counted over 2 evals."""
    program(_spans(EVAL), {"eval.chunks": 2})
    tr = _trace(EVAL_DEVICE, t1=1010.0)
    assert read("greedy_eval.host_ms", tr) == pytest.approx(0.6)
    assert read("greedy_eval.device_ms", tr) == pytest.approx(0.15)
    assert read("greedy_eval.chunks", tr) == 2.0
    program(_spans(EVAL + [("eval", 1002, 1008, 20, -1)]),
            {"eval.chunks": 5})
    assert read("greedy_eval.chunks", tr) == 2.5
    assert read("greedy_eval.host_ms", tr) == pytest.approx(0.303)
    assert read("greedy_eval.device_ms", tr) == pytest.approx(0.075)


@pytest.mark.parametrize("name", PROGRAM)
def test_nothing_to_read_outside_the_slice(program, name):
    """Spans after the slice's end (as where the two clocks do not meet),
    no marks in the trace, no trace: nothing is read."""
    program(_spans(CALL + EVAL, shift=5000.0), {"eval.chunks": 2})
    assert read(name, _trace(CALL_DEVICE + EVAL_DEVICE)) is None
    assert read(name, None) is None


@pytest.mark.parametrize("name", PROGRAM)
def test_a_program_without_spans_reads_nothing(monkeypatch, name):
    """A program whose profiling module records no spans and launches no
    marks (one older than them): every reader gives None and none
    raises."""
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert read(name, _trace(CALL_DEVICE + EVAL_DEVICE)) is None
