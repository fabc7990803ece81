"""The card's idle time per training call in the untraced
window: the window's host wall a call (its evals, `eval_s`, left out)
less the device time of a call in the traced slice (the union of the
device's operations over the slice outside the program's `eval` spans,
over the `learner.call` spans there).  The tracer slows the host down at
every launch, so the slice's own idle time mostly reads the tracer; the
device's operations it leaves as they are.  Below 0 where a call's
device time under the tracer exceeds its untraced wall."""

from benchmark.metrics import _program

LAYER = "training loop: ppo/learner.py ReplayedLoop, ppo/population.py, ppo/gae.py"
UNIT = "ms/call"
SOURCE = "program_span"
MOVES = "train_env_steps_per_s"


def read(record):
    calls = _program.spans(record, "learner.call")
    tr, work = record["trace"], record.get("work", {})
    if calls is None or not tr.device or not work.get("calls"):
        return None
    evals = [(e.start, e.end) for e in _program.spans(record, "eval") or ()]
    device_us = tr.busy_s() * 1e6 - _program.busy(tr, evals)
    wall_s = (record["window_s"] - sum(record.get("eval_s", ()))) \
        / work["calls"]
    return 1e3 * wall_s - device_us * 1e-3 / len(calls)
