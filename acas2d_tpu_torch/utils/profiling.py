"""Tracing and phase timers (counterpart of `acas2d_tpu/utils/profiling.py`).

  * `span(name, **key)` / `count(name, n)` — the program's own spans and
    counters, recorded only while a `torch.profiler` session records (as
    `torch._C._autograd._profiler_enabled()` reports it; a schedule's
    warm-up step does not), so the untraced program pays one check
    (~0.2 µs) a span.  A span holds its name, its start and end on the host
    clock `time.time_ns()` (the clock that a Chrome trace's
    `baseTimeNanoseconds` places the card's events on), its parent (a
    stack per thread) and a small key; the newest `MAX_SPANS` are kept,
    and `dropped()` counts the older ones.  `spans()`, `counters()` and
    `clear()` read and reset them;
  * `tally(name, n, device)` — the program's one count of its work
    (`TALLY`: the collectives and their bytes, the unfused paths' env and
    minibatch steps), kept whether or not a profiler records, and added to
    counter `name` too unless the work is being captured into a CUDA
    graph: `learner.ReplayedLoop` puts back what its capture tallied and
    tallies it again at every replay;
  * `Trace` — `torch.profiler` over the CPU and, on a card, the CUDA
    activities, written to `out_dir/trace.json` as a Chrome trace
    (chrome://tracing, Perfetto) with the spans recorded in it, where JAX
    writes an XPlane trace;
  * `PhaseTimers` — named wall-clock accumulators for the training phases
    (a copy of JAX's), each phase also a span of its name;
  * `device_memory_stats()` — the card's allocated memory, now and at its
    peak, from `torch.cuda.memory_stats`;
  * `kernel_busy_share(path)` — the share of a Chrome trace's window in
    which a kernel ran on the card: the union of the kernels' intervals
    over the window from the first event's start to the last one's end;
    `kernel_times(path)` its kernels' time by name.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Deque, Dict, List, Tuple

import torch

TRACE_FILE = "trace.json"
MAX_SPANS = 65_536

recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class Span:
    """A recorded span: host clock (ns), its id and its parent's (-1 at
    the top of its thread), the thread, and the key it was opened with."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    tid: int
    key: Dict[str, object]


class _Open:
    """A span while it is open: on its thread's stack."""
    __slots__ = ("rec", "name", "key", "id", "parent", "start")

    def __init__(self, rec: "Recorder", name: str, key: Dict[str, object]):
        self.rec, self.name, self.key = rec, name, key

    def __enter__(self) -> "_Open":
        stack = self.rec._stack()
        self.parent = stack[-1].id if stack else -1
        self.id = next(self.rec._ids)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        stack = self.rec._stack()
        # a child left open (an exception inside an iteration's phase) is
        # dropped with it; a span an enclosing span dropped is not kept
        if self in stack:
            del stack[stack.index(self):]
            self.rec._keep(Span(self.name, self.start, end, self.id,
                                self.parent, threading.get_native_id(),
                                self.key))
        return False


class Recorder:
    """Spans and counters of one process, kept while a profiler records."""

    def __init__(self):
        self._spans: Deque[Span] = collections.deque(maxlen=MAX_SPANS)
        self._counters: Dict[str, int] = {}
        self._dropped = 0
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[_Open]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(span)

    def span(self, name: str, **key):
        """A context manager that records the block as span `name` while a
        profiler records, and does nothing otherwise."""
        return _Open(self, name, key) if recording() else _OFF

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to counter `name` while a profiler records."""
        if recording():
            with self._lock:
                self._counters[name] = self._counters.get(name, 0) + n

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._dropped = 0


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
spans = RECORDER.spans
counters = RECORDER.counters
dropped = RECORDER.dropped
clear = RECORDER.clear

# the program's work by counter name, whether or not a profiler records
TALLY = collections.Counter()


def tally(name: str, n: int, device: torch.device) -> None:
    """Add `n` to TALLY[name] and, unless work on `device` is being
    captured into a CUDA graph (whose replays count it), to counter
    `name`."""
    TALLY[name] += n
    if not (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        count(name, n)


class Trace:
    """A `torch.profiler` trace between `start()` and `stop()`, written by
    `stop()` to `<out_dir>/trace.json`.  `cuda` adds the card's activities
    (its kernels and copies, through CUPTI).  The spans recorded between
    the two are added to it as `"cat": "program"` events, placed on the
    trace's clock by its `baseTimeNanoseconds`, so that one timeline holds
    the program's phases, its host operations and the card's work."""

    def __init__(self, out_dir: str, cuda: bool):
        self.path = os.path.join(out_dir, TRACE_FILE)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._t0 = 0

    def start(self) -> None:
        self._t0 = time.time_ns()
        self._prof.start()

    def stop(self) -> str:
        self._prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            data = json.load(f)
        base = int(data.get("baseTimeNanoseconds", 0))
        pid = os.getpid()
        data["traceEvents"].extend(
            {"ph": "X", "cat": "program", "name": s.name, "pid": pid,
             "tid": s.tid, "ts": (s.start_ns - base) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {**s.key, "id": s.id, "parent": s.parent}}
            for s in spans() if s.start_ns >= self._t0)
        with open(self.path, "w") as f:
            json.dump(data, f)
        return self.path


class PhaseTimers:
    """Accumulating named wall-clock timers.

    >>> t = PhaseTimers()
    >>> with t("rollout"): ...
    >>> t.report()  # {'rollout_s': ..., 'rollout_calls': ...}

    NOTE: on an asynchronous-dispatch backend a phase only bounds host time
    unless the caller blocks on the phase's outputs; `train.py`'s metrics
    transfer provides that barrier once per call.
    """

    def __init__(self):
        self.total: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.total[name] = self.total.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for k, v in self.total.items():
            out[f"{k}_s"] = round(v, 3)
            out[f"{k}_calls"] = self.calls[k]
        return out


def device_memory_stats(device=None) -> Dict[str, int]:
    """The card's memory held by tensors now and at its peak, and its size
    ({} on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(dev)
                               .total_memory)}


def kernel_times(path: str) -> Dict[str, Tuple[float, int]]:
    """{kernel name: (total µs, launches)} of a Chrome trace written by
    `Trace`, its kernel events ("cat": "kernel") summed by name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: Dict[str, Tuple[float, int]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            us, n = out.get(e["name"], (0.0, 0))
            out[e["name"]] = (us + float(e.get("dur", 0.0)), n + 1)
    return out


def kernel_busy_share(path: str) -> Tuple[float, int, float]:
    """(busy share, kernels, window µs) of a Chrome trace written by
    `Trace`: the union of its kernel events' intervals ("cat": "kernel")
    over the window from the first event's start to the last event's end.
    A trace without kernels gives (0.0, 0, window)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans: List[Tuple[float, float]] = []
    kernels: List[Tuple[float, float]] = []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        spans.append(span)
        if e.get("cat") == "kernel":
            kernels.append(span)
    if not spans:
        return 0.0, 0, 0.0
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    return (busy / window if window > 0 else 0.0), len(kernels), window
