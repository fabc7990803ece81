"""The traced slice of a run: the benchmark's spans around the calls into
the program, a `torch.profiler` trace of the card over them, and its
reduction to device intervals.

A span (`bench.call`, `bench.readback`, `bench.eval`, `bench.tracker`,
`bench.launch`, `bench.sync`) is timed on the host clock, `time.time_ns`,
and kept in memory by the slice that records it.  The profiler records the card's activity alone (its
kernels, copies and sets, through CUPTI): recording the host's operations
as well costs the host ~2 ms an env-rollout launch, which would starve the
card and read as idle time the untraced run does not have.  The trace's
times are placed on the host clock by its `baseTimeNanoseconds`.  The
device's busy time is the union of its operations' intervals within the
slice (the arithmetic of the program's
`utils/profiling.kernel_busy_share`, copied).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class NoSpans:
    """Spans outside a traced slice: nothing is timed."""

    def span(self, name: str):
        return contextlib.nullcontext()


NO_SPANS = NoSpans()


@dataclasses.dataclass
class Event:
    name: str
    start: float      # us
    dur: float        # us

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclasses.dataclass
class Trace:
    """The slice: its window (us), the device's operations in it, the
    benchmark's spans, and what the driver counted in it (`work`)."""
    t0: float
    t1: float
    device: List[Event]
    spans: List[Event]
    work: Dict[str, float]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def kernels(self, *names: str, within: Tuple[str, ...] = ()
                ) -> List[Event]:
        """Device operations whose name holds one of `names` (all, if
        none), started inside a span of `within` (anywhere, if empty)."""
        ev = [e for e in self.device
              if not names or any(n in e.name for n in names)]
        if within:
            spans = sorted((s.start, s.end) for s in self.spans
                           if s.name in within)
            ev = [e for e in ev if any(a <= e.start < b for a, b in spans)]
        return ev

    def busy_s(self) -> float:
        """Union of the device's intervals within the window, seconds."""
        busy, end = 0.0, float("-inf")
        for e in sorted(self.device, key=lambda e: e.start):
            a, b = max(e.start, self.t0), min(e.end, self.t1)
            if b <= a:
                continue
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        """The window's idle intervals (us): no device operation runs."""
        out, cur = [], self.t0
        for e in sorted(self.device, key=lambda e: e.start):
            if e.start > cur:
                out.append((cur, min(e.start, self.t1)))
            cur = max(cur, e.end)
        if cur < self.t1:
            out.append((cur, self.t1))
        return [(a, b) for a, b in out if b > a]

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time, and the idle time by
        the innermost span the host was in at each gap's middle."""
        ops: Dict[str, float] = {}
        for e in self.device:
            ops[e.name] = ops.get(e.name, 0.0) + e.dur * 1e-6
        idle: Dict[str, float] = {}
        spans = self.spans
        for a, b in self.gaps():
            mid = 0.5 * (a + b)
            inside = [s for s in spans if s.start <= mid < s.end]
            name = (min(inside, key=lambda s: s.dur).name if inside
                    else "outside the benchmark's spans")
            idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
        def first(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    ][:top]
        return {"device_ops": first(ops), "idle_gaps": first(idle)}


class Slice:
    """Profile a slice of a run: `start()` begins a warm-up step, whose
    events are dropped (the profiler's own start-up, CUPTI's first
    buffers); `begin()` begins the slice that is kept; `stop()` ends it
    and returns the `Trace`.  The Chrome trace goes to a directory of its
    own under TMPDIR, is read back and removed."""

    def __init__(self, cuda: bool):
        acts = [torch.profiler.ProfilerActivity.CUDA if cuda
                else torch.profiler.ProfilerActivity.CPU]
        self.cuda = cuda
        self._dir = tempfile.mkdtemp(prefix="bench-trace-")
        self._path = os.path.join(self._dir, "trace.json")
        self._prof = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(self._path))
        self._t0 = None
        self.spans: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Time the block on the host clock as span `bench.<name>`."""
        t = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((f"bench.{name}", t, time.time_ns()))

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._prof.start()

    def begin(self) -> None:
        self._sync()
        self._prof.step()
        self.spans = []
        self._t0 = time.time_ns()

    def stop(self, work: Dict[str, float]) -> Trace:
        self._sync()
        t1 = time.time_ns()
        try:
            self._prof.step()
            self._prof.stop()
            return read(self._path, self.spans, self._t0, t1, work)
        finally:
            shutil.rmtree(self._dir, ignore_errors=True)


def read(path: str, spans: List[Tuple[str, int, int]], t0_ns: int,
         t1_ns: int, work: Optional[Dict[str, float]] = None) -> Trace:
    """A `Trace` of the slice [t0_ns, t1_ns] (host clock, ns) from a Chrome
    trace and the host spans (name, start ns, end ns)."""
    with open(path) as f:
        data = json.load(f)
    base = float(data.get("baseTimeNanoseconds", 0)) / 1e3
    device = [Event(str(e.get("name", "")), base + float(e["ts"]),
                    float(e.get("dur", 0.0)))
              for e in data["traceEvents"]
              if e.get("ph") == "X" and "ts" in e
              and e.get("cat") in DEVICE_CATS]
    t0, t1 = t0_ns / 1e3, t1_ns / 1e3
    if device and not (t0 - 1e6 < min(e.start for e in device) < t1 + 1e6):
        print("trace: the device's times do not fall in the slice's; "
              "its spans are left unnamed", file=sys.stderr)
        t0 = min(e.start for e in device)
        t1 = max(e.end for e in device)
        spans = []
    return Trace(t0, t1, device,
                 [Event(n, a / 1e3, (b - a) / 1e3) for n, a, b in spans],
                 dict(work or {}))
