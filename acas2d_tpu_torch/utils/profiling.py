"""Tracing and phase timers (counterpart of `acas2d_tpu/utils/profiling.py`).

  * `Trace` / `trace(out_dir)` — `torch.profiler` over the CPU and, on a
    card, the CUDA activities, written to `out_dir/trace.json` as a Chrome
    trace (chrome://tracing, Perfetto), where JAX writes an XPlane trace;
  * `PhaseTimers` — named wall-clock accumulators for the training phases
    (a copy of JAX's);
  * `device_memory_stats()` — the card's allocated memory, now and at its
    peak, from `torch.cuda.memory_stats`;
  * `kernel_busy_share(path)` — the share of a Chrome trace's window in
    which a kernel ran on the card: the union of the kernels' intervals
    over the window from the first event's start to the last one's end;
    `kernel_times(path)` its kernels' time by name.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

TRACE_FILE = "trace.json"


class Trace:
    """A `torch.profiler` trace between `start()` and `stop()`, written by
    `stop()` to `<out_dir>/trace.json`.  `cuda` adds the card's activities
    (its kernels and copies, through CUPTI)."""

    def __init__(self, out_dir: str, cuda: bool):
        self.path = os.path.join(out_dir, TRACE_FILE)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> str:
        self._prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def trace(out_dir: Optional[str], cuda: bool = False
          ) -> Iterator[Optional[Trace]]:
    """Profile the enclosed block to `out_dir` (no-op when out_dir is
    None)."""
    if not out_dir:
        yield None
        return
    t = Trace(out_dir, cuda)
    t.start()
    try:
        yield t
    finally:
        t.stop()


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
