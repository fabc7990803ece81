"""What the program recorded in a run's traced slice, for the readers of
its per-layer metrics: its spans and counters
(`acas2d_tpu_torch.utils.profiling`, in this process, recorded while the
slice's profiler records) and its phase marks in the device trace.

Spans are placed on the trace's clock (us, the host's `time.time_ns`);
only those inside the slice are kept.  Every function returns None where
there is nothing to read: no trace, a program that records no spans or
launches no marks, or clocks that do not meet (the trace then holds none
of the program's spans)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from acas2d_tpu_torch.utils import profiling

MARK = "phase_mark_"
MARKS = ("start", "rollout", "gae", "update")


@dataclasses.dataclass
class Span:
    """A program span on the trace's clock (us), with its id and its
    parent's."""
    name: str
    start: float
    end: float
    id: int
    parent: int

    @property
    def dur(self) -> float:
        return self.end - self.start


def spans(record, *names: str) -> Optional[List[Span]]:
    """The program's spans named `names` that lie inside the slice, or
    None where the slice holds none."""
    tr = record.get("trace")
    if tr is None or not hasattr(profiling, "spans"):
        return None
    out = [Span(s.name, s.start_ns / 1e3, s.end_ns / 1e3, s.id, s.parent)
           for s in profiling.spans() if s.name in names]
    out = [s for s in out if tr.t0 <= s.start and s.end <= tr.t1]
    return out or None


def counters() -> Dict[str, int]:
    """The program's counters (recorded while the slice's profiler
    records), or {}."""
    return profiling.counters() if hasattr(profiling, "counters") else {}


def overlap(a: Sequence[Tuple[float, float]],
            b: Sequence[Tuple[float, float]]) -> float:
    """The length of the intersection of two sets of intervals, each
    disjoint."""
    a, b = sorted(a), sorted(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def busy(tr, spans: Sequence[Tuple[float, float]]) -> float:
    """The union of the device's operations over `spans` (disjoint, us,
    inside the slice), us."""
    return sum(b - a for a, b in spans) - overlap(tr.gaps(), spans)


def iterations(record) -> Optional[List[Tuple[float, ...]]]:
    """Each whole iteration in the slice as the start times (us) of its
    four marks (start, rollout, gae, update) on the card, or None where the
    trace holds none."""
    tr = record.get("trace")
    if tr is None:
        return None
    ev = sorted((e for e in tr.device if MARK in e.name
                 and tr.t0 <= e.start < tr.t1), key=lambda e: e.start)
    out, cur = [], []
    for e in ev:
        which = e.name.split(MARK, 1)[1].split("(")[0]
        if which == MARKS[0]:
            cur = [e.start]
        elif cur and which == MARKS[len(cur)]:
            cur.append(e.start)
            if len(cur) == len(MARKS):
                out.append(tuple(cur))
                cur = []
        else:
            cur = []
    return out or None


def phase_ms(record, phase: str) -> Optional[float]:
    """The mean device time (ms) from the mark before `phase` to the mark
    that ends it, over the slice's whole iterations."""
    its = iterations(record)
    if its is None:
        return None
    i = MARKS.index(phase)
    return sum(it[i] - it[i - 1] for it in its) * 1e-3 / len(its)
