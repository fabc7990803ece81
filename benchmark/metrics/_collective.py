"""What the collectives' readers share: rank 0's NCCL kernels in the
traced slice's calls, and the program's collective counters."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark.metrics import _program

NCCL = "nccl"


def intervals(record) -> Optional[List[Tuple[float, float]]]:
    """The union of the NCCL kernels' intervals (us) that started inside
    the slice's `bench.call` spans, or None where there are none."""
    tr = record.get("trace")
    if tr is None:
        return None
    ev = sorted((e.start, e.end) for e in tr.kernels(within=("bench.call",))
                if NCCL in e.name.lower())
    out: List[Tuple[float, float]] = []
    for a, b in ev:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out or None


def device_us(record) -> Optional[float]:
    iv = intervals(record)
    return None if iv is None else sum(b - a for a, b in iv)


def counted(record) -> Optional[Dict[str, int]]:
    """The program's collective counters over the slice, or None where it
    counts none (a program without them, a run of one process)."""
    c = _program.counters()
    if record.get("trace") is None or "collective.all_reduce" not in c:
        return None
    return {k: int(c.get(k, 0)) for k in (
        "collective.all_reduce", "collective.all_reduce.bytes",
        "collective.all_gather", "collective.all_gather.bytes")}
