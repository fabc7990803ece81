"""What the readers of the unfused path's per-layer metrics share: the
program's tallies over the traced slice (`rollout.env_steps`,
`update.autograd_steps`: counters that a replay adds for what its captured
iteration holds), an iteration.  None where the program keeps no such
counter, or the slice holds no iteration."""

from __future__ import annotations

from typing import Optional

from benchmark.metrics import _program


def per_iteration(record, counter: str) -> Optional[float]:
    """The program's counter `counter` over the traced slice's
    iterations."""
    tr = record.get("trace")
    n = _program.counters().get(counter)
    iterations = tr.work.get("iterations") if tr is not None else None
    if not n or not iterations:
        return None
    return n / iterations
