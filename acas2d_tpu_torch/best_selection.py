"""The one definition of 'best selection across pipeline stage dirs'
(counterpart of `scripts/best_selection.py`).

Ranks each stage dir's population.json by its risk-adjusted selection
score, falling back to the raw re-eval mean only where the score is
missing: the currency `PopulationTracker.finalize` selects by.  The
pipeline (`acas2d_tpu_torch/pipeline.py`) uses it twice, for the
escalation gate and for the final best-across-attempts pick, so that the
two cannot drift onto different scores.

    python -m acas2d_tpu_torch.best_selection <stage_dir> [...]
    # prints "score<TAB>dir"

Exits 1 when no dir holds a score.  Unlike the JAX script, a score of 0.0
ranks as 0.0: the fallback is taken for a missing score, not for a falsy
one.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Iterable, Optional, Tuple


def stage_score(stage_dir: str) -> Optional[float]:
    try:
        with open(os.path.join(stage_dir, "population.json")) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    v = d.get("selected_score")
    return v if v is not None else d.get("selected_reval")


def best(stage_dirs: Iterable[str]) -> Tuple[float, Optional[str]]:
    bv, bd = float("-inf"), None
    for c in stage_dirs:
        v = stage_score(c)
        if v is not None and v > bv:
            bv, bd = v, c
    return bv, bd


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    bv, bd = best(argv)
    print(f"{bv:.2f}\t{bd or ''}")
    return 0 if bd else 1


if __name__ == "__main__":
    sys.exit(main())
