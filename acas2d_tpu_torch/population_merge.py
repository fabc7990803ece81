"""Merge a pipeline's stage-1 selection record into the polish stage's
population.json (counterpart of `scripts/population_merge.py`): the
committed artifact schema under artifacts/population/.

`PopulationTracker.finalize` writes each stage's own summary; the
pipeline-level record (which stage-1 population produced the warm start,
and the stage sequence) lives only at the pipeline level, so
`acas2d_tpu_torch.train` calls `merge` after each polish stage:

    python -m acas2d_tpu_torch.population_merge <stage1_run_dir> \\
        <polish_run_dir> [pipeline_label ...]

Rewrites <polish_run_dir>/population.json in place with two extra keys:
    stage1:   the full stage-1 population.json summary
    pipeline: ordered stage labels (defaults below match the shipped
              fused pipeline)
"""

from __future__ import annotations

import json
import os
import sys

DEFAULT_PIPELINE = ["stage1_population_fused_update",
                    "reval_risk_adjusted",
                    "polish_population_fused"]


def merge(stage1_dir: str, polish_dir: str, pipeline=None) -> dict:
    with open(os.path.join(stage1_dir, "population.json")) as f:
        stage1 = json.load(f)
    polish_path = os.path.join(polish_dir, "population.json")
    with open(polish_path) as f:
        polish = json.load(f)
    polish["stage1"] = stage1
    polish["pipeline"] = list(pipeline) if pipeline else DEFAULT_PIPELINE
    with open(polish_path, "w") as f:
        json.dump(polish, f, indent=1)
    return polish


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    merged = merge(argv[0], argv[1], argv[2:] or None)
    print(f"merged stage-1 record (population {merged['stage1']['population']}"
          f", master seed {merged['stage1']['master_seed']}) into "
          f"{os.path.join(argv[1], 'population.json')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
