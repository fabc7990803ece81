"""Export pipeline run(s) into the population-artifact schema (counterpart
of `scripts/export_population_artifacts.py:31-96`).

For each master seed, copies the stage's selected policy and merged
population.json into the output directory and builds the strict-eval
record from the exact-protocol CSV:

    <prefix>_s<seed>_selected.npz     the auto-selected policy
    <prefix>_s<seed>_population.json  per-member archive + selection record
    <prefix>_s<seed>_strict.json      strict 100-episode eval + repro cmd

    python -m acas2d_tpu_torch.export_population_artifacts \\
        --run-prefix pipe5 --seeds 2101,2201 --stage final \\
        --runs-dir runs/ppo --out-dir runs/population

The run dirs are `<runs-dir>/<run-prefix>_s<seed>_<stage>` (`polish`, or
`final` for `python -m acas2d_tpu_torch.pipeline`'s best-of-chain dir),
each with selected_best.npz, population.json and eval_100_exact.csv.
The strict record keeps the JAX script's fields, population std
(ddof 0) and rounding; the CSV is read with `utils/episode_csv.read_csv`,
not pandas, and the record names the port's eval command.  Where the JAX
script writes into the repository's `artifacts/population/`, this
exporter takes the output directory and refuses `artifacts/` or any path
under it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

from acas2d_tpu_torch.export_parity_artifacts import check_out_dir
from acas2d_tpu_torch.utils.episode_csv import read_csv

PROTOCOL = ("python -m acas2d_tpu_torch.eval --exact --episodes 100 "
            "(skip_episodes 2, seed-13 Mersenne stream; the reference "
            "testing_main protocol, float64 stepping on the device given "
            "by --device, default cuda)")


def strict_record(csv_path: str, art_npz: str, produced_by: str) -> dict:
    rows = read_csv(csv_path)
    reward = np.array([r["Total Reward"] for r in rows], np.float64)
    steps = np.array([r["Time Steps"] for r in rows], np.float64)
    outcomes = [r["Outcome"] for r in rows]
    return {
        "episodes": len(rows),
        "mean_reward": round(float(reward.mean()), 2),
        "std_reward": round(float(reward.std(ddof=0)), 2),
        "goals": outcomes.count("Goal"),
        "collisions": outcomes.count("Collision"),
        "timeouts": outcomes.count("Timeout"),
        "mean_steps": round(float(steps.mean()), 2),
        "protocol": PROTOCOL,
        "reproduce": (f"python -m acas2d_tpu_torch.eval --params-npz "
                      f"{art_npz} --exact --episodes 100"),
        "produced_by": [produced_by],
    }


def export_seed(run_prefix: str, seed: int, art_prefix: str,
                produced_by: str, runs_dir: str, out_dir: str,
                stage: str = "polish") -> dict:
    run = os.path.join(runs_dir, f"{run_prefix}_s{seed}_{stage}")
    sel_dst = os.path.join(out_dir, f"{art_prefix}_s{seed}_selected.npz")
    shutil.copy(os.path.join(run, "selected_best.npz"), sel_dst)
    shutil.copy(os.path.join(run, "population.json"),
                os.path.join(out_dir, f"{art_prefix}_s{seed}_population.json"))
    rec = strict_record(os.path.join(run, "eval_100_exact.csv"), sel_dst,
                        produced_by)
    with open(os.path.join(out_dir, f"{art_prefix}_s{seed}_strict.json"),
              "w") as f:
        json.dump(rec, f, indent=4)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run-prefix", required=True,
                    help="<runs-dir>/<run-prefix>_s<seed>_<stage> must exist "
                         "with selected_best.npz, population.json, and "
                         "eval_100_exact.csv")
    ap.add_argument("--seeds", required=True,
                    help="comma-separated master seeds")
    ap.add_argument("--art-prefix", default=None,
                    help="artifact name prefix (default = run prefix)")
    ap.add_argument("--stage", default="polish",
                    help="run-dir stage suffix holding the final policy "
                         "('final' for best-of-chain pipeline output)")
    ap.add_argument("--produced-by", default="python -m "
                    "acas2d_tpu_torch.pipeline")
    ap.add_argument("--runs-dir", default="runs/ppo",
                    help="where the run dirs are (the pipeline's --out-dir)")
    ap.add_argument("--out-dir", required=True,
                    help="where the files go (never under artifacts/)")
    args = ap.parse_args(argv)
    try:
        out_dir = check_out_dir(args.out_dir)
    except ValueError as e:
        ap.error(str(e))
    art_prefix = args.art_prefix or args.run_prefix
    rows = []
    for s in args.seeds.split(","):
        rec = export_seed(args.run_prefix, int(s), art_prefix,
                          args.produced_by, args.runs_dir, out_dir,
                          stage=args.stage)
        rows.append((int(s), rec["mean_reward"], rec["goals"]))
        print(f"seed {s}: strict {rec['mean_reward']} "
              f"({rec['goals']}/100 goals)")
    means = [r[1] for r in rows]
    print(f"{len(rows)} seeds exported; min strict {min(means)}, "
          f"max {max(means)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
