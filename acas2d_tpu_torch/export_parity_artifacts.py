"""Export sample-efficiency-parity evidence from a parity sweep (counterpart
of `scripts/export_parity_artifacts.py:41-106`).

Turns `python -m acas2d_tpu_torch.parity_sweep` output (<sweep-dir>/<run>/)
into files in an output directory of its own:

    python -m acas2d_tpu_torch.export_parity_artifacts [SWEEP_DIR] \\
        [RUN ...] --out-dir DIR

    <out-dir>/ppo_<run>_evaluations.npz  eval curve, the reference's
                                         evaluations.npz schema
                                         (timesteps/results/ep_lengths,
                                         and goal_rate)
    <out-dir>/ppo_<run>_best.npz         best-eval policy params (flat
                                         npz, utils/params_io), for the
                                         runs in PARAMS_FOR
    <out-dir>/parity_sweep_summary.json  final/best eval of every run

SWEEP_DIR defaults to runs/parity and the runs to the JAX script's
(EXPORTS).  The summary has the JAX script's keys and rounding, and an
empty one is never written.  Where the JAX script writes into the
repository's `artifacts/` (over the committed files), this exporter takes
the output directory and refuses `artifacts/` or any path under it.  The
params come from the port's `checkpoints/best` (`utils/checkpoint.
CheckpointManager`), the flat vector mapped onto the flax tree.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys
from typing import Dict

import numpy as np

from acas2d_tpu_torch.utils.checkpoint import CheckpointManager
from acas2d_tpu_torch.utils.params_io import flat_to_tree, save_params_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX script's exports and the runs whose best params it exports
# (scripts/export_parity_artifacts.py:83-90)
EXPORTS = ("ref_s12", "ref_s9", "env8_s2", "ref_s8", "env8_s8")
PARAMS_FOR = frozenset({"ref_s8", "ref_s12", "env8_s8"})


def check_out_dir(path: str) -> str:
    """`path`, made, unless it is the repository's `artifacts/` (or the
    working directory's) or lies under it: the committed artifacts are the
    JAX package's record, which no port command writes over."""
    real = os.path.realpath(path)
    for art in {os.path.join(ROOT, "artifacts"), os.path.abspath("artifacts")}:
        art = os.path.realpath(art)
        if real == art or real.startswith(art + os.sep):
            raise ValueError(f"refusing to write into {art}: give an "
                             f"output directory outside artifacts/")
    os.makedirs(path, exist_ok=True)
    return path


def read_eval_csv(path: str) -> Dict[str, np.ndarray]:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {
        "timesteps": np.array([int(r["global_step"]) for r in rows]),
        "results": np.array([float(r["eval_return_mean"]) for r in rows]),
        "ep_lengths": np.array([float(r["eval_length_mean"]) for r in rows]),
        "goal_rate": np.array([float(r["eval_goal_rate"]) for r in rows]),
    }


def export_run(run_dir: str, name: str, out_dir: str,
               with_params: bool) -> None:
    curve = read_eval_csv(os.path.join(run_dir, "eval.csv"))
    out = os.path.join(out_dir, f"{name}_evaluations.npz")
    np.savez(out, timesteps=curve["timesteps"], results=curve["results"],
             ep_lengths=curve["ep_lengths"], goal_rate=curve["goal_rate"])
    print(f"wrote {out} (final={curve['results'][-1]:.1f}, "
          f"best={curve['results'].max():.1f})")

    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if with_params and os.path.isdir(os.path.join(ckpt_dir, "best")):
        raw = CheckpointManager(ckpt_dir).restore_raw(best=True)
        pout = os.path.join(out_dir, f"{name}_best.npz")
        save_params_npz(pout, flat_to_tree(raw["params"]))
        print(f"wrote {pout}")


def summarize(sweep_dir: str) -> Dict[str, Dict]:
    """Every run of the sweep: its final and best in-training eval."""
    summary = {}
    for d in sorted(glob.glob(os.path.join(sweep_dir, "*_s*", ""))):
        run = os.path.basename(os.path.dirname(d))
        c = read_eval_csv(os.path.join(d, "eval.csv"))
        i = int(c["results"].argmax())
        summary[run] = {
            "final_eval_return": round(float(c["results"][-1]), 2),
            "final_goal_rate": round(float(c["goal_rate"][-1]), 2),
            "best_eval_return": round(float(c["results"][i]), 2),
            "best_at_step": int(c["timesteps"][i]),
            "total_steps": int(c["timesteps"][-1]),
        }
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("sweep_dir", nargs="?", default="runs/parity")
    p.add_argument("runs", nargs="*", default=list(EXPORTS),
                   help="runs whose curves (and, for PARAMS_FOR, best "
                        "params) are exported")
    p.add_argument("--out-dir", required=True,
                   help="where the files go (never under artifacts/)")
    args = p.parse_args(argv)
    try:
        out_dir = check_out_dir(args.out_dir)
    except ValueError as e:
        p.error(str(e))

    summary = summarize(args.sweep_dir)
    sout = os.path.join(out_dir, "parity_sweep_summary.json")
    if summary:
        with open(sout, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
        print(f"wrote {sout} ({len(summary)} runs)")
    else:
        print(f"no runs under {args.sweep_dir}; {sout} not written")

    for name in args.runs:
        export_run(os.path.join(args.sweep_dir, name), f"ppo_{name}",
                   out_dir, with_params=name in PARAMS_FOR)
    return 0


if __name__ == "__main__":
    sys.exit(main())
