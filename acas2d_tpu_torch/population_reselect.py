"""Re-run the selection of a finished population run (JAX
`scripts/population_reselect.py`).

The tracker persists every member's best snapshots in
`<run>/population_best.npz` (`ppo/population.PopulationTracker`), so the
selection can be redone (e.g. with more re-eval episodes) without
retraining: one fresh greedy re-eval of every archived snapshot, as the
training driver's own (`train.select`: `--episodes` each, spawns drawn
from a generator seeded master seed + 99, in the run's dtype from its
`summary.json`, float32 without one), then the tracker's risk-adjusted
selection.

    python -m acas2d_tpu_torch.population_reselect --run runs/ppo/<name> \\
        [--episodes 256] [--device cuda]

Overwrites `<run>/selected_best.npz`, `<run>/top_snapshots.npz` and
`<run>/population.json`, and prints the new summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.ppo import population
from acas2d_tpu_torch.ppo.config import PPOConfig


def run_dtype(run: str) -> torch.dtype:
    """The dtype a run trained and evaluated in (its summary.json)."""
    try:
        with open(os.path.join(run, "summary.json")) as f:
            name = json.load(f)["config"]["dtype"]
    except (OSError, KeyError):
        name = "float32"
    return getattr(torch, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run", required=True)
    ap.add_argument("--episodes", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    with open(os.path.join(args.run, "population.json")) as f:
        prev = json.load(f)
    pop, seed = prev["population"], prev["master_seed"]
    tracker = population.PopulationTracker(
        args.run, pop, seed, k=prev.get("snapshots_per_member", 6))
    if tracker.snap_params is None:
        raise SystemExit(f"no persisted member snapshots under {args.run}")

    dtype = run_dtype(args.run)
    cfg = dataclasses.replace(PPOConfig(), seed=seed,
                              eval_episodes=args.episodes)
    reval_fn = population.make_population_eval(cfg, DEFAULT_PARAMS, dtype,
                                               device=device)
    flat, _ = tracker.snapshots_flat()
    rm = reval_fn(torch.as_tensor(flat, device=device, dtype=dtype),
                  torch.Generator().manual_seed(seed + 99))
    summary = tracker.finalize(rm["eval_return_mean"].cpu().numpy(),
                               reval_episodes=args.episodes,
                               reval_stds=rm["eval_return_std"].cpu().numpy())
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
