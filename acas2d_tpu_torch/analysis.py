"""Offline analysis driver of the PyTorch port — the reference notebooks'
reporting, as a CLI (JAX `analysis.py`).

The reference's de-facto reporting layer is three Jupyter notebooks
(outcome counts, trajectory scatter plots, reward-shape exploration)
reading the driver CSVs.  This driver produces the same artifacts
headlessly from any `acas2d_tpu_torch.baseline` / `acas2d_tpu_torch.eval`
CSV (or the JAX drivers' or the reference's own CSVs), without pandas:

    python -m acas2d_tpu_torch.analysis --csv runs/eval_100.csv --out-dir runs/analysis
    python -m acas2d_tpu_torch.analysis --csv ... --episodes 1 5 7     # per-episode replays
    python -m acas2d_tpu_torch.analysis --learning-curve runs/ppo/<run>/eval.csv
    python -m acas2d_tpu_torch.analysis --reward-shapes

Outputs: outcome summary (stdout + summary.json), trajectory overview plot
(all episodes, coloured by outcome — the simulation notebook's scatter),
per-episode replay PNGs, the learning curve against the reference's
committed evaluations.npz when `utils/reference.py` finds one, and the
shaped-reward terms, computed by the port's `ops/rewards.py` in float64
on `--device` (default cuda).  The plots need matplotlib; the CSV parts
run on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.ops import rewards as R
from acas2d_tpu_torch.utils.episode_csv import read_csv
from acas2d_tpu_torch.utils.reference import reference_path

REF_EVALS = reference_path("gym_ACAS2D", "models", "best_model_1048576_11",
                           "results", "evaluations.npz")


def outcome_summary(rows: List[Dict]) -> dict:
    """Outcome counts and the means of an episode CSV's rows (`read_csv`);
    the std is the sample std (ddof 1), as pandas' is."""
    outcomes = [r["Outcome"] for r in rows]
    reward = np.array([r["Total Reward"] for r in rows], np.float64)
    return {
        "episodes": int(len(rows)),
        "goal": outcomes.count("Goal"),
        "collision": outcomes.count("Collision"),
        "timeout": outcomes.count("Timeout"),
        "mean_total_reward": float(np.mean(reward)),
        "std_total_reward": float(np.std(reward, ddof=1)),
        "mean_time_steps": float(np.mean([r["Time Steps"] for r in rows])),
    }


def trajectory_overview(rows: List[Dict], params, out_png: str):
    """All-episode trajectory scatter coloured by outcome (the
    simulation/baseline notebooks' headline plot)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt
    from acas2d_tpu_torch.render import _new_axes

    fig, ax = _new_axes(params)
    colors = {"Goal": (0, 1, 0, 0.5), "Collision": (1, 0, 0, 0.5),
              "Timeout": (1, 1, 0, 0.5)}
    for row in rows:
        p = np.asarray(row["Path"])
        ax.plot(p[:, 0], p[:, 1], color=colors[row["Outcome"]], lw=0.6)
    ax.add_patch(mpatches.Circle((params.goal_x, params.goal_y),
                                 params.goal_radius, fill=False,
                                 color=(1, 1, 0), lw=2))
    handles = [plt.Line2D([0], [0], color=c[:3], lw=2, label=k)
               for k, c in colors.items()]
    ax.legend(handles=handles, loc="lower left")
    ax.set_title(f"{len(rows)} episodes")
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return out_png


def learning_curve(eval_csv: str, out_png: str, compare_reference: bool = True):
    """Plot eval_return_mean vs global_step of a training run's eval.csv;
    overlay the reference's committed learning curve (evaluations.npz)
    when present."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = read_csv(eval_csv)
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot([r["global_step"] for r in rows],
            [r["eval_return_mean"] for r in rows], "-o", ms=3,
            label="acas2d_tpu_torch")
    if compare_reference and os.path.exists(REF_EVALS):
        z = np.load(REF_EVALS)
        ax.plot(z["timesteps"], z["results"].mean(axis=1), "-s", ms=3,
                alpha=0.7, label="reference (SB3, evaluations.npz)")
    ax.set_xlabel("environment steps")
    ax.set_ylabel("mean eval return (10 greedy episodes)")
    ax.axhline(1198.22, color="gray", ls="--", lw=0.8,
               label="reference final (1198.22)")
    ax.legend()
    ax.grid(alpha=0.3)
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return out_png


def reward_shape_curves(params, device=None) -> Dict[str, tuple]:
    """The curves `reward_shapes` draws, (x, y) numpy float64 pairs keyed
    by name: each of the four shaped-reward terms over its domain, the
    polarized (display-only) deviation term and the time-discount factor,
    computed by `ops/rewards.py` in float64 on `device` (default cuda)."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    def host(y):
        return y.cpu().numpy()

    dh = np.linspace(0, 360, 721)
    d_cpa = np.linspace(-2 * params.safe_distance, 2 * params.safe_distance,
                        801)
    dd = np.linspace(-params.d_dev_max_reward * 1.2,
                     params.d_dev_max_reward * 1.2, 801)
    dg = np.linspace(0, params.d_goal_max_reward, 801)
    steps = np.arange(0, params.max_steps + 1)
    curves = {"heading": (dh, host(R.heading_reward(t(dh), t(0.0))))}
    for vc, name in [(-1.0, "closest_approach_closing"),
                     (1.0, "closest_approach_separating")]:
        curves[name] = (d_cpa, host(R.closest_approach_reward(
            torch.full_like(t(d_cpa), vc), t(d_cpa), params.safe_distance)))
    curves["plan_deviation"] = (dd, host(R.plan_deviation_reward(
        t(dd), params.d_dev_max_reward)))
    curves["goal_distance"] = (dg, host(R.goal_distance_reward(
        t(dg), params.d_goal_max_reward)))
    for dcpa_v, name in [(50.0, "polarized_plus_50"),
                         (-50.0, "polarized_minus_50")]:
        curves[name] = (dd, host(R.polarized_plan_deviation_reward(
            t(dd), torch.full_like(t(dd), dcpa_v), params.d_dev_max_reward)))
    curves["time_discount"] = (steps, 1.0 - steps / params.max_steps)
    return curves


def reward_shapes(params, out_png: str, device=None):
    """Reward-term shape exploration (the rewards.ipynb notebook): the
    curves of `reward_shape_curves` in six panels."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = reward_shape_curves(params, device)
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))

    axes[0, 0].plot(*c["heading"])
    axes[0, 0].set_title("heading_reward vs Δheading [deg]")

    axes[0, 1].plot(*c["closest_approach_closing"], label="closing (v_c<=0)")
    axes[0, 1].plot(*c["closest_approach_separating"], label="separating")
    axes[0, 1].axvline(params.safe_distance, ls=":", c="gray")
    axes[0, 1].legend()
    axes[0, 1].set_title("closest_approach_reward vs d_cpa [px]")

    axes[0, 2].plot(*c["plan_deviation"])
    axes[0, 2].set_title("plan_deviation_reward vs d_dev [px]")

    axes[1, 0].plot(*c["goal_distance"])
    axes[1, 0].set_title("goal_distance_reward vs d_goal [px]")

    axes[1, 1].plot(*c["polarized_plus_50"], label="d_cpa=+50")
    axes[1, 1].plot(*c["polarized_minus_50"], label="d_cpa=-50")
    axes[1, 1].legend()
    axes[1, 1].set_title("polarized_plan_deviation_reward (display-only)")

    axes[1, 2].plot(*c["time_discount"])
    axes[1, 2].set_title("time-discount factor vs step")

    for ax in axes.flat:
        ax.grid(alpha=0.3)
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return out_png


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--csv", help="episode CSV from baseline/eval")
    ap.add_argument("--learning-curve", dest="lc",
                    help="eval.csv from a training run")
    ap.add_argument("--reward-shapes", action="store_true",
                    help="plot the shaped-reward terms (rewards.ipynb)")
    ap.add_argument("--out-dir", default="runs/analysis")
    ap.add_argument("--episodes", type=int, nargs="*",
                    help="episode numbers for per-episode replay PNGs")
    ap.add_argument("--device", default=None,
                    help="torch device of --reward-shapes (default cuda)")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)

    if args.csv:
        rows = read_csv(args.csv)
        summary = outcome_summary(rows)
        print(json.dumps(summary, indent=2))
        with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        trajectory_overview(rows, DEFAULT_PARAMS,
                            os.path.join(args.out_dir, "trajectories.png"))
        if args.episodes:
            from acas2d_tpu_torch.render import render_run_csv
            render_run_csv(args.csv, args.out_dir, args.episodes)
        print(f"wrote {args.out_dir}", file=sys.stderr)

    if args.lc:
        png = learning_curve(args.lc,
                             os.path.join(args.out_dir, "learning_curve.png"))
        print(f"wrote {png}", file=sys.stderr)

    if args.reward_shapes:
        png = reward_shapes(DEFAULT_PARAMS,
                            os.path.join(args.out_dir, "reward_shapes.png"),
                            args.device)
        print(f"wrote {png}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
