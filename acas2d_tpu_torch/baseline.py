"""Scripted-policy baseline driver of the PyTorch port (JAX `baseline.py`).

Runs N episodes under a scripted policy and writes the reference's CSV
schema (baseline_main.py / gym_main.py rebuilt).  Episodes spawn from the
seed-13 Mersenne stream at the reference's stream offset
(`--skip-episodes 2`), all B of them at once (`learner.mersenne_reset`);
the (T, B) scripted actions play through the telemetry rollout
(`envs/telemetry.py`) on the device, and each episode is cut at its first
done.  `--exact` (the default) steps in float64, which reproduces
`models/logs/baseline_ACAS2D_PPO_11_100.csv`: outcomes, step counts and
aggregates exactly, trajectories within 1e-10 px.  `--fast` steps in
float32.

Unlike the JAX driver, which pins `--exact` to the CPU, the port runs
float64 where `--device` says (default cuda); `--device cpu` runs the
same episodes on the CPU.

Policies (gym_main.py:35-41 variants):
    zero        action = 0                      (baseline_main.py:44)
    mod3        action = (episode % 3) - 1      (gym_main.py:36)
    cosine      action = cos(2*pi*t/360)        (gym_main.py:35, commented)
    replay      --actions-file, padded with its last value (gym_main.py:38-41)

Example:
    python -m acas2d_tpu_torch.baseline --episodes 100 --out runs/baseline.csv
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.config import DEFAULT_PARAMS, EnvParams
from acas2d_tpu_torch.envs import telemetry
from acas2d_tpu_torch.oracle import MersenneSpawner
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.utils import episode_csv


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--episodes", type=int, default=100)   # TEST_EPISODES
    p.add_argument("--policy", choices=["zero", "mod3", "cosine", "replay"],
                   default="zero")
    p.add_argument("--actions-file", default=None,
                   help="with --policy replay: .npy or text file of actions "
                        "in [-1,1], replayed per episode (padded with its "
                        "last value) — the gym_main.py recorded-actions "
                        "use case (gym_main.py:14,38-41)")
    p.add_argument("--out", default="runs/baseline.csv")
    p.add_argument("--full-telemetry", action="store_true",
                   help="write all testing_main.py columns, not just the "
                        "baseline_main.py subset")
    p.add_argument("--exact", dest="exact", action="store_true", default=True,
                   help="float64 stepping + Mersenne spawn stream (default)")
    p.add_argument("--fast", dest="exact", action="store_false",
                   help="float32 stepping")
    p.add_argument("--skip-episodes", type=int, default=2,
                   help="spawn-stream offset; the reference burns 2 spawns "
                        "(gym.make + check_env) before episode 1")
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    return p.parse_args(argv)


def scripted_actions(policy: str, T: int, B: int,
                     actions_file: str = None) -> np.ndarray:
    """The (T, B) float64 actions of a scripted policy (JAX
    baseline.py:84-104)."""
    t_idx = np.arange(T)[:, None]
    ep_idx = np.arange(1, B + 1)[None, :]
    if policy == "zero":
        return np.zeros((T, B))
    if policy == "mod3":
        return np.broadcast_to((ep_idx % 3) - 1, (T, B)).astype(float)
    if policy == "replay":
        if not actions_file:
            raise SystemExit("--policy replay requires --actions-file")
        if actions_file.endswith(".npy"):
            seq = np.load(actions_file).reshape(-1)
        else:
            seq = np.loadtxt(actions_file).reshape(-1)
        padded = np.full(T, seq[-1], dtype=float)
        padded[:min(T, len(seq))] = seq[:T]
        return np.broadcast_to(padded[:, None], (T, B)).astype(float)
    return np.broadcast_to(
        np.cos(((t_idx % 360) / 360) * 2 * np.pi), (T, B)).astype(float)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    P = DEFAULT_PARAMS if args.seed == 13 else EnvParams(seed=args.seed)
    dtype = torch.float64 if args.exact else torch.float32
    B, T = args.episodes, P.max_steps
    actions = scripted_actions(args.policy, T, B, args.actions_file)

    spawner = MersenneSpawner(P, skip_episodes=args.skip_episodes)
    state, _ = learner.mersenne_reset(P, spawner, B, dtype, device)
    init = telemetry.initial_telemetry(state, P)
    _, tel = telemetry.rollout_telemetry(
        state, torch.as_tensor(actions, dtype=dtype, device=device), P)
    episodes = episode_csv.batch_records(
        {k: v.cpu().numpy() for k, v in init.items()}, tel.numpy(),
        state.num_traffic.cpu().numpy())
    for b, rec in enumerate(episodes):
        k = rec["Time Steps"] - 1                  # the actions it took
        print(f"Episode {b+1:<3}: Time steps: {k-1:<7} - "
              f"Outcome: {rec['Outcome']:<10} - "
              f"Total Reward = {rec['Total Reward']}")

    cols = (episode_csv.FULL_COLUMNS if args.full_telemetry
            else episode_csv.BASELINE_COLUMNS)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    episode_csv.write_csv(args.out, episodes, cols)

    outcomes = [e["Outcome"] for e in episodes]
    print(f"\n{B} episodes | "
          f"Goal {outcomes.count('Goal')} / "
          f"Collision {outcomes.count('Collision')} / "
          f"Timeout {outcomes.count('Timeout')} | "
          f"mean reward {np.mean([e['Total Reward'] for e in episodes]):.2f} | "
          f"mean steps {np.mean([e['Time Steps'] for e in episodes]):.2f}",
          file=sys.stderr)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
