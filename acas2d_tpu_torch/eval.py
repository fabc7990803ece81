"""Greedy-policy evaluation driver of the PyTorch port.

Evaluates a policy on episodes spawned from the reference's Mersenne
stream, as the JAX driver `eval.py` does: a portable params artifact
(`--params-npz`, flat npz of the flax tree, the JAX package's
`utils/params_io.py` format), or a checkpoint of a port training run
(`--run DIR`: its latest, `--step N`, or `--best`, the best in-training
eval's).  `--exact` steps the environment in float64 (the policy runs in
float32, as there).  Prints one line per episode on stderr and a JSON
summary on stdout, and writes the episodes' telemetry CSV with the
reference's schema (`--out`, default `<run or .>/eval_<episodes>.csv`, as
the JAX driver's).

    python -m acas2d_tpu_torch.eval \\
        --params-npz artifacts/ppo_tpu_e_polished_best.npz --exact \\
        --episodes 100 --out runs/eval_100.csv
    python -m acas2d_tpu_torch.eval --run runs/ppo/<run-name> --best --exact

The episodes are played once, by the greedy telemetry rollout
(`envs/telemetry.py`), as the JAX driver plays them: the CSV holds their
records, and the summary is taken from the records' Outcome, Total Reward
and Time Steps.  The JAX driver's rendering (`--render-every`, `--view`)
is not ported.
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
from acas2d_tpu_torch.envs import telemetry
from acas2d_tpu_torch.models.actor_critic import (ActorCritic, apply_flat,
                                                  flatten)
from acas2d_tpu_torch.oracle import MersenneSpawner
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.utils import episode_csv
from acas2d_tpu_torch.utils.checkpoint import CheckpointManager
from acas2d_tpu_torch.utils.params_io import from_jax_params, load_params_npz


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--run", default=None,
                     help="a training run dir; its checkpoints/ is read")
    src.add_argument("--params-npz", default=None,
                     help="portable params artifact (flat npz of the flax "
                          "tree)")
    p.add_argument("--step", type=int, default=None,
                   help="with --run: the checkpoint of this global step "
                        "(default the latest)")
    p.add_argument("--best", action="store_true",
                   help="with --run: the best in-training eval's checkpoint")
    p.add_argument("--episodes", type=int, default=100)    # TEST_EPISODES
    p.add_argument("--out", default=None,
                   help="the episode CSV (default <run or .>/eval_<episodes>"
                        ".csv)")
    p.add_argument("--exact", action="store_true",
                   help="float64 environment stepping")
    p.add_argument("--skip-episodes", type=int, default=2,
                   help="Mersenne spawns consumed before the first episode "
                        "(the reference's gym.make + check_env)")
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    if args.params_npz and (args.best or args.step is not None):
        p.error("--best and --step select a checkpoint of --run")
    if args.best and args.step is not None:
        p.error("--best and --step are exclusive")
    return args


def load_params(args) -> torch.Tensor:
    """The (N_PARAMS,) params of --params-npz (float32) or of a --run
    checkpoint, in the run's dtype (its iteration goes to stderr, as JAX
    eval.py prints it)."""
    if args.params_npz:
        model = ActorCritic()
        model.load_state_dict(
            from_jax_params(load_params_npz(args.params_npz)))
        return flatten(model)
    ckpt = CheckpointManager(os.path.join(args.run, "checkpoints"))
    raw = ckpt.restore_raw(step=args.step, best=args.best)
    if raw["params"].dim() != 1:
        raise ValueError(f"{args.run} is a population run; evaluate its "
                         f"selected_best.npz with --params-npz")
    print(f"loaded checkpoint (iteration {int(raw['iteration'])})",
          file=sys.stderr)
    return raw["params"]


def telemetry_episodes(params: torch.Tensor, env_state, obs: torch.Tensor
                       ) -> List[Dict]:
    """The reference's per-episode records (`episode_csv.episode_records`)
    of the greedy policy from a reset batch: the telemetry rollout of
    max_steps steps, each episode cut at its first done (JAX
    eval.py:221-243).  The policy is the float32 clip(mean, -1, 1), in the
    env's dtype."""
    P = DEFAULT_PARAMS
    dtype = env_state.px.dtype
    model = ActorCritic(device=params.device)

    def policy(o):
        mean = apply_flat(model, params, o.to(params.dtype))[0][:, 0]
        return torch.clamp(mean, -1.0, 1.0).to(dtype)

    init = telemetry.initial_telemetry(env_state, P)
    _, tel = telemetry.rollout_telemetry_policy(env_state, obs, P.max_steps,
                                                policy, P)
    init = {k: v.cpu().numpy() for k, v in init.items()}
    tel = telemetry.Telemetry(**{k: v.cpu().numpy()
                                 for k, v in vars(tel).items()})
    nt = env_state.num_traffic.cpu().numpy()
    episodes = []
    for b in range(nt.shape[0]):
        tel_b = telemetry.Telemetry(**{k: v[:, b]
                                       for k, v in vars(tel).items()})
        done_idx = np.nonzero(tel_b.done)[0]
        k = int(done_idx[0]) + 1 if done_idx.size else P.max_steps
        episodes.append(episode_csv.episode_records(
            {name: v[b] for name, v in init.items()}, tel_b, k, int(nt[b])))
    return episodes


def run(args, log=None) -> Dict[str, float]:
    """Evaluate and write the episode CSV; returns the summary.  One line
    per episode goes to `log` (a text stream) when given."""
    device = resolve_device(args.device)
    params = load_params(args).to(device)
    spawner = MersenneSpawner(DEFAULT_PARAMS, seed=args.seed,
                              skip_episodes=args.skip_episodes)
    dtype = torch.float64 if args.exact else torch.float32
    env_state, obs = learner.mersenne_reset(DEFAULT_PARAMS, spawner,
                                            args.episodes, dtype, device)
    episodes = telemetry_episodes(params, env_state, obs)
    out = args.out or os.path.join(args.run or ".",
                                   f"eval_{args.episodes}.csv")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    episode_csv.write_csv(out, episodes, episode_csv.FULL_COLUMNS)
    ret = np.array([e["Total Reward"] for e in episodes], np.float64)
    length = np.array([e["Time Steps"] - 1 for e in episodes])
    outcome = [e["Outcome"] for e in episodes]
    for b in range(args.episodes if log is not None else 0):
        print(f"Episode {b + 1:<3}: Time steps: {int(length[b]):<7} - "
              f"Outcome: {outcome[b]:<10} - Total Reward = {float(ret[b])}",
              file=log)
    if log is not None:
        print(f"wrote {out}", file=log)
    return {
        "episodes": args.episodes,
        "mean_reward": float(np.mean(ret)),
        "std_reward": float(np.std(ret)),
        # the sample std; artifacts/*.json records the std this way
        "std_reward_ddof1": float(np.std(ret, ddof=1)),
        "goals": outcome.count("Goal"),
        "collisions": outcome.count("Collision"),
        "timeouts": outcome.count("Timeout"),
        "mean_length": float(np.mean(length)),
        "device": str(device),
        "dtype": str(dtype).replace("torch.", ""),
    }


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv), log=sys.stderr)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
