"""Greedy-policy evaluation driver of the PyTorch port.

Evaluates a policy on episodes spawned from the reference's Mersenne
stream, as the JAX driver `eval.py` does: a portable params artifact
(`--params-npz`, flat npz of the flax tree, the JAX package's
`utils/params_io.py` format), or a checkpoint of a port training run
(`--run DIR`: its latest, `--step N`, or `--best`, the best in-training
eval's).  `--exact` steps the environment in float64 (the policy runs in
float32, as there).  Prints one line per episode on stderr and a JSON
summary on stdout.

    python -m acas2d_tpu_torch.eval \\
        --params-npz artifacts/ppo_tpu_e_polished_best.npz --exact --episodes 100
    python -m acas2d_tpu_torch.eval --run runs/ppo/<run-name> --best --exact

The JAX driver's episode CSV (`--out`) and rendering are not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np
import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.config import DEFAULT_PARAMS, OUTCOME_NAMES
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.oracle import MersenneSpawner
from acas2d_tpu_torch.ppo import learner
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
    """The (N_PARAMS,) float32 params of --params-npz or of a --run
    checkpoint (whose iteration goes to stderr, as JAX eval.py prints it)."""
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


def run(args, log=None) -> Dict[str, float]:
    """Evaluate; returns the summary.  One line per episode goes to `log`
    (a text stream) when given."""
    device = resolve_device(args.device)
    params = load_params(args).to(device)
    spawner = MersenneSpawner(DEFAULT_PARAMS, seed=args.seed,
                              skip_episodes=args.skip_episodes)
    dtype = torch.float64 if args.exact else torch.float32
    ep = learner.exact_episodes(params, DEFAULT_PARAMS, spawner,
                                args.episodes, dtype, device)
    ret = ep["return"].cpu().numpy()
    length = ep["length"].cpu().numpy()
    outcome = ep["outcome"].cpu().numpy()
    for b in range(args.episodes if log is not None else 0):
        print(f"Episode {b + 1:<3}: Time steps: {int(length[b]):<7} - "
              f"Outcome: {OUTCOME_NAMES.get(int(outcome[b]), 'Running'):<10}"
              f" - Total Reward = {float(ret[b])}", file=log)
    return {
        "episodes": args.episodes,
        "mean_reward": float(np.mean(ret)),
        "std_reward": float(np.std(ret)),
        # the sample std; artifacts/*.json records the std this way
        "std_reward_ddof1": float(np.std(ret, ddof=1)),
        "goals": int((outcome == 1).sum()),
        "collisions": int((outcome == 2).sum()),
        "timeouts": int((outcome == 3).sum()),
        "mean_length": float(np.mean(length)),
        "device": str(device),
        "dtype": str(dtype).replace("torch.", ""),
    }


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv), log=sys.stderr)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
