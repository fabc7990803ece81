"""Greedy-policy evaluation driver of the PyTorch port.

Evaluates a portable params artifact (flat npz of the flax tree, the JAX
package's `utils/params_io.py` format) on episodes spawned from the
reference's Mersenne stream, as the JAX driver `eval.py --params-npz` does:
`--exact` steps the environment in float64 (the policy runs in float32, as
there).  Prints one line per episode on stderr and a JSON summary on stdout.

    python -m acas2d_tpu_torch.eval \\
        --params-npz artifacts/ppo_tpu_e_polished_best.npz --exact --episodes 100
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.config import DEFAULT_PARAMS, OUTCOME_NAMES
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.oracle import MersenneSpawner
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.utils.params_io import from_jax_params, load_params_npz


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--params-npz", required=True,
                   help="portable params artifact (flat npz of the flax tree)")
    p.add_argument("--episodes", type=int, default=100)    # TEST_EPISODES
    p.add_argument("--exact", action="store_true",
                   help="float64 environment stepping")
    p.add_argument("--skip-episodes", type=int, default=2,
                   help="Mersenne spawns consumed before the first episode "
                        "(the reference's gym.make + check_env)")
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    return p.parse_args(argv)


def run(args, log=None) -> Dict[str, float]:
    """Evaluate; returns the summary.  One line per episode goes to `log`
    (a text stream) when given."""
    device = resolve_device(args.device)
    model = ActorCritic()
    model.load_state_dict(from_jax_params(load_params_npz(args.params_npz)))
    params = flatten(model).to(device)
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
