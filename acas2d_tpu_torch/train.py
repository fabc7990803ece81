"""PPO training driver of the PyTorch port (fused path).

The subset of the JAX driver (`train.py:41-290`) that the port's first slice
covers: solo PPO at the `reference` or `tpu` preset, where every rollout
chunk runs the fused policy-in-kernel rollout and every minibatch gradient
runs the fused PPO-gradient kernel (on a CUDA device; the plain PyTorch
versions of the same arithmetic on the CPU).  It prints one JSON line of
metrics per iteration on stdout.

    python -m acas2d_tpu_torch.train --preset tpu --total-steps 2621440
    python -m acas2d_tpu_torch.train --preset tpu --device cpu --n-envs 64 \\
        --n-steps 32 --minibatch-size 512 --total-steps 4096

The fused paths are on by default (`--no-fused-rollout` and
`--no-fused-update` ask for the unfused ones, which are not ported yet).
Options the port does not implement yet are refused with an error, so a JAX
command line never silently means something else: the fused-update
variants map onto their `PPOConfig` fields, which `learner.make_train_step`
refuses, and flags with no port at all (`--population`) are unknown to the
parser.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List

import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.ppo.config import PPOConfig, tpu_default


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", choices=["reference", "tpu"], default="reference")
    p.add_argument("--n-envs", type=int, default=None)
    p.add_argument("--n-steps", type=int, default=None)
    p.add_argument("--total-steps", type=int, default=None)
    p.add_argument("--minibatch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--n-epochs", type=int, default=None)
    p.add_argument("--ent-coef", type=float, default=None)
    p.add_argument("--shuffle-block", type=int, default=None,
                   help="epoch-shuffle block size in rows (1 = exact SB3 "
                        "row shuffle; default auto: 512 at minibatch>=32768)")
    p.add_argument("--anneal-lr", action="store_true",
                   help="linear LR decay to 0 over the run")
    p.add_argument("--fused-chunk", type=int, default=None,
                   help="steps per fused rollout launch (default 16)")
    p.add_argument("--fused-rollout", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="collect rollouts with the fused policy-in-kernel "
                        "rollout (default on; the unfused path is not "
                        "ported yet)")
    p.add_argument("--fused-update", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="compute each minibatch gradient with the fused "
                        "PPO-gradient kernel (default on; the autograd "
                        "update is not ported yet)")
    p.add_argument("--fused-update-packed", action="store_true",
                   help="the packed-parameter update (not ported yet)")
    p.add_argument("--fused-update-bf16", action="store_true",
                   help="bf16 operands in the update kernel (not ported yet)")
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--eval-every", type=int, default=None)
    p.add_argument("--eval-episodes", type=int, default=None)
    p.add_argument("--exact-eval", action="store_true",
                   help="evaluate on the reference's Mersenne spawn stream "
                        "(one continuing stream, as eval.py --exact)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    return p.parse_args(argv)


def build_config(args) -> PPOConfig:
    cfg = tpu_default() if args.preset == "tpu" else PPOConfig()
    fields = {"n_envs": args.n_envs, "n_steps": args.n_steps,
              "total_timesteps": args.total_steps,
              "minibatch_size": args.minibatch_size,
              "learning_rate": args.lr, "n_epochs": args.n_epochs,
              "ent_coef": args.ent_coef,
              "shuffle_block_size": args.shuffle_block,
              "fused_chunk": args.fused_chunk,
              "eval_every_steps": args.eval_every,
              "eval_episodes": args.eval_episodes}
    overrides = {k: v for k, v in fields.items() if v is not None}
    overrides.update(seed=args.seed, anneal_lr=args.anneal_lr,
                     fused_rollout=args.fused_rollout,
                     fused_update=args.fused_update,
                     fused_update_packed=args.fused_update_packed,
                     fused_update_bf16=args.fused_update_bf16)
    return dataclasses.replace(cfg, **overrides)


def run(args) -> List[Dict[str, float]]:
    """Train; returns the per-iteration metric rows it printed."""
    cfg = build_config(args)
    device = resolve_device(args.device)
    env_params = DEFAULT_PARAMS
    train_step = learner.make_train_step(cfg, env_params, device)
    state = learner.init_train_state(cfg, env_params, device)
    if args.exact_eval:
        eval_fn = learner.make_exact_eval_fn(cfg, env_params, device=device)
    else:
        eval_fn = learner.make_eval_fn(cfg, env_params, device=device)
    eval_gen = torch.Generator().manual_seed(cfg.seed + 1)

    rows = []
    next_eval = 0
    for it in range(cfg.n_iterations):
        t0 = time.perf_counter()
        state, metrics = train_step(state)
        keys = list(metrics)
        values = torch.stack([metrics[k].to(torch.float64)
                              for k in keys]).tolist()     # one sync
        dt = time.perf_counter() - t0
        gstep = state.iteration * cfg.batch_size
        row = dict(zip(keys, values))
        row.update(iteration=state.iteration, global_step=gstep,
                   steps_per_s=cfg.batch_size / dt, seconds=dt)
        if gstep >= next_eval:
            em = eval_fn(state.params, eval_gen)
            row.update({k: float(v) for k, v in em.items()})
            while next_eval <= gstep:
                next_eval += cfg.eval_every_steps
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
