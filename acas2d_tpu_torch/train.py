"""PPO training driver of the PyTorch port (fused path).

The subset of the JAX driver (`train.py`) that the port covers: solo PPO,
and population training (`--population P`, `ppo/population.py`), at the
`reference` or `tpu` preset, where every rollout chunk runs the fused
policy-in-kernel rollout and every minibatch gradient runs the fused
PPO-gradient kernel (on a CUDA device; the plain PyTorch versions of the
same arithmetic on the CPU).  It prints one JSON line of metrics per
iteration on stdout.

    python -m acas2d_tpu_torch.train --preset tpu --total-steps 2621440
    python -m acas2d_tpu_torch.train --preset tpu --device cpu --n-envs 64 \\
        --n-steps 32 --minibatch-size 512 --total-steps 4096

Population training is the shipped pipeline's command
(`scripts/population_pipeline.sh`, without `--checkpoint-every`):

    python -m acas2d_tpu_torch.train --preset tpu --anneal-lr \\
        --population 32 --fused-rollout --fused-update-packed \\
        --n-envs 1024 --minibatch-size 32768 --total-steps 268435456 \\
        --eval-episodes 32 --reval-episodes 512 \\
        --polish-steps 33554432 --polish-pop 16 --polish-rounds 2

It trains P members (member i as a solo run with seed + i), evaluates
every member at the eval cadence, keeps each member's best snapshots,
re-evaluates all of them at the end and writes `selected_best.npz`,
`top_snapshots.npz`, `population.json` and `summary.json` into
`<out-dir>/<run-name>/`.  `--polish-steps` then chains polish stages
(`<run-name>_polish`, ...), each warm-started round-robin from the previous
stage's top snapshots.  `global_step` counts each member's env-steps;
`steps_per_s` is the whole population's.

The fused paths are on by default (`--no-fused-rollout` and
`--no-fused-update` ask for the unfused ones, which are not ported yet).
`--fused-update-packed` is the fused update in the port (its parameters
are always one flat vector in the kernel's layout), and
`--fused-update-bf16` rounds the gradient kernel's product operands to
bf16.  Options the port does not implement yet are refused with an error,
so a JAX command line never silently means something else: the unfused
paths map onto their `PPOConfig` fields, which `learner.check_ported`
refuses, and flags with no port at all (`--checkpoint-every`, `--resume`)
are unknown to the parser.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.ppo import learner, population
from acas2d_tpu_torch.ppo.config import PPOConfig, tpu_default
from acas2d_tpu_torch.utils.params_io import load_flat_params


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
                   help="the packed-parameter update of the JAX package; in "
                        "the port the same update as the fused one (its "
                        "parameters are always one flat vector in the "
                        "kernel's layout). Implies --fused-update")
    p.add_argument("--fused-update-bf16", action="store_true",
                   help="round the operands of the update kernel's matrix "
                        "products to bf16 (float32 sums); solo and "
                        "population runs")
    p.add_argument("--population", type=int, default=0, metavar="P",
                   help="train P member policies side by side (member i as "
                        "a solo run with --seed seed+i), one kernel launch "
                        "per rollout chunk and per minibatch step for all "
                        "of them, and select the best member's snapshot at "
                        "the end (ppo/population.py)")
    p.add_argument("--reval-episodes", type=int, default=256,
                   help="population mode: episodes of the end-of-run "
                        "re-eval of every archived snapshot that drives "
                        "the risk-adjusted selection (0 = select by the "
                        "in-training evals)")
    p.add_argument("--polish-steps", type=int, default=0, metavar="N",
                   help="population mode: after selection, train a fresh "
                        "population warm-started from the top snapshots "
                        "for N more steps at --polish-lr, with its own "
                        "selection")
    p.add_argument("--polish-pop", type=int, default=0,
                   help="polish population size (default population // 2)")
    p.add_argument("--polish-lr", type=float, default=1e-4)
    p.add_argument("--polish-rounds", type=int, default=1,
                   help="chain this many polish stages, each warm-started "
                        "from the previous stage's top-3 snapshots")
    p.add_argument("--init-params-npz", default=None,
                   help="warm-start the policy from a params npz; a "
                        "stacked artifact (top_snapshots.npz) spreads its "
                        "policies round-robin over a population's members. "
                        "Optimizer, env state and step counter start fresh")
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--out-dir", default="runs/ppo",
                   help="population mode: where the run dir goes")
    p.add_argument("--run-name", default=None)
    p.add_argument("--eval-every", type=int, default=None)
    p.add_argument("--eval-episodes", type=int, default=None)
    p.add_argument("--exact-eval", action="store_true",
                   help="evaluate on the reference's Mersenne spawn stream "
                        "(one continuing stream, as eval.py --exact); solo "
                        "runs only")
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
                     fused_update=(args.fused_update
                                   or args.fused_update_packed),
                     fused_update_packed=args.fused_update_packed,
                     fused_update_bf16=args.fused_update_bf16)
    return dataclasses.replace(cfg, **overrides)


def _init_params(path: str, pop: int) -> torch.Tensor:
    """Warm-start params from an npz: (N_PARAMS,) solo, (pop, N_PARAMS) for
    a population, whose members take a stacked artifact's policies
    round-robin (JAX train.py:343-368)."""
    flat, stack_n = load_flat_params(path)
    if not pop:
        if stack_n is not None:
            raise ValueError(f"{path} holds {stack_n} stacked policies; "
                             f"warm-start one with --population")
        print(f"warm-started params from {path}", file=sys.stderr)
        return flat
    if stack_n is None:
        print(f"population warm-started from {path}", file=sys.stderr)
        return flat[None].repeat(pop, 1)
    print(f"population warm-started round-robin from {stack_n} lineages in "
          f"{path}", file=sys.stderr)
    return flat[torch.arange(pop) % stack_n]


def _emit(row: Dict, rows: List[Dict]) -> None:
    print(json.dumps(row), flush=True)
    rows.append(row)


def run(args) -> List[Dict[str, float]]:
    """Train; returns the per-iteration metric rows it printed (of every
    stage, polish stages included)."""
    if args.population:
        return run_population(args)
    cfg = build_config(args)
    device = resolve_device(args.device)
    env_params = DEFAULT_PARAMS
    train_step = learner.make_train_step(cfg, env_params, device)
    state = learner.init_train_state(cfg, env_params, device)
    if args.init_params_npz:
        state = state.replace(
            params=_init_params(args.init_params_npz, 0).to(device))
    if args.exact_eval:
        eval_fn = learner.make_exact_eval_fn(cfg, env_params, device=device)
    else:
        eval_fn = learner.make_eval_fn(cfg, env_params, device=device)
    eval_gen = torch.Generator().manual_seed(cfg.seed + 1)

    rows = []
    next_eval = 0
    # until the budget is spent, the last iteration included when the budget
    # is not a multiple of the batch (JAX train.py:538)
    while state.iteration * cfg.batch_size < cfg.total_timesteps:
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
        _emit(row, rows)
    return rows


def run_population(args) -> List[Dict]:
    """Population training (JAX train.py's --population path): train, eval
    and archive, re-eval every snapshot, select, then chain the polish
    stages.  Each printed row holds the member means, the best member's
    return and, on eval rows, every member's eval return."""
    if args.exact_eval:
        raise ValueError("--exact-eval is a single-policy protocol; evaluate "
                         "the selected member afterwards with "
                         "acas2d_tpu_torch.eval --exact")
    t_start = time.perf_counter()
    cfg = build_config(args)
    device = resolve_device(args.device)
    env_params = DEFAULT_PARAMS
    pop = args.population
    run_name = args.run_name or (
        f"ppo_pop{pop}_{cfg.n_envs}x{cfg.n_steps}_{cfg.total_timesteps}"
        f"_s{cfg.seed}")
    run_dir = os.path.join(args.out_dir, run_name)
    os.makedirs(run_dir, exist_ok=True)

    step = population.make_population_step(cfg, env_params, device)
    state = population.init_population(cfg, env_params, pop, device)
    if args.init_params_npz:
        state = state.replace(
            params=_init_params(args.init_params_npz, pop).to(device))
    eval_fn = population.make_population_eval(cfg, env_params, device=device)
    tracker = population.PopulationTracker(run_dir, pop, cfg.seed)
    eval_gen = torch.Generator().manual_seed(cfg.seed + 1)

    rows: List[Dict] = []
    next_eval = 0
    while state.iteration * cfg.batch_size < cfg.total_timesteps:
        t0 = time.perf_counter()
        state, metrics = step(state)
        keys = list(metrics)
        values = torch.stack([metrics[k].to(torch.float64)
                              for k in keys]).cpu().numpy()    # one sync
        dt = time.perf_counter() - t0
        gstep = state.iteration * cfg.batch_size
        row = {k: float(v.mean()) for k, v in zip(keys, values)}
        row.update(ep_return_max=float(values[keys.index("ep_return_mean")]
                                       .max()),
                   iteration=state.iteration, global_step=gstep,
                   steps_per_s=population.population_throughput_steps(
                       cfg, pop) / dt, seconds=dt)
        if gstep >= next_eval:
            em = {k: v.to(torch.float64).cpu().numpy()
                  for k, v in eval_fn(state.params, eval_gen).items()}
            vals = em["eval_return_mean"]
            row.update({k: float(v.mean()) for k, v in em.items()})
            row.update(eval_return_max=float(vals.max()),
                       eval_best_member=int(vals.argmax()),
                       eval_return_members=[round(float(v), 2)
                                            for v in vals])
            n_up = tracker.update(gstep, vals, state.params.cpu().numpy())
            if n_up:
                print(f"population: {n_up} member(s) improved; best="
                      f"{tracker.best_vals.max():.2f} (member "
                      f"{tracker.selected})", file=sys.stderr)
            while next_eval <= gstep:
                next_eval += cfg.eval_every_steps
        _emit(row, rows)

    reval_vals = reval_stds = None
    if args.reval_episodes > 0 and tracker.snap_params is not None:
        # one large fresh eval of every archived snapshot, pop x k at once
        reval_fn = population.make_population_eval(
            dataclasses.replace(cfg, eval_episodes=args.reval_episodes),
            env_params, device=device)
        flat, _ = tracker.snapshots_flat()
        rm = reval_fn(torch.as_tensor(flat, device=device),
                      torch.Generator().manual_seed(cfg.seed + 99))
        reval_vals = rm["eval_return_mean"].cpu().numpy()
        reval_stds = rm["eval_return_std"].cpu().numpy()
    selection = tracker.finalize(reval_vals, reval_episodes=args.reval_episodes,
                                 reval_stds=reval_stds)
    sel_val = selection.get("selected_reval",
                            selection["selected_training_eval"])
    print(f"population: selected member {selection['selected_member']} "
          f"(seed {selection['selected_seed']}, by "
          f"{selection['selected_by']}) eval {sel_val:.2f}", file=sys.stderr)
    total = time.perf_counter() - t_start
    steps_done = state.iteration * cfg.batch_size
    summary = {
        "run_name": run_name,
        "backend": "torch",
        "device": str(device),
        "config": {k: getattr(cfg, k) for k in (
            "n_envs", "n_steps", "total_timesteps", "minibatch_size",
            "n_epochs", "learning_rate", "anneal_lr", "seed",
            "fused_rollout", "fused_update", "eval_every_steps")},
        "population": pop,
        "global_step": steps_done,
        "total_wall_s": round(total, 3),
        "aggregate_steps_per_s": round(pop * steps_done / max(total, 1e-9), 1),
        "population_selection": selection,
    }
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)

    if args.polish_steps > 0:
        if tracker.snap_params is None:
            # no eval fired before total_timesteps: nothing to polish from
            print("polish skipped: no selection artifact", file=sys.stderr)
        else:
            rows += run(parse_args(polish_argv(args, run_dir, run_name)))
    return rows


def polish_argv(args, run_dir: str, run_name: str) -> List[str]:
    """The next polish stage's command line (JAX train.py:712-770): a
    population of --polish-pop members warm-started from this stage's top
    snapshots, seed + 50, --polish-lr, in `<run-name>_polish`."""
    init_art = os.path.join(run_dir, "top_snapshots.npz")
    polish_pop = args.polish_pop or max(args.population // 2, 1)
    argv = ["--population", str(polish_pop),
            "--init-params-npz", init_art,
            "--total-steps", str(args.polish_steps),
            "--lr", str(args.polish_lr),
            "--seed", str(args.seed + 50),
            "--run-name", f"{run_name}_polish",
            "--out-dir", args.out_dir,
            "--preset", args.preset,
            "--reval-episodes", str(args.reval_episodes)]
    for flag, val in (("--n-envs", args.n_envs),
                      ("--n-steps", args.n_steps),
                      ("--minibatch-size", args.minibatch_size),
                      ("--n-epochs", args.n_epochs),
                      ("--ent-coef", args.ent_coef),
                      ("--shuffle-block", args.shuffle_block),
                      ("--fused-chunk", args.fused_chunk),
                      ("--eval-episodes", args.eval_episodes),
                      ("--eval-every", args.eval_every),
                      ("--device", args.device)):
        if val is not None:
            argv += [flag, str(val)]
    for flag, on in (("--anneal-lr", args.anneal_lr),
                     ("--no-fused-rollout", not args.fused_rollout),
                     ("--no-fused-update", not args.fused_update),
                     ("--fused-update-packed", args.fused_update_packed),
                     ("--fused-update-bf16", args.fused_update_bf16)):
        if on:
            argv.append(flag)
    if args.polish_rounds > 1:
        argv += ["--polish-steps", str(args.polish_steps),
                 "--polish-pop", str(polish_pop),
                 "--polish-lr", str(args.polish_lr),
                 "--polish-rounds", str(args.polish_rounds - 1)]
    print(f"polish stage: {' '.join(argv)}", file=sys.stderr)
    return argv


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
