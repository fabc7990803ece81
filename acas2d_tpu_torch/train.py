"""PPO training driver of the PyTorch port.

The JAX driver (`train.py`) less its XLA- and TPU-only options: solo PPO,
and population training (`--population P`, `ppo/population.py`), at the
`reference` or `tpu` preset.  As in JAX, the rollout steps the env core
step by step and the update differentiates the PPO loss with autograd,
unless `--fused-rollout` (every rollout chunk one launch of the fused
policy-in-kernel rollout) and `--fused-update` (every minibatch gradient
one launch of the fused PPO-gradient kernel) ask for the kernels (on a
CUDA device; their plain PyTorch versions on the CPU); any of the four
combinations runs.  `--dtype float64` trains the unfused paths in float64
(params, Adam state, env state, buffers, GAE and evals), where JAX's
driver does so only under JAX_ENABLE_X64.  It prints one JSON line of
metrics per iteration on stdout, and logs, checkpoints and a summary into
its run directory.

    python -m acas2d_tpu_torch.train --preset tpu --fused-rollout \\
        --fused-update --total-steps 2621440
    python -m acas2d_tpu_torch.train --preset reference --exact-eval
    python -m acas2d_tpu_torch.train --preset tpu --device cpu --n-envs 64 \\
        --n-steps 32 --minibatch-size 512 --total-steps 4096

Population training is the shipped pipeline's command
(`scripts/population_pipeline.sh`):

    python -m acas2d_tpu_torch.train --preset tpu --anneal-lr \\
        --population 32 --fused-rollout --fused-update-packed \\
        --n-envs 1024 --minibatch-size 32768 --total-steps 268435456 \\
        --eval-episodes 32 --reval-episodes 512 --checkpoint-every 268435456 \\
        --polish-steps 33554432 --polish-pop 16 --polish-rounds 2

It trains P members (member i as a solo run with seed + i), evaluates
every member at the eval cadence, keeps each member's best snapshots,
re-evaluates all of them at the end and writes `selected_best.npz`,
`top_snapshots.npz`, `population.json` and `summary.json` into
`<out-dir>/<run-name>/`.  `--polish-steps` then chains polish stages
(`<run-name>_polish`, ...), each warm-started round-robin from the previous
stage's top snapshots; after each, its `population.json` gains the stage
before it (`stage1`) and the stage labels (`pipeline`), as JAX's
`scripts/population_merge.py` writes them.  `python -m
acas2d_tpu_torch.pipeline` runs the whole shipped pipeline.
`global_step` counts each member's env-steps; `steps_per_s` is the whole
population's.

`--iters-per-call K` runs K PPO iterations a call, as JAX's does: on the card
as K replays of one iteration captured as a CUDA graph
(`learner.make_train_loop`, `population.make_population_loop`), with one
read-back of the metrics a call; on the CPU as K eager steps.  Every
iteration still logs its row (`steps_per_s` is the call's K iterations over
its time, `seconds` its time over K); evals and checkpoints fire between
calls, so a budget that is not a multiple of K batches is overshot, as
JAX's loop does.  The default is JAX's: for `--preset tpu` on the card
eval_every / batch iterations, at most 16 (4 for the solo preset, 8 for
the pipeline's population), else 1.  With K = 1 every iteration is an eager
step.  `--profile` writes a `torch.profiler` trace (CPU and CUDA
activities) of calls 2-4 to `<run>/trace/trace.json`, a Chrome trace.

Every run keeps a run directory, `<out-dir>/<run-name>/` (JAX's default
name, `ppo_[popP_]<envs>x<steps>_<total>_s<seed>`):

    checkpoints/<step>/state.pt   every --checkpoint-every steps and at the
                                  end (or on Ctrl-C); the newest 5 are kept
    checkpoints/best/             the best in-training eval's state (solo)
    checkpoints/eval_counts.json  evals done at each checkpointed step
    train.csv / train.jsonl       one row per iteration
    eval.csv / eval.jsonl         one row per eval
    summary.json                  the run's record

`--resume` continues from the latest checkpoint bit for bit (params, Adam
state, env state, generators and the `--exact-eval` Mersenne stream);
`python -m acas2d_tpu_torch.eval --run DIR [--best | --step N]` scores a
checkpoint.  A resume that changes `--total-steps` names the run with
`--run-name`, since the default name holds the budget.

`summary.json` holds JAX's keys less `compile_cache`, with `device` and
`launches` (each kernel's launches in this process) and `process_group`
(the backend of a launch's group, else null) added: among them `n_devices`
(the ranks), `iters_per_call` and the phase timers
(`phases`, `phases_other_s`: `dispatch`, the call until its metrics are
queued; `train_first_call` and `train_step`, the read-back that waits for
them; `log`, `checkpoint`, `best_ckpt`, `final_reval` as JAX names them,
and `eval`, the port's synchronous eval, where JAX splits `eval_enqueue`
and `eval_resolve`).

Several cards train one run as JAX trains on several devices
(`parallel/mesh.py`), one process a card:

    python -m torch.distributed.run --nproc-per-node 4 \
        -m acas2d_tpu_torch.train --preset tpu --fused-rollout --fused-update

A solo run whose n_envs the ranks divide splits its envs over them and
averages their gradients at every minibatch step; a population whose P
they divide splits its members, with no collective in a step.  Otherwise
every rank runs the whole step, and the driver says so.  Rank 0 alone
writes the run dir, runs the evals and the population's selection, and
sends their outcome to the others; checkpoints hold the whole state in the
single process's layout, so a run resumes on another number of ranks.

The defaults are JAX's, so that a JAX command line means the same run:
the fused paths are off unless asked for (`--no-fused-rollout` and
`--no-fused-update` spell the default out).  `--fused-update-packed` is
the fused update in the port (its parameters are always one flat vector
in the kernel's layout), and `--fused-update-bf16` rounds the gradient
kernel's product operands to bf16; both imply `--fused-update`, as in JAX.
What the port does not run is refused with an error (`learner.
check_ported`: float64 with a fused kernel, which computes in float32),
and flags with no port at all (`--platform`, `--compile-cache`) are
unknown to the parser.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from acas2d_tpu_torch import population_merge
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.parallel import mesh as mesh_lib
from acas2d_tpu_torch.ppo import learner, population
from acas2d_tpu_torch.ppo.config import PPOConfig, tpu_default
from acas2d_tpu_torch.utils.checkpoint import CheckpointManager
from acas2d_tpu_torch.utils import profiling
from acas2d_tpu_torch.utils.logging import MetricsLogger, NullLogger
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
                   default=False,
                   help="collect rollouts with the fused policy-in-kernel "
                        "rollout, --fused-chunk steps a launch (default: "
                        "the step-by-step rollout, as JAX)")
    p.add_argument("--fused-update", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="compute each minibatch gradient with the fused "
                        "PPO-gradient kernel (default: autograd of the PPO "
                        "loss, as JAX)")
    p.add_argument("--fused-update-packed", action="store_true",
                   help="the packed-parameter update of the JAX package; in "
                        "the port the same update as the fused one (its "
                        "parameters are always one flat vector in the "
                        "kernel's layout). Implies --fused-update")
    p.add_argument("--fused-update-bf16", action="store_true",
                   help="round the operands of the update kernel's matrix "
                        "products to bf16 (float32 sums); solo and "
                        "population runs. Implies --fused-update")
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32",
                   help="the run's float type: params, Adam state, env "
                        "state, buffers, GAE and evals (float64 runs the "
                        "unfused rollout and update only)")
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
                   help="where the run dir goes")
    p.add_argument("--run-name", default=None,
                   help="the run dir's name (default ppo_[popP_]<envs>x"
                        "<steps>_<total>_s<seed>)")
    p.add_argument("--checkpoint-every", type=int, default=32768,
                   help="global steps between checkpoints (reference: "
                        "32768); checkpoints fire between iterations, and "
                        "once more at the end")
    p.add_argument("--resume", action="store_true",
                   help="continue from the run dir's latest checkpoint")
    p.add_argument("--eval-every", type=int, default=None)
    p.add_argument("--eval-episodes", type=int, default=None)
    p.add_argument("--exact-eval", action="store_true",
                   help="evaluate on the reference's Mersenne spawn stream "
                        "(one continuing stream, as eval.py --exact, which "
                        "a resume fast-forwards); solo runs only")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    p.add_argument("--iters-per-call", type=int, default=None,
                   help="PPO iterations a call: on the card K replays of "
                        "one iteration captured as a CUDA graph, one "
                        "metrics read-back a call; every iteration still "
                        "logs its row. Evals and checkpoints fire between "
                        "calls. Default: for --preset tpu on the card, "
                        "eval_every // batch_size capped at 16; else 1")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace (CPU and CUDA "
                        "activities, Chrome format) of calls 2-4 to "
                        "<run>/trace/trace.json and print the card's "
                        "memory at the end")
    args = p.parse_args(argv)
    args.argv = sys.argv[1:] if argv is None else list(argv)
    return args


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
                                   or args.fused_update_packed
                                   or args.fused_update_bf16),
                     fused_update_packed=args.fused_update_packed,
                     fused_update_bf16=args.fused_update_bf16)
    return dataclasses.replace(cfg, **overrides)


def dtype_of(args) -> torch.dtype:
    return torch.float64 if args.dtype == "float64" else torch.float32


def resolve_iters_per_call(requested: Optional[int], preset: str,
                           device: torch.device, cfg: PPOConfig) -> int:
    """--iters-per-call (JAX train.py:resolve_iters_per_call, whose
    accelerator backend is the card here): as asked, else for --preset tpu
    on the card eval_every / steps-per-iteration capped at 16, so that an
    eval fires at most once a call; else 1."""
    if requested is not None:
        return max(1, requested)
    if preset == "tpu" and device.type == "cuda":
        return max(1, min(16, cfg.eval_every_steps // cfg.batch_size))
    return 1


def one_iteration_a_call(step: Callable) -> Callable:
    """A step as a call of one iteration: metrics with a leading (1,)
    axis, as a loop of K gives them (K, ...)."""
    def call(state):
        state, metrics = step(state)
        return state, {k: v[None] for k, v in metrics.items()}
    return call


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


def init_params(path: str, pop: int, mesh: mesh_lib.Mesh) -> torch.Tensor:
    """`_init_params` as rank 0 reads it, on every rank."""
    return mesh_lib.broadcast_object(
        _init_params(path, pop) if mesh.rank == 0 else None, mesh)


def run_name_of(args, cfg: PPOConfig) -> str:
    """The run dir's name: --run-name, else JAX train.py's default."""
    pop = f"pop{args.population}_" if args.population else ""
    return args.run_name or (f"ppo_{pop}{cfg.n_envs}x{cfg.n_steps}_"
                             f"{cfg.total_timesteps}_s{cfg.seed}")


def count_prior_evals(run_dir: str, restored_step: int,
                      cfg: PPOConfig) -> int:
    """Evals a previous process performed up to `restored_step`, for the
    --exact-eval resume fast-forward (a copy of JAX train.py's): the count
    in checkpoints/eval_counts.json at that step; else the DISTINCT
    global_step values <= restored_step in eval.jsonl (a crash-then-resume
    cycle logs an eval twice); else the cadence formula."""
    if restored_step <= 0:
        return 0
    counts_path = os.path.join(run_dir, "checkpoints", "eval_counts.json")
    if os.path.exists(counts_path):
        try:
            with open(counts_path) as f:
                counts = json.load(f)
            if str(restored_step) in counts:
                return int(counts[str(restored_step)])
        except (ValueError, OSError):
            pass
    path = os.path.join(run_dir, "eval.jsonl")
    if os.path.exists(path):
        steps = set()
        with open(path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if int(row.get("global_step", 0)) <= restored_step:
                    steps.add(int(row.get("global_step", 0)))
        return len(steps)
    # thresholds 0, E, 2E, ... fire once each, the first on iteration 1
    return restored_step // cfg.eval_every_steps + 1


def record_eval_count(run_dir: str, step: int, evals_done: int) -> None:
    """Persist the evals performed by a checkpointed step, in
    checkpoints/eval_counts.json (read by count_prior_evals)."""
    path = os.path.join(run_dir, "checkpoints", "eval_counts.json")
    counts = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                counts = json.load(f)
        except (ValueError, OSError):
            counts = {}
    counts[str(step)] = int(evals_done)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(counts, f)
    os.replace(path + ".tmp", path)


def eval_generator(seed: int, gstep: int) -> torch.Generator:
    """The generator of the eval at `gstep`: keyed by (seed + 1, gstep), as
    JAX folds the step into its eval key, so every eval draws fresh
    episodes and a resumed run draws the same ones."""
    key = np.random.SeedSequence([seed + 1, gstep]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(key))


def _emit(row: Dict, rows: List[Dict], show: bool = True) -> None:
    if show:
        print(json.dumps(row), flush=True)
    rows.append(row)


class _Run:
    """What the solo and population loops share: the run dir, its
    checkpoints and loggers, resume, the iterations a call, the eval and
    checkpoint cadences, the loop, its phase timers and trace, and
    summary.json.

    On a mesh (`parallel/mesh.py`), every rank runs the loop in lockstep
    and rank 0 alone (`writer`) writes the run dir: its logs, checkpoints,
    trace and summary.  `sharded` says whether the state the loop carries
    is this rank's share (`learner.shard_state`, by env or with `members`
    by member), which `whole` gathers for a checkpoint."""

    def __init__(self, args, cfg: PPOConfig, run_dir: str,
                 mesh: Optional[mesh_lib.Mesh] = None, sharded: bool = False,
                 members: bool = False):
        mesh = mesh if mesh is not None else mesh_lib.make_mesh(args.device)
        self.t_main = time.perf_counter()
        self.args, self.cfg, self.run_dir = args, cfg, run_dir
        self.mesh, self.sharded, self.members = mesh, sharded, members
        self.writer = mesh.rank == 0
        self.device = mesh.device
        self.dtype = dtype_of(args)
        self.iters_per_call = resolve_iters_per_call(
            args.iters_per_call, args.preset, self.device, cfg)
        if self.writer:
            os.makedirs(run_dir, exist_ok=True)
            self.ckpt = CheckpointManager(os.path.join(run_dir,
                                                       "checkpoints"))
            self.logger = MetricsLogger(run_dir, "train")
            self.eval_logger = MetricsLogger(run_dir, "eval")
        else:
            self.ckpt = None
            self.logger = self.eval_logger = NullLogger()
        if mesh.distributed and not sharded:
            self.note(f"{'population' if members else 'n_envs'} "
                      f"{args.population if members else cfg.n_envs} does "
                      f"not split over {mesh.size} ranks: every rank runs "
                      f"the whole step")
        self.timers = profiling.PhaseTimers()
        self.launches0 = {k: f.launches
                          for k, f in learner.KERNELS.items()}
        self.evals_done = 0
        self.first_call_s = None
        self.t_start = self.start_step = None

    def note(self, msg: str) -> None:
        """A line on stderr, from rank 0 alone."""
        if self.writer:
            print(msg, file=sys.stderr)

    def gstep(self, state) -> int:
        return state.iteration * self.cfg.batch_size

    def whole(self, state):
        """The whole state: the ranks' shares gathered, on every rank."""
        if not self.sharded:
            return state
        return learner.gather_state(state, self.mesh, self.members)

    def start(self, state):
        """The whole state `state` (every rank builds it from the seed)
        resumed from the latest checkpoint if --resume finds one (rank 0
        reads it and sends it to every rank), its params checked to be the
        same on every rank, and then this rank's share of it; the evals
        done before it."""
        if self.args.resume:
            raw = None
            if self.writer:
                try:
                    raw = self.ckpt.restore()
                except FileNotFoundError:
                    pass
            raw = mesh_lib.broadcast_object(raw, self.mesh)
            if raw is None:
                self.note("no checkpoint found; starting fresh")
            else:
                state = learner.state_from_dict(raw, state)
                self.note(f"resumed from step {self.gstep(state)}")
        if self.mesh.distributed:
            ref = mesh_lib.broadcast(state.params.clone(), self.mesh)
            if not torch.equal(ref, state.params):
                raise RuntimeError(f"rank {self.mesh.rank}'s params differ "
                                   f"from rank 0's")
        if self.writer:
            self.evals_done = count_prior_evals(self.run_dir,
                                                self.gstep(state), self.cfg)
        if self.sharded:
            state = learner.shard_state(state, self.mesh, self.members)
        return state

    def save(self, state, flush=None) -> None:
        with self.timers("checkpoint"):
            whole = self.whole(state)
            if self.writer:
                self.ckpt.save(self.gstep(state),
                               learner.state_to_dict(whole))
                record_eval_count(self.run_dir, self.gstep(state),
                                  self.evals_done)
                if flush is not None:
                    flush()

    def loop(self, state, call, make_rows, steps_per_iter, evaluate,
             flush=None):
        """Train until the budget is spent, a call at a time: call(state)
        -> (state, metrics with a leading (K,) axis); make_rows(metrics)
        -> the call's K rows (one sync: the call's `seconds` run to its
        rows on the host, and `steps_per_iter` env-steps an iteration
        give `steps_per_s`).  A call that passes the budget runs whole
        (JAX train.py:538).  evaluate(state, gstep) -> (eval keys for the
        printed row, the eval log's row); evals and checkpoints fire
        between calls, their cadences restarting from the restored step.
        A Ctrl-C keeps the last whole call and saves it, with the
        generators rewound to its end.  With --profile, calls 2-4 are
        traced."""
        cfg, every, timers = self.cfg, self.args.checkpoint_every, self.timers
        rows: List[Dict] = []
        self.t_start = time.perf_counter()
        self.start_step = start = self.gstep(state)
        next_eval = (start // cfg.eval_every_steps) * cfg.eval_every_steps
        next_ckpt = (start // every) * every
        if start > 0:
            next_eval += cfg.eval_every_steps
            next_ckpt += every
        tracer = None
        calls = 0
        try:
            while self.gstep(state) < cfg.total_timesteps:
                if self.args.profile and calls == 1 and self.writer:
                    tracer = profiling.Trace(
                        os.path.join(self.run_dir, "trace"),
                        self.device.type == "cuda")
                    tracer.start()
                before = [g.get_state() for g in state.generators]
                t0 = time.perf_counter()
                try:
                    with timers("dispatch"):
                        new_state, metrics = call(state)
                    with timers("train_first_call" if calls == 0
                                else "train_step"):
                        call_rows = make_rows(metrics)
                except KeyboardInterrupt:
                    # the call drew from the generators: rewind them to
                    # the state that is kept
                    for g, s in zip(state.generators, before):
                        g.set_state(s)
                    raise
                dt = time.perf_counter() - t0
                if tracer is not None and calls == 3:
                    tracer.stop()
                    tracer = None
                calls += 1
                state = new_state
                if self.first_call_s is None:
                    self.first_call_s = dt
                n = len(call_rows)
                with timers("log"):
                    for i, row in enumerate(call_rows):
                        it = state.iteration - n + 1 + i
                        row.update(iteration=it,
                                   global_step=it * cfg.batch_size,
                                   steps_per_s=n * steps_per_iter / dt,
                                   seconds=dt / n)
                        self.logger.log(row, step=row["global_step"])
                gstep = self.gstep(state)
                if gstep >= next_eval:
                    t1 = time.perf_counter()
                    shown, logged = evaluate(state, gstep)
                    shown["eval_seconds"] = time.perf_counter() - t1
                    logged["eval_seconds"] = shown["eval_seconds"]
                    self.eval_logger.log(logged, step=gstep)
                    call_rows[-1] = {**call_rows[-1], **shown}
                    self.evals_done += 1
                    while next_eval <= gstep:
                        next_eval += cfg.eval_every_steps
                with timers("log"):
                    for row in call_rows:
                        _emit(row, rows, self.writer)
                if gstep >= next_ckpt:
                    self.save(state, flush)
                    while next_ckpt <= gstep:
                        next_ckpt += every
        except KeyboardInterrupt:
            self.note("interrupted; saving checkpoint")
        if tracer is not None:
            tracer.stop()
        self.save(state, flush)
        if self.args.profile and self.writer:
            mem = profiling.device_memory_stats(self.device)
            if mem:
                print(f"device memory: {mem}", file=sys.stderr)
        return state, rows

    def summary(self, state, selection: Optional[Dict] = None) -> Dict:
        """summary.json (rank 0's): JAX's keys, less that of its compile
        cache, with `device` and the kernels' `launches` in this process
        (of rank 0); a population's adds its aggregate rate and
        `selection`."""
        cfg = self.cfg
        total = time.perf_counter() - self.t_start
        phases = self.timers.report()
        steps_done = self.gstep(state) - self.start_step
        first_steps = (self.iters_per_call * cfg.batch_size
                       if self.first_call_s is not None else 0)
        post_steps = steps_done - first_steps
        post_wall = total - (self.first_call_s or 0.0)
        summary = {
            "run_name": os.path.basename(self.run_dir),
            "argv": self.args.argv,
            "backend": "torch",
            "device": str(self.device),
            "n_devices": self.mesh.size,
            "process_group": mesh_lib.backend_of(self.mesh),
            "config": {**{k: getattr(cfg, k) for k in (
                "n_envs", "n_steps", "total_timesteps", "minibatch_size",
                "n_epochs", "learning_rate", "anneal_lr", "seed",
                "fused_rollout", "fused_update", "eval_every_steps")},
                "dtype": self.args.dtype},
            "iters_per_call": self.iters_per_call,
            "population": self.args.population or None,
            "global_step": self.gstep(state),
            "steps_this_process": steps_done,
            "total_wall_s": round(total, 3),
            "init_s": round(self.t_start - self.t_main, 3),
            "avg_steps_per_s": round(steps_done / max(total, 1e-9), 1),
            "steady_steps_per_s": (round(post_steps / post_wall, 1)
                                   if post_wall > 0 and post_steps > 0
                                   else None),
            "first_call_s": (round(self.first_call_s, 3)
                             if self.first_call_s else None),
            # per-phase wall-clock shares; 'other' = host time outside
            # every timed phase
            "phases": phases,
            "phases_other_s": round(total - sum(
                v for k, v in phases.items() if k.endswith("_s")), 3),
            "launches": {k: f.launches - self.launches0[k]
                         for k, f in learner.KERNELS.items()},
        }
        if self.args.population:
            summary["aggregate_steps_per_s"] = round(
                self.args.population * steps_done / max(total, 1e-9), 1)
            summary["population_selection"] = selection
        if self.writer:
            with open(os.path.join(self.run_dir, "summary.json"), "w") as f:
                json.dump(summary, f, indent=1)
        self.note(f"phase timers: {phases}")
        self.logger.close()
        self.eval_logger.close()
        return summary


def run(args) -> List[Dict[str, float]]:
    """Train; returns the per-iteration metric rows it printed (of every
    stage, polish stages included).  Under a launcher every rank runs it
    (`parallel.mesh.multihost_init`)."""
    if args.population:
        return run_population(args)
    cfg = build_config(args)
    learner.check_ported(cfg, dtype_of(args))
    env_params = DEFAULT_PARAMS
    mesh = mesh_lib.multihost_init(args.device)
    r = _Run(args, cfg, os.path.join(args.out_dir, run_name_of(args, cfg)),
             mesh, learner.env_sharded(cfg, mesh), members=False)
    device, K, dtype = r.device, r.iters_per_call, r.dtype
    call = (learner.make_train_loop(cfg, env_params, K, device, dtype, mesh)
            if K > 1 else one_iteration_a_call(
                learner.make_train_step(cfg, env_params, device,
                                        dtype=dtype, mesh=mesh)))
    state = learner.init_train_state(cfg, env_params, device, dtype=dtype)
    if args.init_params_npz:
        state = state.replace(params=init_params(
            args.init_params_npz, 0, mesh).to(device, dtype))
    state = r.start(state)
    if not r.writer:
        eval_fn = None
    elif args.exact_eval:
        eval_fn = learner.make_exact_eval_fn(
            cfg, env_params, dtype, device=device,
            skip_episodes=r.evals_done * cfg.eval_episodes)
    else:
        eval_fn = learner.make_eval_fn(cfg, env_params, dtype, device=device)

    def make_rows(metrics):
        keys = list(metrics)
        values = torch.stack([metrics[k].to(torch.float64)
                              for k in keys]).tolist()     # one sync
        return [dict(zip(keys, col)) for col in zip(*values)]

    def evaluate(state, gstep):
        # rank 0 evaluates; every rank takes its values and its verdict,
        # so that all of them gather the state for a new best
        em = better = None
        if r.writer:
            with r.timers("eval"):
                em = {k: float(v) for k, v in eval_fn(
                    state.params, eval_generator(cfg.seed, gstep)).items()}
            better = r.ckpt.is_better(em)
        em, better = mesh_lib.broadcast_object((em, better), mesh)
        # best-model tracking rides the eval cadence (EvalCallback)
        if better:
            with r.timers("best_ckpt"):
                whole = r.whole(state)
                if r.writer:
                    r.ckpt.update_best(gstep, learner.state_to_dict(whole),
                                       em)
        return em, dict(em)

    state, rows = r.loop(state, call, make_rows, cfg.batch_size, evaluate)
    r.summary(state)
    return rows


def run_population(args) -> List[Dict]:
    """Population training (JAX train.py's --population path): train, eval
    and archive, re-eval every snapshot, select, then chain the polish
    stages.  Each printed row holds the member means, the best member's
    return and, on eval rows, every member's eval return.  On a mesh whose
    size divides P each rank trains its members; the evals, the snapshot
    archive, the re-eval and the selection are rank 0's, on every
    member's params gathered to it."""
    if args.exact_eval:
        raise ValueError("--exact-eval is a single-policy protocol; evaluate "
                         "the selected member afterwards with "
                         "acas2d_tpu_torch.eval --exact")
    cfg = build_config(args)
    learner.check_ported(cfg, dtype_of(args))
    env_params = DEFAULT_PARAMS
    pop = args.population
    run_name = run_name_of(args, cfg)
    run_dir = os.path.join(args.out_dir, run_name)
    mesh = mesh_lib.multihost_init(args.device)
    r = _Run(args, cfg, run_dir, mesh, population.member_sharded(pop, mesh),
             members=True)
    device, K, dtype = r.device, r.iters_per_call, r.dtype
    call = (population.make_population_loop(cfg, env_params, K, device,
                                            dtype, mesh, pop)
            if K > 1 else one_iteration_a_call(
                population.make_population_step(cfg, env_params, device,
                                                dtype=dtype, mesh=mesh,
                                                pop=pop)))
    state = population.init_population(cfg, env_params, pop, device, dtype)
    if args.init_params_npz:
        state = state.replace(params=init_params(
            args.init_params_npz, pop, mesh).to(device, dtype))
    state = r.start(state)
    eval_fn = tracker = None
    if r.writer:
        eval_fn = population.make_population_eval(cfg, env_params, dtype,
                                                  device=device)
        tracker = population.PopulationTracker(run_dir, pop, cfg.seed)

    def members(x: torch.Tensor) -> torch.Tensor:
        """Every member's rows of x (members on its leading axis)."""
        return mesh_lib.all_gather_rows(x, mesh) if r.sharded else x

    def make_rows(metrics):
        keys = list(metrics)
        values = torch.stack([metrics[k].to(torch.float64) for k in keys])
        values = members(values.permute(2, 0, 1)).permute(1, 2, 0)
        values = values.cpu().numpy()                      # one sync
        returns = values[keys.index("ep_return_mean")]
        return [{**{k: float(v[i].mean()) for k, v in zip(keys, values)},
                 "ep_return_max": float(returns[i].max())}
                for i in range(values.shape[1])]

    def evaluate(state, gstep):
        params = members(state.params)
        if not r.writer:
            return {}, {}
        with r.timers("eval"):
            em = {k: v.to(torch.float64).cpu().numpy()
                  for k, v in eval_fn(params, eval_generator(
                      cfg.seed, gstep)).items()}
        vals = em["eval_return_mean"]
        shown = {k: float(v.mean()) for k, v in em.items()}
        shown.update(eval_return_max=float(vals.max()),
                     eval_best_member=int(vals.argmax()),
                     eval_return_members=[round(float(v), 2) for v in vals])
        with r.timers("best_ckpt"):
            n_up = tracker.update(gstep, vals, params.cpu().numpy())
        if n_up:
            print(f"population: {n_up} member(s) improved; best="
                  f"{tracker.best_vals.max():.2f} (member "
                  f"{tracker.selected})", file=sys.stderr)
        logged = dict(shown, eval_return_members=json.dumps(
            shown["eval_return_members"]))
        return shown, logged

    state, rows = r.loop(state, call, make_rows,
                         population.population_throughput_steps(cfg, pop),
                         evaluate, tracker.flush if r.writer else None)

    selection = None
    if r.writer:
        selection = select(args, cfg, env_params, r, tracker)
    r.summary(state, selection)

    if args.polish_steps > 0:
        if not mesh_lib.broadcast_object(
                r.writer and tracker.snap_params is not None, mesh):
            # no eval fired before total_timesteps: nothing to polish from
            r.note("polish skipped: no selection artifact")
        else:
            rows += run(parse_args(polish_argv(args, run_dir, run_name)))
            if r.writer:
                # the pipeline-level record (the committed-artifact schema)
                population_merge.merge(
                    run_dir, os.path.join(args.out_dir,
                                          f"{run_name}_polish"),
                    [f"stage1_population{pop}"
                     + ("_rollpacked" if cfg.fused_update_packed
                        and cfg.fused_rollout else ""),
                     f"reval{args.reval_episodes}_risk_adjusted",
                     f"polish_population{polish_population(args)}"])
    return rows


def select(args, cfg: PPOConfig, env_params, r: _Run,
           tracker: population.PopulationTracker) -> Dict:
    """The end of a population stage: one large fresh re-eval of every
    archived snapshot, pop x k at once (unless --reval-episodes 0), then
    the tracker's selection; returns its summary."""
    reval_vals = reval_stds = None
    if args.reval_episodes > 0 and tracker.snap_params is not None:
        reval_fn = population.make_population_eval(
            dataclasses.replace(cfg, eval_episodes=args.reval_episodes),
            env_params, r.dtype, device=r.device)
        flat, _ = tracker.snapshots_flat()
        t0 = time.perf_counter()
        with r.timers("final_reval"):
            rm = reval_fn(torch.as_tensor(flat, device=r.device,
                                          dtype=r.dtype),
                          torch.Generator().manual_seed(cfg.seed + 99))
            reval_vals = rm["eval_return_mean"].cpu().numpy()
            reval_stds = rm["eval_return_std"].cpu().numpy()
        print(f"population: re-eval of {flat.shape[0]} snapshots "
              f"({args.population} members x {tracker.k}), "
              f"{args.reval_episodes} episodes each: "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    selection = tracker.finalize(reval_vals,
                                 reval_episodes=args.reval_episodes,
                                 reval_stds=reval_stds)
    sel_val = selection.get("selected_reval",
                            selection["selected_training_eval"])
    print(f"population: selected member {selection['selected_member']} "
          f"(seed {selection['selected_seed']}, by "
          f"{selection['selected_by']}) eval {sel_val:.2f}", file=sys.stderr)
    return selection


def polish_population(args) -> int:
    """The polish stage's members: --polish-pop, else half the
    population."""
    return args.polish_pop or max(args.population // 2, 1)


def polish_argv(args, run_dir: str, run_name: str) -> List[str]:
    """The next polish stage's command line (JAX train.py:712-770): a
    population of --polish-pop members warm-started from this stage's top
    snapshots, seed + 50, --polish-lr, in `<run-name>_polish`."""
    init_art = os.path.join(run_dir, "top_snapshots.npz")
    polish_pop = polish_population(args)
    argv = ["--population", str(polish_pop),
            "--init-params-npz", init_art,
            "--total-steps", str(args.polish_steps),
            "--lr", str(args.polish_lr),
            "--checkpoint-every", str(args.polish_steps),
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
                      ("--dtype", args.dtype),
                      ("--iters-per-call", args.iters_per_call),
                      ("--device", args.device)):
        if val is not None:
            argv += [flag, str(val)]
    for flag, on in (("--anneal-lr", args.anneal_lr),
                     ("--fused-rollout", args.fused_rollout),
                     ("--fused-update", args.fused_update),
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
    args = parse_args(argv)
    run(args)
    # the ranks of a launch end together: none leaves the group while
    # rank 0 still selects or writes
    mesh_lib.sync(mesh_lib.make_mesh(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
