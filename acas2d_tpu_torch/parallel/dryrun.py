"""The training paths of several ranks, run on a mesh and written out for a
check against one process: the port's counterpart of JAX
`__graft_entry__.py:dryrun_multichip`.

    python -m torch.distributed.run --nproc-per-node W \\
        -m acas2d_tpu_torch.parallel.dryrun --out DIR

Every rank runs each variant of `VARIANTS` at its shape (`variant_config`)
for `--iters` (a population's `--pop-iters`) eager PPO iterations of the
step on the mesh: the env batch
split over the ranks (solo) or the members (population).  For each variant
rank 0 writes `DIR/<variant>.pt`: the whole state after the iterations,
gathered, as a checkpoint dict (`learner.state_to_dict`), every
iteration's metrics (the population's members gathered), and every rank's
kernel launches in those iterations.  Each rank of a variant with the fused
rollout also writes `DIR/<variant>_chunk<rank>.pt`: the buffers of its
first rollout chunk of the first iteration, from the seed the step folds
(`parallel.mesh.fold_seed`), which a check holds against one launch of the
kernel on that rank's rows.  Nothing is compared here.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, Tuple

import torch

from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.parallel import mesh as mesh_lib
from acas2d_tpu_torch.ppo import learner, population
from acas2d_tpu_torch.ppo.config import PPOConfig, tpu_default

# name: (fused rollout, fused update, population)
VARIANTS = {"xla": (False, False, False),
            "fused_rollout": (True, False, False),
            "fused_update": (False, True, False),
            "population": (False, False, True),
            "population_fused": (True, True, True)}


def variant_config(name: str, world: int, envs_per_rank: int, n_steps: int,
                   minibatch: int, n_epochs: int, chunk: int, pop: int,
                   pop_envs: int, pop_minibatch: int = 0
                   ) -> Tuple[PPOConfig, int]:
    """The config of a variant on `world` ranks and its population (0:
    solo): the `tpu` preset with n_envs = world * envs_per_rank (solo) or
    `pop_envs` a member, the given steps, minibatch (a population's
    `pop_minibatch`, by default the same), epochs and fused chunk, and the
    variant's paths."""
    fused_rollout, fused_update, members = VARIANTS[name]
    n_envs = pop_envs if members else world * envs_per_rank
    cfg = dataclasses.replace(
        tpu_default(), n_envs=n_envs, n_steps=n_steps,
        minibatch_size=(pop_minibatch or minibatch) if members else minibatch,
        n_epochs=n_epochs, fused_chunk=chunk,
        total_timesteps=n_envs * n_steps, fused_rollout=fused_rollout,
        fused_update=fused_update)
    return cfg, (pop if members else 0)


def init_state(cfg: PPOConfig, pop: int, device, dtype=torch.float32):
    """The whole initial state of a variant, as every rank builds it."""
    if pop:
        return population.init_population(cfg, DEFAULT_PARAMS, pop, device,
                                          dtype)
    return learner.init_train_state(cfg, DEFAULT_PARAMS, device, dtype=dtype)


def make_step(cfg: PPOConfig, pop: int, device, mesh=None,
              dtype=torch.float32):
    """The eager step of a variant, on `mesh` when given."""
    if pop:
        return population.make_population_step(cfg, DEFAULT_PARAMS, device,
                                               dtype=dtype, mesh=mesh,
                                               pop=pop)
    return learner.make_train_step(cfg, DEFAULT_PARAMS, device, dtype=dtype,
                                   mesh=mesh)


def first_chunk(cfg: PPOConfig, pop: int, state, mesh: mesh_lib.Mesh,
                split: bool) -> Dict[str, torch.Tensor]:
    """The buffers of this rank's first rollout chunk of the next
    iteration of `state` (its share when `split`), from the seed the step
    would take (drawn from copies of the generators), folded as the step
    folds it."""
    if not split:
        mesh = mesh_lib.Mesh(0, 1, None, mesh.device)
    gens = []
    for g in state.generators:
        gens.append(torch.Generator())
        gens[-1].set_state(g.get_state())
    probe = (state.replace(generators=gens) if pop
             else state.replace(generator=gens[0]))
    seed_gens = population.seed_generators(cfg, pop, mesh) if pop else (0,)
    seeds = learner.iteration_inputs(cfg, probe, 1, mesh.device,
                                     seed_gens=seed_gens)[0][0]
    seed = mesh_lib.fold_seed(seeds[mesh.rank if pop else 0:][:1], mesh)
    mesh = mesh if mesh.distributed else None
    one = dataclasses.replace(cfg, n_steps=cfg.fused_chunk)
    if pop:
        batch = learner.rollout_members_fused(
            state.params, state.env_state, state.obs, one, DEFAULT_PARAMS,
            seed)[2]
    else:
        _, batch, _, _ = learner.collect_rollout_fused(
            state, one, DEFAULT_PARAMS, seed, mesh)
    out = {f.name: getattr(batch, f.name).cpu()
           for f in dataclasses.fields(batch)}
    out["seed"] = int(seed.reshape(-1)[0])
    return out


def run_variant(name: str, args, mesh: mesh_lib.Mesh) -> None:
    cfg, pop = variant_config(name, mesh.size, args.envs_per_rank,
                              args.n_steps, args.minibatch, args.epochs,
                              args.chunk, args.pop, args.pop_envs,
                              args.pop_minibatch)
    dtype = getattr(torch, args.dtype)
    split = (population.member_sharded(pop, mesh) if pop
             else learner.env_sharded(cfg, mesh))
    state = init_state(cfg, pop, mesh.device, dtype)
    if split:
        state = learner.shard_state(state, mesh, members=bool(pop))
    elif mesh.rank == 0:
        print(f"{name}: the shape does not split over {mesh.size} ranks: "
              f"every rank runs the whole step", file=sys.stderr)
    if cfg.fused_rollout:
        torch.save(first_chunk(cfg, pop, state, mesh, split),
                   os.path.join(args.out, f"{name}_chunk{mesh.rank}.pt"))
    step = make_step(cfg, pop, mesh.device, mesh, dtype)
    kernels = list(learner.KERNELS.values())
    before = [k.launches for k in kernels]
    rows = []
    for _ in range(args.pop_iters if pop and args.pop_iters else args.iters):
        state, metrics = step(state)
        if pop and split:
            metrics = {k: mesh_lib.all_gather_rows(v, mesh)
                       for k, v in metrics.items()}
        rows.append({k: v.cpu() for k, v in metrics.items()})
    launches = torch.tensor([[k.launches - n for k, n in zip(kernels,
                                                             before)]],
                            device=mesh_lib.comm_device(mesh))
    launches = mesh_lib.all_gather_rows(launches, mesh).cpu()
    whole = (learner.gather_state(state, mesh, members=bool(pop)) if split
             else state)
    if mesh.rank == 0:
        torch.save({"state": learner.state_to_dict(whole), "metrics": rows,
                    "launches": launches, "world": mesh.size,
                    "sharded": split},
                   os.path.join(args.out, f"{name}.pt"))
    print(f"dryrun {name}: rank {mesh.rank} of {mesh.size} ok", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:LOCAL_RANK)")
    ap.add_argument("--backend", default=None,
                    help="the process group's (default nccl on a card, "
                         "gloo on the CPU)")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--pop-iters", type=int, default=0,
                    help="iterations of the population variants (default "
                         "--iters)")
    ap.add_argument("--envs-per-rank", type=int, default=1024)
    ap.add_argument("--n-steps", type=int, default=128)
    ap.add_argument("--minibatch", type=int, default=65536)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--pop", type=int, default=32)
    ap.add_argument("--pop-envs", type=int, default=1024)
    ap.add_argument("--pop-minibatch", type=int, default=32768)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    mesh = mesh_lib.multihost_init(args.device, args.backend)
    if mesh.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    for name in args.variants.split(","):
        run_variant(name, args, mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
