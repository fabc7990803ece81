"""Population training: P independent PPO runs side by side in one process.

Counterpart of `acas2d_tpu/ppo/population.py` on its four paths
(`fused_rollout`, `fused_update` / `fused_update_packed`).  ACAS-2D PPO
at the flagship shape is a seed lottery, so the shipped pipeline
(`scripts/population_pipeline.sh`) trains 32 member policies at once and
keeps the best by a risk-adjusted re-evaluation (`PopulationTracker`).

Every leaf of a `PopulationState` has a leading (P,) member axis.  Member i
starts exactly like a solo run with seed cfg.seed + i
(`learner.init_train_state`), so any member's start is reproducible on its
own.  Each member keeps its own `torch.Generator`; the population's rollout
seed is drawn from member 0's, as the JAX package draws it from member 0's
key.  Where JAX `vmap`s the train step over members, the port writes the
member axis out:

  * every rollout chunk of the whole population is ONE launch of the
    member-grid rollout kernel (`learner.rollout_members_fused`);
    unfused, every step of the whole population is one step of the
    batch-native env core over P * B envs, each member's policy on its
    own (`learner.rollout_members`);
  * GAE runs once over the flattened (T, P * B) batch, which is exact
    because GAE is per env;
  * every minibatch step of the whole population is ONE launch of the
    member-batched gradient kernel (`learner.ppo_update_members`), or
    unfused one autograd backward of the sum of the members' losses,
    which gives each member its own gradient.

As the JAX package shards members over several chips
(`population.py:269-273`), a launch of several processes splits the
members over its ranks (`member_sharded`), with no collective in a step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.config import EnvParams
from acas2d_tpu_torch.envs import vector
from acas2d_tpu_torch.ops.policy_rollout import fused_policy_rollout_members
from acas2d_tpu_torch.parallel.mesh import Mesh, env_rows, fold_seed
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.ppo.config import PPOConfig
from acas2d_tpu_torch.ppo.gae import compute_gae
from acas2d_tpu_torch.types import EnvState
from acas2d_tpu_torch.utils.params_io import (STACK_KEY, _flatten,
                                              flat_to_tree, load_params_npz,
                                              save_params_npz, tree_to_flat)


@dataclasses.dataclass
class PopulationState:
    params: torch.Tensor                # (P, N_PARAMS) flat
    opt_state: learner.AdamState        # (P, N_PARAMS) moments
    env_state: EnvState                 # (P, B)-batched leaves
    obs: torch.Tensor                   # (P, B, O)
    generators: List[torch.Generator]   # one per member
    iteration: int = 0                  # completed PPO iterations

    def replace(self, **changes) -> "PopulationState":
        return dataclasses.replace(self, **changes)


def init_population(cfg: PPOConfig, env_params: EnvParams, pop: int,
                    device=None, dtype=torch.float32) -> PopulationState:
    """Member i's params, Adam state, env batch and generator equal a solo
    `learner.init_train_state(seed=cfg.seed + i, dtype=dtype)`."""
    dev = resolve_device(device)
    solo = [learner.init_train_state(cfg, env_params, dev, seed=cfg.seed + i,
                                     dtype=dtype)
            for i in range(pop)]
    env_state = EnvState(**{
        f.name: torch.stack([getattr(s.env_state, f.name) for s in solo])
        for f in dataclasses.fields(EnvState)})
    params = torch.stack([s.params for s in solo])
    return PopulationState(
        params=params, opt_state=learner.Optimizer(cfg).init(params),
        env_state=env_state, obs=torch.stack([s.obs for s in solo]),
        generators=[s.generator for s in solo])


def member_sharded(pop: int, mesh: Optional[Mesh]) -> bool:
    """Whether a population splits its members over the mesh's ranks (JAX
    train.py:388-391): on a mesh of a process group whose size divides P.
    Otherwise every rank trains every member, with the same bits (the
    driver says so)."""
    return mesh is not None and mesh.distributed and pop % mesh.size == 0


def seed_generators(cfg: PPOConfig, pop: int,
                    mesh: Optional[Mesh]) -> Tuple[int, ...]:
    """The members whose generators give an iteration's rollout seeds:
    member 0's alone, but for a fused rollout of members split over W
    ranks, each rank's first member's (JAX population.py:157-164, where
    each shard takes its first member's key).  Every rank holds every
    member's generator and draws every seed, so that the generators stay
    the same on every rank."""
    if cfg.fused_rollout and member_sharded(pop, mesh):
        return tuple(range(0, pop, pop // mesh.size))
    return (0,)


def _population_iteration(cfg: PPOConfig, env_params: EnvParams,
                          dtype=torch.float32,
                          mesh: Optional[Mesh] = None) -> Callable:
    """iteration(state, seed, perms, scalars, mark, draws=None) -> (state,
    metrics): one PPO iteration of every member on its inputs
    (`learner.iteration_inputs`' rows), drawing nothing from the
    generators; the unfused rollout's draws come from the seed, as the
    fused rollout's do, unless `draws` are given.

    With a `mesh` (`member_sharded`), the state's params, Adam moments,
    envs and obs are this rank's members (`parallel.mesh.shard_env_state`
    along the member axis) and its generators are every member's; the
    step runs no collective.  The fused rollout takes this rank's seed
    (`seed_generators`) plus rank * 7919; the unfused one draws the single
    process's rows of its members, so that it is the single process's step
    bit for bit.  Each member's permutations come from its own generator."""
    optimizer = learner.Optimizer(cfg)
    if mesh is not None and not mesh.distributed:
        mesh = None

    def iteration(state: PopulationState, seed, perms, scalars, mark,
                  draws: Optional[learner.RolloutDraws] = None):
        learner.check_state(cfg, state, dtype, draws)
        mark("start")
        P, B = state.obs.shape[:2]
        first = 0
        if mesh is not None:
            first = env_rows(len(state.generators), mesh).start
            perms = perms[:, first:first + P]
        if cfg.fused_rollout:
            if mesh is not None:
                seed = fold_seed(seed[mesh.rank:mesh.rank + 1], mesh)
            env_state, obs, batch, last_values, env_metrics = (
                learner.rollout_members_fused(
                    state.params, state.env_state, state.obs, cfg,
                    env_params, seed, kernel=fused_policy_rollout_members))
        else:
            if draws is None:
                draws = learner.rollout_draws(
                    seed, cfg.n_steps, (P, B), env_params, dtype,
                    state.obs.device, first * B)
            env_state, obs, batch, last_values, env_metrics = (
                learner.rollout_members(state.params, state.env_state,
                                        state.obs, cfg, env_params, draws))
        state = state.replace(env_state=env_state, obs=obs,
                              iteration=state.iteration + 1)
        mark("rollout")
        T = batch.values.shape[0]
        advantages, returns = compute_gae(
            batch.rewards.view(T, P * B), batch.values.view(T, P * B),
            batch.dones.view(T, P * B), last_values.reshape(P * B),
            cfg.gamma, cfg.gae_lambda)
        advantages = advantages.view(T, P, B)
        returns = returns.view(T, P, B)
        mark("gae")
        data = learner.pack_batch(batch, advantages, returns, dtype)
        data = data.transpose(0, 1).reshape(P, T * B, data.shape[-1])
        params, opt_state, opt_metrics = learner.ppo_update_members(
            state.params, state.opt_state, optimizer, data, cfg, perms,
            scalars)
        mark("update")
        explained_var = 1.0 - (
            torch.var(learner.per_member(returns - batch.values), -1,
                      correction=0)
            / (torch.var(learner.per_member(returns), -1, correction=0)
               + 1e-8))
        state = state.replace(params=params, opt_state=opt_state)
        metrics = {**env_metrics, **opt_metrics,
                   "explained_variance": explained_var}
        return state, metrics

    return iteration


def make_population_step(cfg: PPOConfig, env_params: EnvParams, device=None,
                         on_phase: Optional[Callable[[str], None]] = None,
                         dtype=torch.float32,
                         mesh: Optional[Mesh] = None,
                         pop: Optional[int] = None) -> Callable:
    """Returns step(state, seed=None, perms=None, draws=None) -> (state,
    metrics): one PPO iteration of every member (rollout, GAE, epochs of
    member-batched gradient steps with Adam, on the paths cfg chooses) of
    a `dtype` state, run eagerly.  Metrics are (P,) tensors.  `seed`
    replaces the rollout seed drawn from member 0's generator, `perms[e]`
    ((P, N / block) indices) replaces epoch e's permutations drawn from
    each member's generator, and `draws` (of batch shape (P, B)) the
    unfused rollout's draws: the parity tests pass the draws the JAX step
    derives from its keys.  `on_phase(name)` is called as each phase ends
    ("rollout", "gae", "update").  With a `mesh` on which the `pop`
    members are `member_sharded`, the step trains this rank's members,
    whose metrics it returns (P / W,)."""
    dev = resolve_device(device)
    learner.check_ported(cfg, dtype)
    learner._check_matmuls(cfg, dev)
    mesh = mesh if pop is not None and member_sharded(pop, mesh) else None
    return learner.eager_step(
        _population_iteration(cfg, env_params, dtype, mesh), cfg, dev,
        on_phase, seed_generators(cfg, pop or 1, mesh))


def make_population_loop(cfg: PPOConfig, env_params: EnvParams,
                         iters_per_call: int, device=None,
                         dtype=torch.float32,
                         mesh: Optional[Mesh] = None,
                         pop: Optional[int] = None) -> Callable:
    """Returns loop(state) -> (state, metrics): `iters_per_call`
    iterations of every member a call, metrics (K, P) (JAX
    `population.make_population_loop`).  On the CPU, and under gloo, K
    calls of `make_population_step`'s step; on the card, replays of one
    captured iteration (`learner.ReplayedLoop`): the seed still comes
    from member 0's generator (or each rank's first member's) and each
    member's permutations from its own."""
    dev = resolve_device(device)
    learner.check_ported(cfg, dtype)
    learner._check_matmuls(cfg, dev)
    if not learner.replays(dev, mesh):
        return learner.stacked_loop(
            make_population_step(cfg, env_params, dev, dtype=dtype,
                                 mesh=mesh, pop=pop),
            iters_per_call)
    mesh = mesh if pop is not None and member_sharded(pop, mesh) else None
    return learner.ReplayedLoop(
        _population_iteration(cfg, env_params, dtype, mesh), cfg,
        iters_per_call, seed_generators(cfg, pop or 1, mesh))


def make_population_eval(cfg: PPOConfig, env_params: EnvParams,
                         dtype=torch.float32, device=None) -> Callable:
    """Greedy eval of every member: eval_all(params (P, N_PARAMS),
    generator) -> metrics (P,).  The P members play P * cfg.eval_episodes
    fresh spawns drawn from `generator`, member m on its own
    cfg.eval_episodes of them (the JAX package folds the member index into
    the key), with a batched per-member MLP (`learner.GreedyEval`: replayed
    CUDA graphs on the card)."""
    dev = resolve_device(device)
    n = cfg.eval_episodes
    greedy = learner.GreedyEval(members=True, device=dev)

    def eval_all(params: torch.Tensor, generator: torch.Generator):
        P = params.shape[0]
        return greedy.evaluate(
            params, lambda: vector.reset_batch(P * n, env_params, generator,
                                               dtype, dev), env_params,
            lambda ep: learner.eval_metrics({k: v.view(P, n)
                                             for k, v in ep.items()}))

    return eval_all


def member_params(params: torch.Tensor, i: int) -> torch.Tensor:
    """Member i's (N_PARAMS,) flat parameter vector."""
    return params[i]


def population_throughput_steps(cfg: PPOConfig, pop: int) -> int:
    """Env-steps advanced per population iteration (all members)."""
    return pop * cfg.batch_size


class PopulationTracker:
    """Per-member snapshot archive and end-of-run selection: a numpy-only
    copy of the JAX `PopulationTracker` (`population.py:318-589`).

    Each member keeps its `k` highest in-training greedy evals (value, step,
    params snapshot): the in-training argmax chases eval noise, and a
    member's true peak usually hides among its top few.  The archive is
    (pop, k, N_PARAMS) flat vectors, written to
    `<run>/population_best.npz` (throttled to one write per
    `save_interval_s`) in the JAX schema, and read back when the run dir
    already holds one.  `finalize` selects across all pop x k snapshots,
    by a fresh large re-eval of each when given (risk-adjusted by its std),
    and writes `selected_best.npz`, `top_snapshots.npz` and
    `population.json`, which the JAX `eval.py` and
    `scripts/best_selection.py` read unchanged.

    Deliberate divergence from the JAX tracker: a non-finite re-eval score
    (NaN) is masked to -inf, where JAX's argmax and ranking would take it as
    the largest and select that snapshot.  The legacy single-snapshot
    archive format (`__best_vals__`), which the port never wrote, is not
    read.
    """

    def __init__(self, run_dir: str, pop: int, seed: int, k: int = 6,
                 save_interval_s: float = 2.0):
        self.run_dir = run_dir
        self.pop = pop
        self.seed = seed
        self.k = k
        self.snap_vals = np.full((pop, k), -np.inf)
        self.snap_steps = np.zeros((pop, k), dtype=np.int64)
        self.snap_params: Optional[np.ndarray] = None   # (pop, k, N_PARAMS)
        self.final_vals = np.full(pop, np.nan)
        self._path = os.path.join(run_dir, "population_best.npz")
        self._save_interval_s = save_interval_s
        self._last_save = float("-inf")
        self._dirty = False
        if os.path.exists(self._path):
            self._load()

    # -- views ------------------------------------------------------------
    @property
    def best_vals(self) -> np.ndarray:
        """Per-member best in-training eval, (pop,)."""
        return self.snap_vals.max(axis=1)

    @property
    def best_steps(self) -> np.ndarray:
        """Step of each member's best in-training eval, (pop,)."""
        return np.take_along_axis(
            self.snap_steps, self.snap_vals.argmax(1)[:, None], 1)[:, 0]

    # -- persistence ------------------------------------------------------
    def _load(self):
        tree = load_params_npz(self._path)
        vals = tree.pop("__snap_vals__", None)
        steps = tree.pop("__snap_steps__", None)
        if vals is None or vals.shape != (self.pop, self.k):
            return             # another format, or population shape changed
        self.snap_vals = vals.copy()
        self.snap_steps = steps.copy()
        self.snap_params = tree_to_flat(tree, n_lead=2).numpy()

    def _save(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_save < self._save_interval_s:
            self._dirty = True
            return
        np.savez(self._path, __snap_vals__=self.snap_vals,
                 __snap_steps__=self.snap_steps,
                 **_flatten(flat_to_tree(self.snap_params)))
        self._last_save = now
        self._dirty = False

    def flush(self):
        """Force-persist a throttled pending save (call before exit)."""
        if self._dirty and self.snap_params is not None:
            self._save(force=True)

    # -- updates ----------------------------------------------------------
    def update(self, gstep: int, eval_vals, params_host) -> int:
        """Record one population eval: `eval_vals` (pop,) member returns,
        `params_host` the (pop, N_PARAMS) params at that step.  Member i's
        snapshot enters its archive when it beats the member's current
        k-th best.  Returns the number of members updated."""
        eval_vals = np.asarray(eval_vals)
        self.final_vals = eval_vals.copy()
        slot_min = self.snap_vals.argmin(axis=1)           # (pop,)
        min_vals = np.take_along_axis(
            self.snap_vals, slot_min[:, None], 1)[:, 0]
        improved = np.flatnonzero(eval_vals > min_vals)
        if improved.size == 0:
            return 0
        params_host = np.asarray(params_host, dtype=np.float32)
        if self.snap_params is None:
            # only the claimed slots carry real values; the rest stay -inf
            self.snap_params = np.repeat(params_host[:, None], self.k, axis=1)
        for i in improved:
            j = int(slot_min[i])
            self.snap_vals[i, j] = eval_vals[i]
            self.snap_steps[i, j] = gstep
            self.snap_params[i, j] = params_host[i]
        self._save()
        return int(improved.size)

    def snapshots_flat(self) -> Tuple[np.ndarray, np.ndarray]:
        """All pop*k snapshot params (pop * k, N_PARAMS), member-major, and
        the matching (pop * k,) values."""
        assert self.snap_params is not None
        return (self.snap_params.reshape(self.pop * self.k, -1),
                self.snap_vals.reshape(-1))

    # -- selection --------------------------------------------------------
    @property
    def selected(self) -> int:
        return int(np.argmax(self.best_vals))

    def finalize(self, reval_vals=None, reval_episodes: int = 0,
                 reval_stds=None) -> dict:
        """Write selected_best.npz + top_snapshots.npz + population.json;
        returns the summary.

        `reval_vals`, when given, are fresh large-sample greedy evals of
        every archived snapshot, (pop, k) or flat member-major, and drive
        the selection instead of the noisy in-training values.
        `reval_stds` (same shape; per-episode return std of the re-eval)
        makes it risk-adjusted: score = mean - 2 * std / sqrt(100), since
        the strict protocol is a fixed 100-episode set.  Unclaimed (-inf)
        slots and non-finite scores are never selected."""
        self.flush()
        score_vals = None
        if reval_vals is not None:
            reval_vals = np.asarray(reval_vals, dtype=float).reshape(
                self.pop, self.k)
            score_vals = reval_vals
            if reval_stds is not None:
                stds = np.asarray(reval_stds, dtype=float).reshape(
                    self.pop, self.k)
                score_vals = reval_vals - 2.0 * stds / np.sqrt(100.0)
            score_vals = np.where(
                np.isfinite(self.snap_vals) & np.isfinite(score_vals),
                score_vals, -np.inf)
            i, j = np.unravel_index(int(np.argmax(score_vals)),
                                    score_vals.shape)
            i, j = int(i), int(j)
        else:
            i = self.selected
            j = int(self.snap_vals[i].argmax())

        def rounded(vals):
            return [round(float(v), 2) if np.isfinite(v) else None
                    for v in vals]

        summary = {
            "population": self.pop,
            "snapshots_per_member": self.k,
            "master_seed": self.seed,
            "member_seeds": [self.seed + m for m in range(self.pop)],
            "selected_member": i,
            "selected_seed": self.seed + i,
            "selected_by": ("final_reval" if reval_vals is not None
                            else "best_training_eval"),
            "selected_training_eval": float(self.snap_vals[i, j]),
            "selected_at_step": int(self.snap_steps[i, j]),
            "best_evals": rounded(self.best_vals),
            "best_at_steps": [int(s) for s in self.best_steps],
            "final_evals": rounded(self.final_vals),
            "members_over_1200": int((self.best_vals >= 1200.0).sum()),
        }
        if reval_vals is not None:
            member_best_reval = np.where(np.isfinite(reval_vals), reval_vals,
                                         -np.inf).max(axis=1)
            summary["reval_episodes"] = int(reval_episodes)
            summary["reval_evals"] = rounded(member_best_reval)
            summary["selected_reval"] = float(reval_vals[i, j])
            summary["members_over_1200_reval"] = int(
                (member_best_reval >= 1200.0).sum())
            if reval_stds is not None:
                summary["risk_adjusted_selection"] = True
                summary["selected_reval_std"] = float(stds[i, j])
                summary["selected_score"] = float(score_vals[i, j])
        if self.snap_params is not None:
            save_params_npz(os.path.join(self.run_dir, "selected_best.npz"),
                            flat_to_tree(self.snap_params[i, j]))
            # the top-N snapshots of the whole archive, ranked by the
            # selection's score, as one stacked artifact: a polish stage
            # warm-starts its members round-robin from these lineages
            rank_vals = (score_vals if score_vals is not None
                         else self.snap_vals)
            flat_rank = np.asarray(rank_vals).reshape(-1)
            claimed = np.isfinite(self.snap_vals.reshape(-1))
            order = np.argsort(np.where(claimed, flat_rank, -np.inf))[::-1]
            n_top = int(min(3, claimed.sum()))
            if n_top > 0:
                tops = [np.unravel_index(int(t), self.snap_vals.shape)
                        for t in order[:n_top]]
                stacked = flat_to_tree(
                    np.stack([self.snap_params[a, b] for a, b in tops]))
                stacked[STACK_KEY] = np.asarray(n_top)
                save_params_npz(
                    os.path.join(self.run_dir, "top_snapshots.npz"), stacked)
                summary["top_snapshots"] = [
                    {"member": int(a), "slot": int(b),
                     "rank_value": round(float(rank_vals[a, b]), 2)}
                    for a, b in tops]
        with open(os.path.join(self.run_dir, "population.json"), "w") as f:
            json.dump(summary, f, indent=1)
        return summary
