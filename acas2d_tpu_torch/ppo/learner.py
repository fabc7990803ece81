"""PPO learner: rollout collection, GAE, clipped-PPO epochs with Adam, and
greedy evaluation.

Counterpart of `acas2d_tpu/ppo/learner.py` on all four of its paths, as
`PPOConfig.fused_rollout` and `fused_update` choose them:

  * the fused rollout is n_steps/K launches of the policy-in-kernel rollout
    (ops/policy_rollout.py); the unfused one (`collect_rollout`, JAX's
    default) steps the batch-native env core n_steps times, with the
    policy, the Gaussian sample and the respawns as tensor code, in the
    state's dtype (float32 or float64);
  * the fused update takes every minibatch gradient in one launch of the
    fused PPO-gradient kernel (ops/ppo_grads.py, `fused_update_packed`
    and `fused_update_bf16` included); the unfused one differentiates
    `ppo_loss` with autograd (JAX's `jax.grad`).

Both rollouts (`rollout_members`, `rollout_members_fused`), the update
(`ppo_update_members`) and the optimizer work on a leading member axis,
which is 1 for solo training (`collect_rollout`, `collect_rollout_fused`,
`ppo_update`) and P for a population (ppo/population.py).
Optimisation semantics replicate SB3 PPO as the JAX package does: raw
gaussian samples keep their log-probs while the env receives clipped
actions; advantages are normalised per minibatch (every minibatch of an
epoch at once, `ppo_update_members`); value loss is unclipped
MSE; global-norm clipping at max_grad_norm, then Adam — both written out to
reproduce optax's `clip_by_global_norm` and `adam` step for step.

Parameters and Adam moments are flat (N_PARAMS,) vectors in the kernels'
layout (models/actor_critic.py), so a grad step hands the kernel its
operand without packing: the JAX package's packed-parameter update
(`fused_update_packed`, which keeps the TPU kernel's block-diagonal
operands and masks their off-diagonal gradients) is therefore the same
update as the fused one here.  Randomness comes from the TrainState's explicit
`torch.Generator`: one rollout seed per iteration and one block permutation
per epoch.  The unfused rollout's action noise and respawn uniforms come
from that seed through the kernels' counter-based hash, made on the
state's device at the iteration's start (`rollout_draws`), so an iteration
draws no more from the generator on either rollout path.  A caller may
pass the draws (`seed=`, `perms=`, and for the unfused rollout `draws=`)
to replay another run's: the parity tests pass the draws the JAX learner
derives from its key.  JAX's unfused rollout draws from threefry, so the
two agree by distribution, not bit for bit.

`make_train_loop` runs K iterations a call (JAX `make_train_loop`, train.py
--iters-per-call): on the card as K replays of one iteration captured as a
CUDA graph, whose draws and Adam scalars the host makes before the replays
and the graph reads from device memory; on the CPU as K eager steps.
Either equals K eager steps bit for bit.

On a mesh of several processes (`parallel/mesh.py`, JAX's `mesh=`
branches), a solo step splits its env batch over the ranks and averages
their gradients at every minibatch step (`_solo_iteration`,
`minibatch_grads_fn`); `shard_state` and `gather_state` move a training
state between its whole and a rank's share.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.config import EnvParams
from acas2d_tpu_torch.envs import core, vector
from acas2d_tpu_torch.models.actor_critic import (
    ActorCritic, apply_flat, flatten, gaussian_entropy, gaussian_log_prob,
    members_forward, members_log_std, sample_action)
from acas2d_tpu_torch.oracle import MersenneSpawner
from acas2d_tpu_torch.ops import phase_mark, policy_rollout, ppo_grads
from acas2d_tpu_torch.ops import step_math as sm
from acas2d_tpu_torch.ops.policy_rollout import (
    fused_policy_rollout, fused_policy_rollout_members, seed_int32)
from acas2d_tpu_torch.ops.ppo_grads import (normalize_adv_minibatches,
                                            ppo_minibatch_grads_members)
from acas2d_tpu_torch.parallel import mesh as mesh_lib
from acas2d_tpu_torch.parallel.mesh import (Mesh, all_gather_rows,
                                            all_reduce_mean, all_reduce_sum,
                                            backend_of, env_rows, fold_seed,
                                            gather_env_state, shard_env_state)
from acas2d_tpu_torch.ppo.config import PPOConfig
from acas2d_tpu_torch.ppo.gae import compute_gae
from acas2d_tpu_torch.types import EnvState
from acas2d_tpu_torch.utils import profiling

INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class RolloutBatch:
    """Time-major rollout buffer, leaves (T, B, ...)."""
    obs: torch.Tensor
    actions: torch.Tensor      # raw (unclipped) samples, (T, B, 1)
    log_probs: torch.Tensor
    values: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor        # bool


@dataclasses.dataclass
class AdamState:
    """optax ScaleByAdamState on flat vectors."""
    mu: torch.Tensor
    nu: torch.Tensor
    count: int = 0


@dataclasses.dataclass
class TrainState:
    params: torch.Tensor        # (N_PARAMS,) flat float32
    opt_state: AdamState
    env_state: EnvState         # (B,)-batched
    obs: torch.Tensor           # (B, O)
    generator: torch.Generator  # rollout seeds and epoch permutations
    iteration: int = 0          # completed PPO iterations

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    @property
    def generators(self) -> List[torch.Generator]:
        """The generator as a list, as a `PopulationState` holds one per
        member."""
        return [self.generator]


# ---------------------------------------------------------------- optimizer

class Optimizer:
    """optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, eps)) on a
    flat parameter vector, with optax's arithmetic: updates are scaled by
    max_norm / g_norm only when g_norm >= max_norm (no epsilon), Adam's
    denominator is sqrt(nu_hat) + eps, bias corrections are computed in
    float64 and rounded to the params' dtype (as optax under x64 casts
    them to each moment's dtype), and the optional linear LR anneal is
    optax.linear_schedule(lr, 0, total_updates) on the pre-step count.

    A step's scalars (both bias corrections and the negated step size) come
    as a tensor of the params' dtype on the gradients' device
    (`scalars`), so that a
    CUDA graph's replay takes each step's own, and the moments are divided
    by them as tensors: a true division, as optax's `mu / (1 - b1**count)`
    (PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which can differ by an ulp)."""

    def __init__(self, cfg: PPOConfig, b1: float = 0.9, b2: float = 0.999):
        self.max_norm = cfg.max_grad_norm
        self.lr = cfg.learning_rate
        self.eps = cfg.adam_eps
        self.b1, self.b2 = b1, b2
        self.total_updates = (cfg.n_iterations * cfg.n_epochs
                              * cfg.n_minibatches if cfg.anneal_lr else 0)

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(mu=torch.zeros_like(params),
                         nu=torch.zeros_like(params), count=0)

    def step_size(self, count: int) -> float:
        if not self.total_updates:
            return self.lr
        frac = 1.0 - min(max(count, 0), self.total_updates) / self.total_updates
        return self.lr * frac

    def scalars(self, count: int, n: int,
                dtype=torch.float32) -> torch.Tensor:
        """The scalars of the n steps from Adam count `count` on, (n, 3) on
        the CPU: each step's bias corrections 1 - b1**c and 1 - b2**c (c
        its post-step count) and its negated step size, in float64,
        rounded to `dtype` (the params')."""
        return torch.tensor(
            [(1 - self.b1 ** (c + 1), 1 - self.b2 ** (c + 1),
              -self.step_size(c)) for c in range(count, count + n)],
            dtype=torch.float64).view(n, 3).to(dtype)

    def update(self, grads: torch.Tensor, state: AdamState,
               scalars: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, AdamState]:
        """One step on (..., N_PARAMS) gradients; each row (a population's
        member) is clipped by its own global norm.  `scalars`: this step's
        row of `scalars(state.count, ...)` on the gradients' device (by
        default made here)."""
        if scalars is None:
            scalars = self.scalars(state.count, 1,
                                   grads.dtype)[0].to(grads.device)
        g_norm = torch.sqrt(torch.sum(grads * grads, dim=-1, keepdim=True))
        grads = torch.where(g_norm < self.max_norm, grads,
                            (grads / g_norm) * self.max_norm)
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * grads + b1 * state.mu
        nu = (1 - b2) * (grads * grads) + b2 * state.nu
        mu_hat = mu / scalars[0]
        nu_hat = nu / scalars[1]
        updates = scalars[2] * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return updates, AdamState(mu=mu, nu=nu, count=state.count + 1)


def init_train_state(cfg: PPOConfig, env_params: EnvParams, device=None,
                     seed: Optional[int] = None,
                     dtype=torch.float32) -> TrainState:
    """Fresh policy (SB3 init), Adam state and env batch, all drawn from one
    generator seeded with `seed` (default cfg.seed), in `dtype`: a float64
    state starts from the float32 run's policy and spawns, widened."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    params = flatten(ActorCritic(generator=gen)).to(dev, dtype)
    env_state, obs = vector.reset_batch(cfg.n_envs, env_params, gen,
                                        dtype, dev)
    return TrainState(params=params, opt_state=Optimizer(cfg).init(params),
                      env_state=env_state, obs=obs, generator=gen)


# ---------------------------------------------------------------- checkpoints

def state_to_dict(state) -> Dict:
    """A `TrainState` or a `population.PopulationState` as a checkpoint:
    a plain dict of CPU tensors, ints and strings, so that
    `torch.load(weights_only=True)` reads it.  It holds everything that
    makes a resumed run continue bit for bit: params, the Adam moments and
    count, every `EnvState` field and obs, the completed iteration, the
    state of each generator, and the sizes that fix the tensors' shapes."""
    return {
        "kind": "population" if state.params.dim() == 2 else "solo",
        "shapes": _state_shapes(state),
        "iteration": int(state.iteration),
        "params": state.params.detach().cpu(),
        "adam": {"mu": state.opt_state.mu.cpu(),
                 "nu": state.opt_state.nu.cpu(),
                 "count": int(state.opt_state.count)},
        "env_state": {f.name: getattr(state.env_state, f.name).cpu()
                      for f in dataclasses.fields(EnvState)},
        "obs": state.obs.cpu(),
        "generators": [g.get_state() for g in state.generators],
    }


def state_from_dict(raw: Dict, target):
    """The state of checkpoint `raw` on the device of `target`, a fresh
    state of the same kind and config, as JAX restores into a target.
    Refuses a checkpoint whose kind, sizes or tensor shapes differ from
    the target's."""
    want = _state_shapes(target)
    kind = "population" if want["population"] else "solo"
    if raw["kind"] != kind:
        raise ValueError(f"checkpoint holds a {raw['kind']} state, the run "
                         f"is {kind}")
    bad = {k: (raw["shapes"].get(k), v) for k, v in want.items()
           if raw["shapes"].get(k) != v}
    if bad:
        raise ValueError("checkpoint shapes differ from the config's "
                         "(checkpoint, config): " + ", ".join(
                             f"{k} {a} vs {b}" for k, (a, b) in bad.items()))
    dev = target.params.device

    def load(t, like):
        if t.shape != like.shape or t.dtype != like.dtype:
            raise ValueError(f"checkpoint tensor {tuple(t.shape)} {t.dtype} "
                             f"vs {tuple(like.shape)} {like.dtype}")
        return t.to(dev)

    gens = [torch.Generator() for _ in raw["generators"]]
    for g, s in zip(gens, raw["generators"]):
        g.set_state(s)
    return target.replace(
        params=load(raw["params"], target.params),
        opt_state=AdamState(mu=load(raw["adam"]["mu"], target.opt_state.mu),
                            nu=load(raw["adam"]["nu"], target.opt_state.nu),
                            count=int(raw["adam"]["count"])),
        env_state=EnvState(**{
            f.name: load(raw["env_state"][f.name],
                         getattr(target.env_state, f.name))
            for f in dataclasses.fields(EnvState)}),
        obs=load(raw["obs"], target.obs),
        iteration=int(raw["iteration"]),
        **({"generator": gens[0]} if isinstance(target, TrainState)
           else {"generators": gens}))


def shard_state(state, mesh: Mesh, members: bool = False):
    """This rank's share of a whole training state (`TrainState` or
    `population.PopulationState`), as every rank builds it from the seed:
    its rows of the env batch and obs, and with `members` (a population
    split by member) its members' params and Adam moments too.  Generators
    and the rest stay whole (`parallel.mesh.shard_env_state`)."""
    return _map_split(state, members, lambda t: shard_env_state(t, mesh))


def gather_state(state, mesh: Mesh, members: bool = False):
    """The whole training state from the ranks' shares (`shard_state`'s
    inverse), on every rank, in the single process's layout."""
    return _map_split(state, members, lambda t: gather_env_state(t, mesh))


def _map_split(state, members: bool, fn):
    """`state` with `fn` applied to what a mesh splits."""
    out = state.replace(env_state=fn(state.env_state), obs=fn(state.obs))
    if members:
        out = out.replace(
            params=fn(state.params), opt_state=dataclasses.replace(
                state.opt_state, mu=fn(state.opt_state.mu),
                nu=fn(state.opt_state.nu)))
    return out


def _state_shapes(state) -> Dict[str, int]:
    """The sizes that fix a state's tensor shapes (0 members = solo)."""
    return {"population": (state.params.shape[0]
                           if state.params.dim() == 2 else 0),
            "n_envs": state.obs.shape[-2], "obs_dim": state.obs.shape[-1],
            "n_params": state.params.shape[-1],
            "max_traffic": state.env_state.tx.shape[-1]}


# ---------------------------------------------------------------- rollout

EPISODE_KEYS = ("episodes", "ep_return_mean", "ep_length_mean", "goal_rate",
                "collision_rate", "timeout_rate")


def per_member(x: torch.Tensor) -> torch.Tensor:
    """A (T, P, B) rollout field as (P, T * B), each member's row
    contiguous: a reduction over its last axis sums every member's values
    in the same order whatever P is (a reduction over axes (0, 2) of the
    (T, P, B) tensor need not), so that a rank's members reduce as the
    single process's do."""
    return x.transpose(0, 1).reshape(x.shape[1], -1)


def episode_sums(dones: torch.Tensor, episode_return: torch.Tensor,
                 episode_steps: torch.Tensor, outcome: torch.Tensor,
                 dtype) -> torch.Tensor:
    """The sums behind JAX's six episode metrics of each member, from
    (T, P, B) fields: episodes ended, their returns and lengths, and their
    goals, collisions and timeouts, stacked as a (6, P) tensor of
    `dtype`."""
    def total(x):
        return per_member(x).sum(-1).to(dtype)
    return torch.stack([total(dones), total(episode_return),
                        total(episode_steps), total(outcome == 1),
                        total(outcome == 2), total(outcome == 3)])


def episode_metrics(sums: torch.Tensor, mesh: Optional[Mesh] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX's episode metrics from `episode_sums`: every sum over the
    episodes ended, at least 1.  With a `mesh` the sums are first added
    over its ranks (one collective)."""
    if mesh is not None:
        sums = all_reduce_sum(sums, mesh)
    n_ep = torch.clamp(sums[0], min=1.0)
    return {"episodes": sums[0],
            **{k: v / n_ep for k, v in zip(EPISODE_KEYS[1:], sums[1:])}}


# The unfused rollout's draws: the counter-based hash of the kernels
# (ops/step_math.py) with salts of their own.  Box-Muller takes salts 4 and
# 5, the policy rollout kernel's, so that in float32 the action noise of a
# seed is the fused rollout's; the respawn uniforms take SPAWN_SALT on.
NOISE_SALTS = (4, 5)
SPAWN_SALT = 8
LOW_BITS_SALT = 64     # float64: the salt offset of a uniform's low 29 bits


@dataclasses.dataclass
class RolloutDraws:
    """The random draws of an unfused rollout of T steps over envs of batch
    shape S ((B,) solo, (P, B) for members)."""
    noise: torch.Tensor   # (T, *S) standard normal action noise
    spawn: torch.Tensor   # (T, *S, core.spawn_width) respawn uniforms


def rollout_draws(seed, n_steps: int, shape: Sequence[int],
                  env_params: EnvParams, dtype=torch.float32,
                  device=None, first_env: int = 0) -> RolloutDraws:
    """Every draw of an unfused rollout of `n_steps` steps over envs of
    batch `shape`, made on `device` at once from `seed` (an int, or a (1,)
    int32 tensor there, as the fused rollout takes it): env e of the
    flattened batch, step t and salt k hash to
    `step_math.hash32(rng_base(seed, first_env + e), t, k)`.  A rank of a
    mesh passes its first env's index in the whole batch, so that its
    draws are those rows of the single process's.  A float32 uniform is a
    hash's top 24 bits (the kernels' `_u01_hash`); a float64 one adds 29
    bits of a second hash (salt + LOW_BITS_SALT).  The noise is the
    kernels' Box-Muller of salts NOISE_SALTS; each step's respawns take
    `core.spawn_width` uniforms from SPAWN_SALT on."""
    dev = resolve_device(device)
    n = math.prod(shape)
    base = sm.rng_base(seed, torch.arange(first_env, first_env + n,
                                          device=dev))
    steps = torch.arange(n_steps, device=dev)[:, None]

    def uniform(salt):
        top = sm.hash32(base, steps, salt) >> 8
        if dtype == torch.float64:
            low = sm.hash32(base, steps, salt + LOW_BITS_SALT) >> 3
            return (top * (1 << 29) + low).to(torch.float64) * 2.0 ** -53
        return top.to(torch.float32) * sm.f32(1.0 / (1 << 24))

    u1, u2 = (uniform(k) for k in NOISE_SALTS)
    noise = (torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - u1, min=1e-12)))
             * torch.cos(sm.TWO_PI * u2))
    spawn = torch.stack([uniform(SPAWN_SALT + j) for j in
                         range(core.spawn_width(env_params))], dim=-1)
    return RolloutDraws(noise=noise.view(n_steps, *shape),
                        spawn=spawn.view(n_steps, *shape, -1))


def _envs_view(es: EnvState, lead: int, shape: Sequence[int]) -> EnvState:
    """`es` with its `lead` leading (batch) axes reshaped to `shape`."""
    return EnvState(**{f.name: getattr(es, f.name).reshape(
        tuple(shape) + getattr(es, f.name).shape[lead:])
        for f in dataclasses.fields(EnvState)})


def _envs_rows(es: EnvState, rows: slice) -> EnvState:
    """The envs `rows` of a flat (N,)-batched `es`, as views."""
    return EnvState(**{f.name: getattr(es, f.name)[rows]
                       for f in dataclasses.fields(EnvState)})


@torch.no_grad()
def rollout_members(params: torch.Tensor, env_state: EnvState,
                    obs: torch.Tensor, cfg: PPOConfig,
                    env_params: EnvParams, draws: RolloutDraws,
                    mesh: Optional[Mesh] = None
                    ) -> Tuple[EnvState, torch.Tensor, RolloutBatch,
                               torch.Tensor, Dict[str, torch.Tensor]]:
    """cfg.n_steps autoreset steps of P member policies, member m's on its
    own B envs (JAX `collect_rollout`'s scan body, vmapped over members by
    the JAX population): each step the policy forward (`members_forward`),
    the raw Gaussian sample from `draws.noise` and its log-prob, the action
    clipped to [-1, 1], and `vector.step_autoreset_batch` over all P * B
    envs, the respawns reset beforehand from `draws.spawn` for every step
    at once.  Everything runs in the params' dtype.

    params (P, N_PARAMS); env_state leaves and obs (P, B, ...); draws of
    batch shape (P, B).  Returns (env_state', obs', batch with (T, P, B,
    ...) leaves, last values (P, B), JAX's six episode metrics (P,)); with
    a `mesh` (the envs a rank's rows), the metrics are the whole batch's."""
    P, B = obs.shape[:2]
    T, PB, dtype = cfg.n_steps, P * B, params.dtype
    noise = draws.noise.reshape(T, P, B).to(dtype)
    fresh, fresh_obs = core.observe(core.spawn_from_uniforms(
        draws.spawn.reshape(T * PB, -1), env_params, dtype), env_params)
    es = _envs_view(env_state, 2, (PB,))
    log_std = members_log_std(params)[:, None]                # (P, 1)
    bufs: Dict[str, List[torch.Tensor]] = {}
    for t in range(T):
        mean, value = members_forward(params, obs)            # (P, B)
        action = sample_action(mean, log_std, noise[t])
        logp = gaussian_log_prob(action[..., None], mean[..., None],
                                 log_std[..., None])
        rows = slice(t * PB, (t + 1) * PB)
        es, out = vector.step_autoreset_batch(
            es, torch.clamp(action, -1.0, 1.0).reshape(PB), env_params,
            fresh=(_envs_rows(fresh, rows), fresh_obs[rows]))
        step = {"obs": obs, "actions": action, "log_probs": logp,
                "values": value}
        step.update({k: getattr(out, k).view(P, B) for k in (
            "reward", "done", "episode_return", "episode_steps",
            "outcome")})
        for k, v in step.items():
            bufs.setdefault(k, []).append(v)
        obs = out.obs.view(P, B, -1)
    b = {k: torch.stack(v) for k, v in bufs.items()}
    batch = RolloutBatch(obs=b["obs"], actions=b["actions"][..., None],
                         log_probs=b["log_probs"], values=b["values"],
                         rewards=b["reward"], dones=b["done"])
    last_values = members_forward(params, obs)[1]
    metrics = episode_metrics(episode_sums(
        b["done"], b["episode_return"], b["episode_steps"], b["outcome"],
        dtype), mesh)
    return _envs_view(es, 1, (P, B)), obs, batch, last_values, metrics


@torch.no_grad()
def rollout_members_fused(params: torch.Tensor, env_state: EnvState,
                          obs: torch.Tensor, cfg: PPOConfig,
                          env_params: EnvParams, seed,
                          mesh: Optional[Mesh] = None,
                          kernel: Callable = fused_policy_rollout_members
                          ) -> Tuple[EnvState, torch.Tensor, RolloutBatch,
                                     torch.Tensor, Dict[str, torch.Tensor]]:
    """`rollout_members` as cfg.n_steps / fused_chunk launches of the
    member-grid policy rollout, one seed for all chunks and members (an
    int or a (1,) int32 tensor on the state's device) and the step counter
    offset by chunk.  Shapes and returns as `rollout_members`'; with a
    `mesh` the caller folds the rank into the seed
    (`parallel.mesh.fold_seed`).

    `kernel` launches one chunk, with `fused_policy_rollout_members`'
    arguments and returns.  The training iterations pass it by the name
    their module imports (`learner.fused_policy_rollout` for one policy,
    `population.fused_policy_rollout_members` for a population), which is
    where `benchmark/tests/test_bench_faults.py` alters a rollout's
    rewards to show that the benchmark's check catches it."""
    K = cfg.fused_chunk
    if cfg.n_steps % K:
        raise ValueError(f"n_steps {cfg.n_steps} not divisible by "
                         f"fused_chunk {K}")
    es = env_state
    flat = dict(px=es.px, py=es.py, psi=es.ppsi, tx=es.tx[..., 0],
                ty=es.ty[..., 0], tv=es.tv[..., 0], tpsi=es.tpsi[..., 0],
                steps=es.steps, total_reward=es.total_reward)
    chunks = []
    for idx in range(cfg.n_steps // K):
        flat, buf = kernel(flat, obs, params, seed, idx * K, K, env_params)
        obs = flat.pop("obs")
        pa_lat = flat.pop("pa_lat")
        chunks.append(buf)
    bufs = {k: torch.cat([b[k] for b in chunks]) for k in chunks[0]}
    batch = RolloutBatch(
        obs=bufs["obs"], actions=bufs["actions"][..., None],
        log_probs=bufs["log_probs"], values=bufs["values"],
        rewards=bufs["rewards"], dones=bufs["dones"] > 0)
    last_values = members_forward(params, obs)[1]
    es = es.replace(
        px=flat["px"], py=flat["py"], ppsi=flat["psi"], pa_lat=pa_lat,
        tx=flat["tx"][..., None], ty=flat["ty"][..., None],
        tv=flat["tv"][..., None], tpsi=flat["tpsi"][..., None],
        steps=flat["steps"], total_reward=flat["total_reward"],
        outcome=torch.zeros_like(es.outcome))
    metrics = episode_metrics(episode_sums(
        bufs["dones"], bufs["episode_return"], bufs["episode_steps"],
        bufs["outcome"], torch.float32), mesh)
    return es, obs, batch, last_values, metrics


def _one_policy_chunk(flat: Dict[str, torch.Tensor], obs: torch.Tensor,
                      params: torch.Tensor, *args
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Dict[str, torch.Tensor]]:
    """`rollout_members_fused`'s `kernel` for a one-member grid: the chunk
    through the one-policy entry `fused_policy_rollout` (itself the P = 1
    call of `fused_policy_rollout_members`), its returns as the grid's."""
    final, buf = fused_policy_rollout({k: v[0] for k, v in flat.items()},
                                      obs[0], params[0], *args)
    return ({k: v[None] for k, v in final.items()},
            {k: v[:, None] for k, v in buf.items()})


def _one_member(rollout: Callable, state: TrainState, *args
                ) -> Tuple[TrainState, RolloutBatch, torch.Tensor,
                           Dict[str, torch.Tensor]]:
    """The solo `state`'s rollout as the P = 1 call of `rollout`
    (`rollout_members` or `rollout_members_fused`, taking `args` after the
    params, envs and obs).  Returns (state', batch with (T, B, ...)
    leaves, last_value (B,), metrics)."""
    B = state.obs.shape[0]
    es, obs, batch, last_values, metrics = rollout(
        state.params[None], _envs_view(state.env_state, 1, (1, B)),
        state.obs[None], *args)
    batch = RolloutBatch(**{f.name: getattr(batch, f.name)[:, 0]
                            for f in dataclasses.fields(RolloutBatch)})
    new_state = state.replace(env_state=_envs_view(es, 2, (B,)), obs=obs[0],
                              iteration=state.iteration + 1)
    return (new_state, batch, last_values[0],
            {k: v[0] for k, v in metrics.items()})


def collect_rollout_fused(state: TrainState, cfg: PPOConfig,
                          env_params: EnvParams, seed,
                          mesh: Optional[Mesh] = None
                          ) -> Tuple[TrainState, RolloutBatch, torch.Tensor,
                                     Dict[str, torch.Tensor]]:
    """The fused rollout of one policy (JAX `collect_rollout_fused`): the
    P = 1 call of `rollout_members_fused`.  Returns (state', batch with
    (T, B, ...) leaves, last_value (B,), metrics).  With a `mesh`, the
    state is this rank's rows of the env batch and the metrics are the
    whole batch's: the episode sums are added over the ranks before they
    are divided."""
    return _one_member(rollout_members_fused, state, cfg, env_params, seed,
                       mesh, _one_policy_chunk)


def collect_rollout(state: TrainState, cfg: PPOConfig,
                    env_params: EnvParams, draws: RolloutDraws,
                    mesh: Optional[Mesh] = None
                    ) -> Tuple[TrainState, RolloutBatch, torch.Tensor,
                               Dict[str, torch.Tensor]]:
    """The unfused rollout of one policy (JAX `collect_rollout`): the P = 1
    call of `rollout_members`, draws of batch shape (B,).  Returns and
    `mesh` as `collect_rollout_fused`'s."""
    return _one_member(
        rollout_members, state, cfg, env_params,
        RolloutDraws(noise=draws.noise[:, None], spawn=draws.spawn[:, None]),
        mesh)


# ------------------------------------------------------------------- loss

def ppo_loss(params: torch.Tensor, data: torch.Tensor, cfg: PPOConfig
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The clipped-PPO loss of JAX `learner.ppo_loss`, as differentiable
    tensor code, for P members at once: params (P, N_PARAMS), data (P, n,
    13), each member's minibatch packed as `ppo_update_members` packs it
    (obs 8, raw action, old log-prob, old value, advantage, return).
    Returns (loss (P,), aux {policy_loss, value_loss, entropy, approx_kl,
    clip_fraction}, each (P,)).  Advantages are normalised per member by
    the population std (JAX's `std`, ddof 0); the log-ratio is clamped to
    +-20 nats."""
    obs, actions, old_logp = data[..., :8], data[..., 8], data[..., 9]
    advantages, returns = data[..., 11], data[..., 12]
    mean, value = members_forward(params, obs)                # (P, n)
    log_std = members_log_std(params)[:, None]                # (P, 1)
    logp = gaussian_log_prob(actions[..., None], mean[..., None],
                             log_std[..., None])
    ratio = torch.exp(torch.clamp(logp - old_logp, -20.0, 20.0))
    if cfg.normalize_advantage:
        advantages = ((advantages - advantages.mean(-1, keepdim=True))
                      / (advantages.std(-1, correction=0, keepdim=True)
                         + 1e-8))
    unclipped = advantages * ratio
    clipped = advantages * torch.clamp(ratio, 1 - cfg.clip_range,
                                       1 + cfg.clip_range)
    policy_loss = -torch.minimum(unclipped, clipped).mean(-1)
    value_loss = ((returns - value) ** 2).mean(-1)
    entropy = gaussian_entropy(log_std)                       # (P,)
    loss = (policy_loss + cfg.ent_coef * (-entropy)
            + cfg.vf_coef * value_loss)
    aux = {
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy,
        "approx_kl": ((ratio - 1) - torch.log(ratio)).mean(-1),
        "clip_fraction": ((ratio - 1).abs() > cfg.clip_range
                          ).to(torch.float32).mean(-1),     # JAX's float32
    }
    return loss, aux


def ppo_loss_grads(params: torch.Tensor, data: torch.Tensor,
                   cfg: PPOConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Each member's gradient of `ppo_loss` by autograd (JAX's `jax.grad`
    branch of `ppo_update`): params (P, N_PARAMS), data (P, n, 13) ->
    (grads (P, N_PARAMS), aux (P,) with 'loss').  One backward of the sum
    of the members' losses gives every member's own gradient, since
    members share nothing."""
    with torch.enable_grad():
        p = params.detach().requires_grad_(True)
        loss, aux = ppo_loss(p, data, cfg)
        grads, = torch.autograd.grad(loss.sum(), p)
    aux = {k: v.detach() for k, v in aux.items()}
    aux["loss"] = loss.detach()
    return grads, aux


# ----------------------------------------------------------------- update

def as_perms(perms, members: int, n_blocks: int) -> torch.Tensor:
    """Epoch permutations as one (E, P, n_blocks) int64 tensor: `perms` is
    one already, or a sequence of per-epoch (P, n_blocks) or (n_blocks,)
    arrays."""
    if torch.is_tensor(perms):
        return perms.reshape(-1, members, n_blocks)
    return torch.stack([torch.tensor(np.asarray(p), dtype=torch.int64)
                        .reshape(members, n_blocks) for p in perms])


def draw_perms(cfg: PPOConfig, generators: Sequence[torch.Generator],
               n_blocks: int) -> torch.Tensor:
    """Each epoch's block permutation of every member from that member's
    generator, epoch by epoch: (E, P, n_blocks) int64 on the CPU."""
    return torch.stack([torch.stack([torch.randperm(n_blocks, generator=g)
                                     for g in generators])
                        for _ in range(cfg.n_epochs)])


def minibatch_grads_fn(cfg: PPOConfig, mesh: Optional[Mesh] = None
                       ) -> Callable:
    """The gradients of an already-normalised minibatch: the step
    normalises no advantage, whatever cfg.normalize_advantage says, since
    its caller (`ppo_update_members`) has normalised the whole epoch.

    grads(params (P, N_PARAMS), mb (P, M, 13)) -> (grads (P, N_PARAMS),
    aux {k: (P,)}): a minibatch step's gradients, from the fused kernel
    under cfg.fused_update, else by autograd (`ppo_loss_grads`).

    With a `mesh` of a process group (JAX `make_fused_grads_fn(cfg, mesh)`
    and the XLA update it stands beside), every rank holds the whole
    minibatch and computes the gradients of its rows [r M / W, (r + 1) M /
    W); their mean over the ranks, of the gradients and the loss
    statistics in one flat buffer, is the whole minibatch's (JAX's
    `pmean`).  Refuses the fused update when a rank's rows are not a
    multiple of 128, as JAX does."""
    plain = dataclasses.replace(cfg, normalize_advantage=False)

    def local(params, mb):
        if cfg.fused_update:
            return ppo_minibatch_grads_members(
                params, mb, clip_range=cfg.clip_range, vf_coef=cfg.vf_coef,
                ent_coef=cfg.ent_coef, normalize_advantage=False,
                bf16=cfg.fused_update_bf16)
        return ppo_loss_grads(params, mb, plain)

    if mesh is None or not mesh.distributed:
        return local
    W, M = mesh.size, cfg.minibatch_size
    if M % W or (cfg.fused_update and (M // W) % 128):
        raise ValueError(
            f"fused_update needs (minibatch_size / n_devices) % 128 == 0, "
            f"got minibatch {M} over {W} devices" if cfg.fused_update else
            f"the sharded update splits every minibatch evenly over the "
            f"ranks: minibatch {M} over {W} devices")
    rows = env_rows(M, mesh)

    def sharded(params, mb):
        grads, aux = local(params, mb[:, rows])
        keys = list(aux)
        flat = all_reduce_mean(torch.cat(
            [grads.reshape(-1)] + [aux[k].to(grads.dtype) for k in keys]),
            mesh)
        P = grads.shape[0]
        out = flat[grads.numel():].view(len(keys), P)
        return (flat[:grads.numel()].view_as(grads),
                {k: out[i].to(aux[k].dtype) for i, k in enumerate(keys)})

    return sharded


def ppo_update_members(params: torch.Tensor, opt_state: AdamState,
                       optimizer: Optimizer, data: torch.Tensor,
                       cfg: PPOConfig, perms,
                       scalars: Optional[torch.Tensor] = None,
                       grads_fn: Optional[Callable] = None
                       ) -> Tuple[torch.Tensor, AdamState,
                                  Dict[str, torch.Tensor]]:
    """n_epochs x n_minibatches of clipped-PPO Adam steps (SB3 PPO.train)
    for P members at once, each on its own (N, 13) packed batch, in the
    params' dtype.

    `params` and the Adam moments are (P, N_PARAMS); `data` (P, N, 13).
    Each epoch permutes every member's contiguous blocks of
    cfg.shuffle_block rows (block 1 is SB3's row shuffle) by `perms`
    (`as_perms`: (E, P, N / block) indices; `draw_perms` draws them from
    the members' generators).  `scalars`, the steps' (E * M, 3) Adam
    scalars (`Optimizer.scalars`) on the data's device, is by default made
    from the Adam count.  Under cfg.fused_update every minibatch step of
    all members is one launch of the gradient kernel, with bf16 operands
    under cfg.fused_update_bf16; else its gradients come from autograd
    (`ppo_loss_grads`).  `grads_fn` (`minibatch_grads_fn`, by default that
    of one process) takes the steps' gradients.  Metrics are (P,) means
    over the steps.

    The update alone normalises the advantages (SB3's per minibatch, under
    cfg.normalize_advantage): each epoch gathers its private copy
    minibatch-major, (n_minibatches, P, M, 13), so that every step's
    (P, M, 13) slice is contiguous, and `normalize_adv_minibatches`
    normalises every minibatch of every member in place, once an epoch,
    before its steps; on a mesh every rank holds the whole gathered
    batch, so each minibatch is still normalised whole."""
    P, N = data.shape[:2]
    block = cfg.shuffle_block
    n_blocks = N // block
    perms = as_perms(perms, P, n_blocks).to(data.device)
    if scalars is None:
        scalars = optimizer.scalars(
            opt_state.count, cfg.n_epochs * cfg.n_minibatches,
            params.dtype).to(data.device)
    if grads_fn is None:
        grads_fn = minibatch_grads_fn(cfg)
    n_mb = cfg.n_minibatches
    blocks = data.view(P, n_blocks, block, data.shape[-1])
    members = torch.arange(P, device=data.device)[:, None]
    aux_all: Dict[str, List[torch.Tensor]] = {}
    for epoch in range(cfg.n_epochs):
        # a contiguous index lays the gathered copy out in its order
        order = perms[epoch].view(P, n_mb, n_blocks // n_mb).transpose(
            0, 1).contiguous()
        mbs = blocks[members, order].view(
            n_mb, P, cfg.minibatch_size, data.shape[-1])
        if cfg.normalize_advantage:
            normalize_adv_minibatches(mbs)
        for j in range(n_mb):
            grads, aux = grads_fn(params, mbs[j])
            updates, opt_state = optimizer.update(
                grads, opt_state, scalars[epoch * n_mb + j])
            params = params + updates
            for k, v in aux.items():
                aux_all.setdefault(k, []).append(v)
    metrics = {k: torch.stack(v, -1).mean(-1) for k, v in aux_all.items()}
    return params, opt_state, metrics


def pack_batch(batch: RolloutBatch, advantages: torch.Tensor,
               returns: torch.Tensor, dtype) -> torch.Tensor:
    """The six minibatch fields of a (T, *S) rollout folded into one
    (T, *S, 13) matrix of `dtype`: obs 8, raw action, old log-prob, old
    value, advantage, return (the fused kernel's packed layout)."""
    fields = (batch.obs, batch.actions, batch.log_probs, batch.values,
              advantages, returns)
    lead = tuple(batch.values.shape)
    return torch.cat([x.reshape(lead + (-1,)).to(dtype) for x in fields],
                     dim=-1)


def gather_batch(data: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' packed (T, B / W, 13) rollouts as the whole batch's
    (T, B, 13), envs in the single process's order (one collective)."""
    return all_gather_rows(data.transpose(0, 1), mesh).transpose(
        0, 1).contiguous()


def _update_one(params: torch.Tensor, opt_state: AdamState,
                optimizer: Optimizer, data: torch.Tensor, cfg: PPOConfig,
                perms, scalars: Optional[torch.Tensor],
                grads_fn: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, AdamState, Dict[str, torch.Tensor]]:
    """`ppo_update_members` of one policy on its (N, 13) batch."""
    one = AdamState(mu=opt_state.mu[None], nu=opt_state.nu[None],
                    count=opt_state.count)
    params, one, metrics = ppo_update_members(
        params[None], one, optimizer, data[None], cfg, perms, scalars,
        grads_fn)
    return (params[0], AdamState(mu=one.mu[0], nu=one.nu[0], count=one.count),
            {k: v[0] for k, v in metrics.items()})


def ppo_update(params: torch.Tensor, opt_state: AdamState,
               optimizer: Optimizer, batch: RolloutBatch,
               advantages: torch.Tensor, returns: torch.Tensor,
               cfg: PPOConfig, perms, scalars: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, AdamState, Dict[str, torch.Tensor]]:
    """The solo update: `ppo_update_members` for one policy.

    The six minibatch fields are folded into one (N, 13) matrix
    (`pack_batch`); `perms` are the epochs' E x N / block indices
    (`as_perms`), `scalars` as in `ppo_update_members`."""
    data = pack_batch(batch, advantages, returns, params.dtype)
    return _update_one(params, opt_state, optimizer,
                       data.view(cfg.batch_size, -1), cfg, perms, scalars)


# ------------------------------------------------------------- train step

def check_ported(cfg: PPOConfig, dtype=torch.float32) -> None:
    """Refuse what the port does not run.  The training steps (solo and
    population) and the driver call it first.  `update_remat` is an XLA
    schedule of the same gradients, not ported; float64 runs only on the
    unfused paths, since both kernels compute in float32 (where JAX would
    cast a float64 state to float32 in its kernels)."""
    if cfg.update_remat:
        raise NotImplementedError("not ported: update_remat=True")
    if dtype != torch.float32 and (cfg.fused_rollout or cfg.fused_update):
        raise ValueError(
            f"{dtype} training runs the unfused rollout and update only: "
            f"the fused kernels compute in float32 (fused_rollout="
            f"{cfg.fused_rollout}, fused_update={cfg.fused_update})")


def _check_matmuls(cfg: PPOConfig, dev: torch.device) -> None:
    """The unfused paths' float32 products are PyTorch's matmuls, which
    JAX's XLA path computes in float32: refuse TF32 for them on the card,
    rather than round them to 10 bits of mantissa."""
    unfused = not (cfg.fused_rollout and cfg.fused_update)
    if (unfused and dev.type == "cuda"
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "the unfused rollout and update compute float32 products in "
            "float32: set torch.backends.cuda.matmul.allow_tf32 = False")


def iteration_inputs(cfg: PPOConfig, state, n_iters: int, device,
                     seed: Optional[int] = None, perms=None,
                     seed_gens: Sequence[int] = (0,)
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the next `n_iters` PPO iterations of `state` (a `TrainState`
    or a `population.PopulationState`) take besides the state: the random
    draws, in the order an eager step makes them (each iteration's
    rollout seed from each generator of `seed_gens`, by default the first
    alone, then each epoch's block permutation of every member from its
    own generator), and the Adam steps' scalars from the state's Adam
    count on.  Returns (seeds (n, len(seed_gens)) int32, perms (n, E, P,
    N / block) int64, scalars (n, E * M, 3) in the params' dtype), copied
    to `device` at once.  `seed` and `perms` (a sequence of per-epoch
    arrays, see `as_perms`) replace one iteration's draws: the parity
    tests pass the JAX step's."""
    gens = state.generators
    n_blocks = cfg.batch_size // cfg.shuffle_block
    seeds, all_perms = [], []
    for _ in range(n_iters):
        seeds.append([seed_int32(
            seed if seed is not None else
            int(torch.randint(0, INT32_MAX, (), generator=gens[i])))
            for i in seed_gens])
        all_perms.append(as_perms(perms, len(gens), n_blocks)
                         if perms is not None
                         else draw_perms(cfg, gens, n_blocks))
    n_steps = cfg.n_epochs * cfg.n_minibatches
    scalars = Optimizer(cfg).scalars(state.opt_state.count, n_iters * n_steps,
                                     state.params.dtype)
    return (torch.tensor(seeds, dtype=torch.int32).view(n_iters, -1)
            .to(device), torch.stack(all_perms).to(device),
            scalars.view(n_iters, n_steps, 3).to(device))


# an iteration's phases, in order: mark("start") as it starts, then
# mark(phase) as each ends
PHASES = ("rollout", "gae", "update")


def phase_marks(dev: torch.device,
                on_phase: Optional[Callable[[str], None]] = None
                ) -> Callable[[str], None]:
    """mark(name) for an iteration on `dev`: "start" as it starts, then
    each of PHASES as it ends.  On the card it launches the boundary's
    marker kernel in the current stream (`ops/phase_mark.py`), which a
    captured iteration carries into every replay; on the CPU it ends the
    host span of the phase that is open and opens the next phase's,
    `iteration.<phase>`, while a profiler records (`utils/profiling`).
    `on_phase(phase)` is called as each phase ends.  No mark changes a
    tensor."""
    if dev.type == "cuda":
        def mark(name: str) -> None:
            phase_mark.mark(name, dev)
            if on_phase is not None and name != "start":
                on_phase(name)

        return mark
    phase = None                # the open phase's span

    def mark(name: str) -> None:
        nonlocal phase
        if phase is not None:
            phase.__exit__(None, None, None)
            phase = None
        if on_phase is not None and name != "start":
            on_phase(name)
        nxt = 0 if name == "start" else PHASES.index(name) + 1
        if nxt < len(PHASES):
            phase = profiling.span(f"iteration.{PHASES[nxt]}").__enter__()

    return mark


def env_sharded(cfg: PPOConfig, mesh: Optional[Mesh]) -> bool:
    """Whether a solo run splits its env batch over the mesh's ranks (JAX
    train.py:392-398): on a mesh of a process group whose size divides
    n_envs.  Otherwise every rank runs the whole step, with the same bits
    (the driver says so)."""
    return (mesh is not None and mesh.distributed
            and cfg.n_envs % mesh.size == 0)


def _solo_iteration(cfg: PPOConfig, env_params: EnvParams,
                    dev: torch.device, dtype=torch.float32,
                    mesh: Optional[Mesh] = None) -> Callable:
    """iteration(state, seed, perms, scalars, mark, draws=None) -> (state,
    metrics): one solo PPO iteration on its inputs (`iteration_inputs`'
    rows), drawing nothing from the generator.  The unfused rollout makes
    its draws from the seed (`rollout_draws`) unless `draws` are given.

    With a `mesh` (`env_sharded`), the state's env batch and obs are this
    rank's rows (`parallel.mesh.shard_env_state`), and the params, Adam
    state and generator are the same on every rank.  The fused rollout
    takes the seed plus rank * 7919 (`fold_seed`, JAX learner.py:190-193);
    the unfused one draws the single process's rows (`rollout_draws`'
    `first_env`).  GAE stays with each env; the packed batch is gathered
    once into the single process's order, and every minibatch step
    averages the ranks' gradients of their rows (`minibatch_grads_fn`).
    Explained variance is taken on the gathered batch, and the episode
    metrics from sums over the ranks."""
    optimizer = Optimizer(cfg)
    if mesh is not None and not mesh.distributed:
        mesh = None
    grads_fn = minibatch_grads_fn(cfg, mesh)
    first = env_rows(cfg.n_envs, mesh).start if mesh is not None else 0

    def iteration(state: TrainState, seed, perms, scalars, mark,
                  draws: Optional[RolloutDraws] = None):
        check_state(cfg, state, dtype, draws)
        mark("start")
        if cfg.fused_rollout:
            state, batch, last_value, env_metrics = collect_rollout_fused(
                state, cfg, env_params,
                seed if mesh is None else fold_seed(seed, mesh), mesh)
        else:
            if draws is None:
                draws = rollout_draws(seed, cfg.n_steps,
                                      (state.obs.shape[0],), env_params,
                                      dtype, dev, first)
            state, batch, last_value, env_metrics = collect_rollout(
                state, cfg, env_params, draws, mesh)
        mark("rollout")
        advantages, returns = compute_gae(
            batch.rewards, batch.values, batch.dones, last_value,
            cfg.gamma, cfg.gae_lambda)
        mark("gae")
        data = pack_batch(batch, advantages, returns, state.params.dtype)
        values = batch.values
        if mesh is not None:
            data = gather_batch(data, mesh)
            values = data[..., ppo_grads._VAL].contiguous()
            returns = data[..., ppo_grads._RET].contiguous()
        params, opt_state, opt_metrics = _update_one(
            state.params, state.opt_state, optimizer,
            data.view(cfg.batch_size, -1), cfg, perms, scalars, grads_fn)
        mark("update")
        explained_var = 1.0 - (
            torch.var(returns - values, correction=0)
            / (torch.var(returns, correction=0) + 1e-8))
        state = state.replace(params=params, opt_state=opt_state)
        metrics = {**env_metrics, **opt_metrics,
                   "explained_variance": explained_var}
        return state, metrics

    return iteration


def check_state(cfg: PPOConfig, state, dtype, draws) -> None:
    """Refuse a state of another dtype than the step was built for, and
    draws given to the fused rollout, which takes only its seed."""
    if state.params.dtype != dtype:
        raise ValueError(f"a step built for {dtype} got a "
                         f"{state.params.dtype} state")
    if draws is not None and cfg.fused_rollout:
        raise ValueError("the fused rollout takes its seed, not draws")


def eager_step(iteration: Callable, cfg: PPOConfig, dev: torch.device,
               on_phase: Optional[Callable[[str], None]] = None,
               seed_gens: Sequence[int] = (0,)) -> Callable:
    """step(state, seed=None, perms=None, draws=None) -> (state, metrics):
    `iteration` on the state's next draws (`iteration_inputs`, the seeds
    from the generators `seed_gens`; `draws`, an unfused rollout's
    `RolloutDraws`, replace those made from the seed), run eagerly, its
    phases marked (`phase_marks`)."""
    mark = phase_marks(dev, on_phase)

    def step(state, seed: Optional[int] = None, perms=None,
             draws: Optional[RolloutDraws] = None):
        seeds, all_perms, scalars = iteration_inputs(cfg, state, 1, dev,
                                                     seed, perms, seed_gens)
        return iteration(state, seeds[0], all_perms[0], scalars[0], mark,
                         draws)

    return step


def make_train_step(cfg: PPOConfig, env_params: EnvParams,
                    device=None,
                    on_phase: Optional[Callable[[str], None]] = None,
                    dtype=torch.float32,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Returns train_step(state, seed=None, perms=None, draws=None) ->
    (state, metrics): one PPO iteration (rollout, GAE, epochs of Adam
    steps, on the paths cfg.fused_rollout and cfg.fused_update choose) of
    a `dtype` state, run eagerly.  Metrics are 0-dim tensors on the
    state's device.  `on_phase(name)`, when given, is called as each phase
    ends ("rollout", "gae", "update"), so a caller can time the phases of
    this very step.  With a `mesh` on which the run is `env_sharded`, the
    step is a rank's share of the whole batch's (`_solo_iteration`): the
    state holds the rank's envs.

    It refuses what the port does not run (`check_ported`);
    `fused_update_packed` is the fused update here."""
    dev = resolve_device(device)
    check_ported(cfg, dtype)
    _check_matmuls(cfg, dev)
    mesh = mesh if env_sharded(cfg, mesh) else None
    return eager_step(_solo_iteration(cfg, env_params, dev, dtype, mesh),
                      cfg, dev, on_phase)


# ------------------------------------------------- iterations per call

def stacked_loop(step: Callable, iters_per_call: int) -> Callable:
    """train_loop(state) -> (state, metrics): `iters_per_call` calls of
    `step`, their metrics stacked on a leading (K,) axis, under the span
    `learner.call` (its key: the call's ordinal)."""
    calls = itertools.count(1)

    def train_loop(state):
        with profiling.span("learner.call", call=next(calls)):
            rows = []
            for _ in range(iters_per_call):
                state, metrics = step(state)
                rows.append(metrics)
            return state, {k: torch.stack([m[k] for m in rows])
                           for k in rows[0]}

    return train_loop


def _state_leaves(state) -> List[torch.Tensor]:
    """The tensors one iteration hands the next: params, Adam moments,
    every EnvState field and obs."""
    return ([state.params, state.opt_state.mu, state.opt_state.nu]
            + [getattr(state.env_state, f.name)
               for f in dataclasses.fields(EnvState)] + [state.obs])


def _with_leaves(state, leaves: Sequence[torch.Tensor], iterations: int,
                 adam_steps: int):
    """`state` with `leaves` (in `_state_leaves`' order), `iterations` more
    completed iterations and `adam_steps` more Adam steps."""
    params, mu, nu, *rest = leaves
    env = EnvState(**{f.name: t for f, t in
                      zip(dataclasses.fields(EnvState), rest)})
    return state.replace(
        params=params, opt_state=AdamState(
            mu=mu, nu=nu, count=state.opt_state.count + adam_steps),
        env_state=env, obs=rest[-1], iteration=state.iteration + iterations)


# the kernels a training iteration launches, whose counters a replay adds to
KERNELS = {"policy_rollout": policy_rollout.fused_policy_rollout_members,
           "ppo_grads": ppo_grads.ppo_minibatch_grads_members,
           "adv_norm": ppo_grads.normalize_adv_minibatches}
_COUNTERS = tuple(KERNELS.values())


class _IterationGraph:
    """One PPO iteration captured as a CUDA graph, for one state shape.

    Built at a loop's first call: that call's first iteration runs eagerly
    on the capture stream (its result is the call's first; it also loads
    the kernels, sets their attributes and warms cuBLAS, so that the
    capture meets none of it), then the same iteration is captured on
    static copies of the state's tensors and of the iteration's inputs.
    Inside the graph the new state is copied back into the static state,
    so replays chain with no copy between them, and the metrics are packed
    into one static tensor.  The launch counters that the capture moved
    are put back; each replay adds the launches it holds, and counts the
    collectives it holds (`parallel.mesh.TALLY` over the capture) in the
    program's counters while a profiler records.  Both the eager
    iteration and the capture launch the phase marks (`phase_marks`), so
    every replay carries them."""

    def __init__(self, iteration: Callable, state, inputs: Sequence):
        dev = state.params.device
        self.mark = phase_marks(dev)
        current = torch.cuda.current_stream(dev)
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            first, metrics = iteration(state, *inputs, self.mark)
            self.names = list(metrics)
            self.first = (first, self.pack(metrics))
            self.iteration = iteration
            self.leaves = [t.clone() for t in _state_leaves(state)]
            self.inputs = [x.clone() for x in inputs]
            self.static = _with_leaves(state, self.leaves, 0, 0)
            before = [c.launches for c in _COUNTERS]
            tallied = dict(mesh_lib.TALLY)
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self.graph, stream=stream):
                    self.metrics = self.captured()
            finally:
                self.collectives = {k: n - tallied.get(k, 0) for k, n in
                                    mesh_lib.TALLY.items()
                                    if n != tallied.get(k, 0)}
                self.launches = [c.launches - n
                                 for c, n in zip(_COUNTERS, before)]
                for c, n in zip(_COUNTERS, before):
                    c.launches = n
        current.wait_stream(stream)

    def captured(self) -> torch.Tensor:
        """What the graph holds: the iteration on the static state and
        inputs, its new state copied back into the static state; returns
        the packed metrics."""
        new, metrics = self.iteration(self.static, *self.inputs, self.mark)
        for dst, src in zip(self.leaves, _state_leaves(new)):
            dst.copy_(src)
        return self.pack(metrics)

    def pack(self, metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.stack([metrics[k] for k in self.names])

    def load(self, state) -> None:
        for dst, src in zip(self.leaves, _state_leaves(state)):
            dst.copy_(src)

    def replay(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """One iteration on the static state with `inputs`; returns its
        packed metrics."""
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.graph.replay()
        for c, n in zip(_COUNTERS, self.launches):
            c.launches += n
        for k, n in self.collectives.items():
            profiling.count(k, n)
        return self.metrics.clone()


class ReplayedLoop:
    """train_loop(state) -> (state, metrics) on the card: `iters_per_call`
    PPO iterations as replays of one iteration captured as a CUDA graph
    (`_IterationGraph`, one per state shape), with one read-back of the
    metrics per call left to the caller.

    Before the replays the host makes every iteration's inputs
    (`iteration_inputs`: the rollout seed and the epoch permutations
    drawn from the state's generators in the eager order, and the Adam
    scalars) and copies them to the card at once; before each replay they
    are copied into the graph's static inputs on the card.  The call's
    state is copied into the graph's static state first, and the result is
    a copy of it, so the caller's state is never overwritten.  The
    result equals `iters_per_call` eager steps bit for bit, generators
    included.  A capture or replay that fails raises; nothing falls back
    to the eager loop.

    A call is the span `learner.call` (its key: the call's ordinal), whose
    children are the host's work in order: `learner.inputs`,
    `learner.capture` (a shape's first call), `learner.load`, one
    `learner.replay` a replay (the input copies and the graph's launch)
    and `learner.unpack` (the result's state and metrics)."""

    def __init__(self, iteration: Callable, cfg: PPOConfig,
                 iters_per_call: int, seed_gens: Sequence[int] = (0,)):
        self.iteration, self.cfg = iteration, cfg
        self.iters_per_call = iters_per_call
        self.seed_gens = tuple(seed_gens)
        self._graphs: Dict[Tuple, _IterationGraph] = {}
        self._calls = itertools.count(1)

    def __call__(self, state):
        with profiling.span("learner.call", call=next(self._calls)):
            return self._call(state)

    def _call(self, state):
        K = self.iters_per_call
        with profiling.span("learner.inputs"):
            inputs = iteration_inputs(self.cfg, state, K,
                                      state.params.device,
                                      seed_gens=self.seed_gens)
        key = tuple((tuple(t.shape), t.dtype, t.device)
                    for t in _state_leaves(state))
        graph = self._graphs.get(key)
        packed = []
        if graph is None:
            with profiling.span("learner.capture"):
                graph = _IterationGraph(self.iteration, state,
                                        [x[0] for x in inputs])
            self._graphs[key] = graph
            state, first = graph.first
            graph.first = None
            packed.append(first)
        done = len(packed)
        if done < K:
            with profiling.span("learner.load"):
                graph.load(state)
            for k in range(done, K):
                with profiling.span("learner.replay"):
                    packed.append(graph.replay([x[k] for x in inputs]))
        with profiling.span("learner.unpack"):
            if done < K:
                state = _with_leaves(
                    state, [t.clone() for t in graph.leaves], K - done,
                    (K - done) * self.cfg.n_epochs * self.cfg.n_minibatches)
            return state, dict(zip(graph.names,
                                   torch.stack(packed).unbind(1)))


def replays(dev: torch.device, mesh: Optional[Mesh]) -> bool:
    """Whether K iterations a call are replays of a captured CUDA graph:
    on the card, alone or over NCCL, whose collectives a graph holds.
    Under gloo (on the CPU, or ranks sharing a card) a call is K eager
    steps, which are the same bits."""
    return dev.type == "cuda" and backend_of(mesh) in (None, "nccl")


def make_train_loop(cfg: PPOConfig, env_params: EnvParams,
                    iters_per_call: int, device=None,
                    dtype=torch.float32,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Returns train_loop(state) -> (state, metrics): `iters_per_call` PPO
    iterations a call, metrics stacked on a leading (K,) axis, as K calls
    of `make_train_step`'s step would give them (the counterpart of JAX
    `learner.make_train_loop`, a `lax.scan` of the step).  On the CPU it
    is those K eager steps; on the card, replays of one captured iteration
    (`ReplayedLoop`); over NCCL the graph holds the iteration's
    collectives, which its first, eager iteration has issued before the
    capture (`replays`)."""
    dev = resolve_device(device)
    check_ported(cfg, dtype)
    _check_matmuls(cfg, dev)
    if not replays(dev, mesh):
        return stacked_loop(make_train_step(cfg, env_params, dev,
                                            dtype=dtype, mesh=mesh),
                            iters_per_call)
    mesh = mesh if env_sharded(cfg, mesh) else None
    return ReplayedLoop(_solo_iteration(cfg, env_params, dev, dtype, mesh),
                        cfg, iters_per_call)


# -------------------------------------------------------------- evaluation

GREEDY_CHUNK = 64      # steps between the host's early-exit checks


def _greedy_steps(policy_mean: Callable[[torch.Tensor], torch.Tensor],
                  carry: Tuple, env_params: EnvParams, n_steps: int
                  ) -> Tuple:
    """`n_steps` greedy steps of carry = (env_state, obs, ret, length,
    outcome, done_seen): every env takes its clipped mean action, and the
    first episode of each is recorded."""
    env_state, obs, ret, length, outcome, done_seen = carry
    dtype = env_state.px.dtype
    for _ in range(n_steps):
        a = torch.clamp(policy_mean(obs), -1.0, 1.0).to(dtype)
        env_state, out = vector.step_batch(env_state, a, env_params)
        active = ~done_seen
        ret = ret + torch.where(active, out.reward, 0.0)
        length = length + active.to(torch.int32)
        outcome = torch.where(active & out.done, out.outcome, outcome)
        done_seen = done_seen | out.done
        obs = out.obs
    return env_state, obs, ret, length, outcome, done_seen


def _greedy_start(env_state: EnvState, obs: torch.Tensor) -> Tuple:
    n = obs.shape[0]
    dev = obs.device
    return (env_state, obs,
            torch.zeros(n, dtype=env_state.px.dtype, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev))


def _greedy_result(carry: Tuple) -> Dict[str, torch.Tensor]:
    return dict(zip(("return", "length", "outcome", "done"), carry[2:]))


@torch.no_grad()
def greedy_rollout(policy_mean: Callable[[torch.Tensor], torch.Tensor],
                   env_state: EnvState, obs: torch.Tensor,
                   env_params: EnvParams) -> Dict[str, torch.Tensor]:
    """Step every env greedily (clipped mean action) for up to max_steps and
    record its FIRST episode: per-env return, length and outcome, eagerly.
    `policy_mean(obs (n, 8))` gives the (n,) action means; the env steps in
    its own dtype (float64 for the exact protocol).  The host checks after
    every GREEDY_CHUNK steps whether every env has ended, and stops: later
    steps change nothing.  `GreedyEval` replays the same chunks as CUDA
    graphs on the card; this loop is what it runs on the CPU.  Each chunk,
    its check included, is the span `eval.chunk`, and the chunks run add
    to the counter `eval.chunks`."""
    carry = _greedy_start(env_state, obs)
    chunks = 0
    for start in range(0, env_params.max_steps, GREEDY_CHUNK):
        chunks += 1
        with profiling.span("eval.chunk"):
            carry = _greedy_steps(
                policy_mean, carry, env_params,
                min(GREEDY_CHUNK, env_params.max_steps - start))
            done = bool(carry[-1].all())
        if done:
            break
    profiling.count("eval.chunks", chunks)
    return _greedy_result(carry)


class _ChunkGraphs:
    """The greedy loop's chunks captured as CUDA graphs for one (envs, env
    dtype, policy kind, P): a GREEDY_CHUNK-step graph and, when max_steps
    is not a multiple of it, a graph of the remaining steps.  Both read
    and update the same static tensors in place (the params and the
    carry), so replays chain with no copy between them."""

    def __init__(self, policy_mean, params: torch.Tensor,
                 env_state: EnvState, obs: torch.Tensor,
                 env_params: EnvParams):
        self.params = params.clone()
        self.carry = tuple(_clone(x) for x in _greedy_start(env_state, obs))
        full, tail = divmod(env_params.max_steps, GREEDY_CHUNK)
        self.lengths = [GREEDY_CHUNK] * full + ([tail] if tail else [])

        def chunk(n_steps):
            new = _greedy_steps(lambda o: policy_mean(self.params, o),
                                self.carry, env_params, n_steps)
            for dst, src in zip(_leaves(self.carry), _leaves(new)):
                dst.copy_(src)

        # warm up (cuBLAS handles, workspaces) on the capture stream
        stream = torch.cuda.Stream(device=obs.device)
        stream.wait_stream(torch.cuda.current_stream(obs.device))
        with torch.cuda.stream(stream):
            chunk(1)
        torch.cuda.current_stream(obs.device).wait_stream(stream)
        self.graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        pool = None
        for n in sorted(set(self.lengths), reverse=True):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, stream=stream):
                chunk(n)
            pool = g.pool()
            self.graphs[n] = g

    def run(self, params: torch.Tensor, env_state: EnvState,
            obs: torch.Tensor) -> Tuple:
        """Play the episodes from (env_state, obs) on the static carry,
        which it returns: the params and the start copied in (the span
        `eval.load`), then the chunks replayed until every env has ended,
        each with the host's check (`eval.chunk`, counted to
        `eval.chunks`)."""
        with profiling.span("eval.load"):
            self.params.copy_(params)
            for dst, src in zip(_leaves(self.carry),
                                _leaves(_greedy_start(env_state, obs))):
                dst.copy_(src)
        chunks = 0
        for n in self.lengths:
            chunks += 1
            with profiling.span("eval.chunk"):
                self.graphs[n].replay()
                done = bool(self.carry[-1].all())
            if done:
                break
        profiling.count("eval.chunks", chunks)
        return self.carry


def _leaves(carry: Tuple) -> List[torch.Tensor]:
    env_state = carry[0]
    return ([getattr(env_state, f.name)
             for f in dataclasses.fields(EnvState)] + list(carry[1:]))


def _clone(x):
    if isinstance(x, EnvState):
        return EnvState(**{f.name: getattr(x, f.name).clone()
                           for f in dataclasses.fields(EnvState)})
    return x.clone()


class GreedyEval:
    """Greedy episodes of one policy kind: `members=False`, params
    (N_PARAMS,) play every env; `members=True`, params (P, N_PARAMS), and
    member m plays the m-th of P equal runs of envs (a batched per-member
    MLP).  The policy runs in its params' dtype (float32) on the env's
    observations.

    On the CPU it runs `greedy_rollout`.  On a CUDA device each GREEDY_CHUNK
    steps of that loop (about 440 small launches a step) are captured once
    per (envs, env dtype, P) as a CUDA graph and replayed, the params and
    the start state copied into the graph's static inputs first; between
    replays the host reads only whether every env has ended, as the eager
    loop does, so the results are the eager loop's bit for bit.  A capture
    that fails raises; nothing falls back to the eager loop on the card.

    `evaluate` is one eval, the span `eval` (its key: the eval's ordinal),
    whose children are the host's work: `eval.reset` (the spawn),
    `eval.capture` (a shape's first eval on the card), `eval.load`, one
    `eval.chunk` a chunk, and `eval.result` (the result's copies and its
    reduction)."""

    def __init__(self, members: bool = False, device=None):
        self.members = members
        self._model = (None if members
                       else ActorCritic(device=resolve_device(device)))
        self._graphs: Dict[Tuple, _ChunkGraphs] = {}
        self._evals = itertools.count(1)

    def policy_mean(self, params: torch.Tensor, obs: torch.Tensor
                    ) -> torch.Tensor:
        o = obs.to(params.dtype)
        if self.members:
            P = params.shape[0]
            return members_forward(params, o.view(P, o.shape[0] // P, -1)
                                   )[0].reshape(-1)
        return apply_flat(self._model, params, o)[0][:, 0]

    @torch.no_grad()
    def __call__(self, params: torch.Tensor, env_state: EnvState,
                 obs: torch.Tensor, env_params: EnvParams,
                 reduce: Optional[Callable] = None):
        """The greedy episodes from (env_state, obs): each env's first
        episode's return, length, outcome and done, (n,) each; with
        `reduce`, reduce(those)."""
        cuda = obs.device.type == "cuda"
        if cuda:
            key = (tuple(obs.shape), env_state.px.dtype, tuple(params.shape),
                   params.dtype, env_params)
            graphs = self._graphs.get(key)
            if graphs is None:
                with profiling.span("eval.capture"):
                    graphs = _ChunkGraphs(self.policy_mean, params,
                                          env_state, obs, env_params)
                self._graphs[key] = graphs
            ep = _greedy_result(graphs.run(params, env_state, obs))
        else:
            ep = greedy_rollout(lambda o: self.policy_mean(params, o),
                                env_state, obs, env_params)
        with profiling.span("eval.result"):
            if cuda:
                # the static carry is the next eval's
                ep = {k: v.clone() for k, v in ep.items()}
            return ep if reduce is None else reduce(ep)

    def evaluate(self, params: torch.Tensor,
                 reset: Callable[[], Tuple[EnvState, torch.Tensor]],
                 env_params: EnvParams, reduce: Callable):
        """One eval: the episodes that `reset()` spawns, played greedily
        and reduced by `reduce`."""
        with profiling.span("eval", eval=next(self._evals)):
            with profiling.span("eval.reset"):
                env_state, obs = reset()
            return self(params, env_state, obs, env_params, reduce)


def eval_metrics(ep: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Episode statistics over the last axis: (n,) episodes give 0-dim
    metrics, a population's (P, n) give (P,)."""
    ret = ep["return"]
    return {
        "eval_return_mean": ret.mean(-1),
        "eval_return_std": ret.std(-1, correction=0),
        "eval_length_mean": ep["length"].to(torch.float32).mean(-1),
        "eval_goal_rate": (ep["outcome"] == 1).to(torch.float32).mean(-1),
        "eval_collision_rate": (ep["outcome"] == 2).to(torch.float32).mean(-1),
        "eval_done_all": ep["done"].all(-1),
    }


def make_eval_fn(cfg: PPOConfig, env_params: EnvParams, dtype=torch.float32,
                 device=None) -> Callable:
    """Greedy evaluation of cfg.eval_episodes fresh episodes drawn from a
    generator: eval_fn(params, generator) -> metrics (EvalCallback
    equivalent, training_main.py:31-35)."""
    dev = resolve_device(device)
    greedy = GreedyEval(device=dev)

    def eval_fn(params, generator):
        return greedy.evaluate(
            params, lambda: vector.reset_batch(cfg.eval_episodes, env_params,
                                               generator, dtype, dev),
            env_params, eval_metrics)

    return eval_fn


def exact_episodes(params: torch.Tensor, env_params: EnvParams,
                   spawner: MersenneSpawner, n_episodes: int,
                   dtype=torch.float64, device=None,
                   greedy: Optional[GreedyEval] = None
                   ) -> Dict[str, torch.Tensor]:
    """Greedy episodes spawned from the reference's Mersenne stream
    (oracle.MersenneSpawner + core.reset_from), `n_episodes` draws, played
    by `greedy` (default a new solo `GreedyEval`)."""
    dev = resolve_device(device)
    env_state, obs = mersenne_reset(env_params, spawner, n_episodes, dtype,
                                    dev)
    greedy = greedy if greedy is not None else GreedyEval(device=dev)
    return greedy(params, env_state, obs, env_params)


def mersenne_reset(env_params: EnvParams, spawner: MersenneSpawner,
                   n_episodes: int, dtype=torch.float64, device=None
                   ) -> Tuple[EnvState, torch.Tensor]:
    """The next `n_episodes` spawns of the reference's Mersenne stream,
    reset (oracle.MersenneSpawner + core.reset_from)."""
    inits = spawner.spawn_batch(n_episodes)
    return core.reset_from(
        np.array([i.player_psi for i in inits]),
        np.stack([i.traffic_x for i in inits]),
        np.stack([i.traffic_y for i in inits]),
        np.stack([i.traffic_v for i in inits]),
        np.stack([i.traffic_psi for i in inits]),
        np.array([i.num_traffic for i in inits]),
        env_params, dtype, device)


def make_exact_eval_fn(cfg: PPOConfig, env_params: EnvParams,
                       dtype=torch.float32, device=None,
                       skip_episodes: int = 0) -> Callable:
    """Greedy evaluation whose episodes spawn from ONE continuing Mersenne
    stream (the reference EvalCallback's protocol): eval_fn(params) draws
    the next cfg.eval_episodes spawns on every call.  `skip_episodes`
    fast-forwards the stream past the episodes an earlier process drew (a
    resumed run's)."""
    dev = resolve_device(device)
    spawner = MersenneSpawner(env_params, seed=cfg.seed,
                              skip_episodes=skip_episodes)
    greedy = GreedyEval(device=dev)

    def eval_fn(params, generator=None):
        del generator                    # Mersenne stream, not the generator
        return greedy.evaluate(
            params, lambda: mersenne_reset(env_params, spawner,
                                           cfg.eval_episodes, dtype, dev),
            env_params, eval_metrics)

    return eval_fn
