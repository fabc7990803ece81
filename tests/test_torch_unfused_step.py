"""Whole PPO iterations of the port's unfused paths against the JAX
learner's `make_train_step` and population step, on the CPU.

* The unfused step (step-by-step rollout -> GAE -> autograd epochs ->
  Adam) against JAX `make_train_step` with fused_rollout=False,
  fused_update=False, in float64 under x64: 8 envs x 32 steps, minibatch
  64, 2 epochs.  The port takes JAX's draws: the action noise re-derived
  from the key splits of JAX's rollout and the epoch permutations from
  its update key.  No episode ends in the horizon (asserted), so the
  respawns, whose draws differ by design, do not enter.  Params, Adam
  moments and every metric to 1e-12 (1e-9 for positions, ~1e3 px).
* The fused rollout with the autograd update against JAX
  `make_train_step(fused_rollout=True, fused_update=False)`, float32, its
  rollout kernel in Pallas interpret mode: 1024 envs (one Pallas program)
  x 8 steps in chunks of 4, minibatch 2048, 1 epoch, episodes part-way
  through so that timeouts end some.  Tolerances are
  tests/test_torch_slice.py's: counts and rates exactly, returns and
  lengths rtol 1e-5, losses rtol 1e-4, params atol 2e-6; returns also
  atol 1e-7, since these episodes time out where the time discount is ~0
  and their mean return (~7e-5) is a sum of float32 rewards whose
  rounding alone is ~1e-8.
* The unfused population step at P = 2 (float64) against JAX's
  population step (its vmap of the solo step) on the members' JAX draws,
  and against two solo steps of the port on the same draws: 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu.config import DEFAULT_PARAMS as JP
from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.ppo import learner as jlearner
from acas2d_tpu.ppo import population as jpopulation
from acas2d_tpu.ppo.config import PPOConfig as JPPOConfig
from acas2d_tpu_torch.config import DEFAULT_PARAMS as TP
from acas2d_tpu_torch.envs import core
from acas2d_tpu_torch.ppo import learner, population
from acas2d_tpu_torch.ppo.config import PPOConfig
from acas2d_tpu_torch.types import EnvState
from test_torch_unfused_rollout import FIELDS, env_of, flat_of, jax_noise

F64_ATOL = 1e-12
SOLO = dict(n_envs=8, n_steps=32, minibatch_size=64, n_epochs=2,
            total_timesteps=8 * 32 * 4, anneal_lr=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def member(es, i) -> EnvState:
    return EnvState(**{f: getattr(es, f)[i] for f in FIELDS})


def widen(js, tx):
    """A JAX TrainState with float64 params and Adam state."""
    p64 = jax.tree.map(lambda x: x.astype(jnp.float64), js.params)
    return js.replace(params=p64, opt_state=tx.init(p64))


def jax_draws(key, cfg, spawn_seed):
    """The port's draws of a JAX unfused train step from `key`: the noise
    of its rollout, numpy respawn uniforms, and its epoch permutations."""
    noise, key = jax_noise(key, cfg.n_steps, cfg.n_envs, jnp.float64)
    _, k_update = jax.random.split(key)
    perms = [np.asarray(jax.random.permutation(k, cfg.batch_size))
             for k in jax.random.split(k_update, cfg.n_epochs)]
    spawn = np.random.default_rng(spawn_seed).uniform(
        size=(cfg.n_steps, cfg.n_envs, core.spawn_width(TP)))
    return (learner.RolloutDraws(noise=torch.tensor(noise),
                                 spawn=torch.tensor(spawn)), perms)


def assert_states_close(new, jnew_params, jopt, jes, jobs, tdt=torch.float64):
    np.testing.assert_allclose(new.params.numpy(),
                               flat_of(jnew_params, tdt).numpy(), rtol=0,
                               atol=F64_ATOL)
    adam = [s for s in jax.tree_util.tree_leaves(
        jopt, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")][0]
    np.testing.assert_allclose(new.opt_state.mu.numpy(),
                               flat_of(adam.mu, tdt).numpy(), rtol=0,
                               atol=F64_ATOL)
    np.testing.assert_allclose(new.opt_state.nu.numpy(),
                               flat_of(adam.nu, tdt).numpy(), rtol=1e-9,
                               atol=1e-30)
    np.testing.assert_allclose(new.obs.numpy(), np.asarray(jobs), rtol=0,
                               atol=F64_ATOL)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(new.env_state, f).numpy(),
                                   np.asarray(getattr(jes, f)), rtol=0,
                                   atol=1e-9, err_msg=f)


@pytest.fixture(scope="module")
def solo():
    jcfg, cfg = JPPOConfig(**SOLO), PPOConfig(**SOLO)
    model = JActorCritic()
    tx = jlearner.make_optimizer(jcfg)
    js = widen(jlearner.init_train_state(jax.random.PRNGKey(7), model, jcfg,
                                         JP, jnp.float64), tx)
    jnew, jm = jax.jit(jlearner.make_train_step(model, jcfg, JP))(js)
    draws, perms = jax_draws(js.key, cfg, 0)
    params = flat_of(js.params)
    state = learner.TrainState(
        params=params, opt_state=learner.Optimizer(cfg).init(params),
        env_state=env_of(js.env_state), obs=torch.tensor(np.asarray(js.obs)),
        generator=torch.Generator())
    step = learner.make_train_step(cfg, TP, "cpu", dtype=torch.float64)
    new, m = step(state, perms=perms, draws=draws)
    return jnew, jax.tree.map(np.asarray, jm), new, m


def test_unfused_step_metrics_match_jax(solo):
    jnew, jm, new, m = solo
    assert float(jm["episodes"]) == 0, "no episode may end here"
    assert set(m) == set(jm) - {"iteration"}
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-11,
                                   atol=F64_ATOL, err_msg=k)
    assert new.iteration == int(jnew.iteration) == 1
    assert new.opt_state.count == 2 * 4


def test_unfused_step_state_matches_jax(solo):
    jnew, jm, new, m = solo
    assert new.params.dtype == torch.float64
    assert_states_close(new, jnew.params, jnew.opt_state, jnew.env_state,
                        jnew.obs)


def test_fused_rollout_with_autograd_update_matches_jax():
    shape = dict(n_envs=1024, n_steps=8, fused_rollout=True, fused_chunk=4,
                 minibatch_size=2048, n_epochs=1, total_timesteps=1024 * 8)
    jcfg, cfg = JPPOConfig(**shape), PPOConfig(**shape)
    assert not cfg.fused_update
    model = JActorCritic()
    js = jlearner.init_train_state(jax.random.PRNGKey(5), model, jcfg, JP)
    mid = np.random.default_rng(0).integers(1, JP.max_steps + 1, 1024)
    js = js.replace(env_state=js.env_state.replace(
        steps=jnp.asarray(mid, jnp.int32)))
    jnew, jm = jax.jit(jlearner.make_train_step(model, jcfg, JP))(js)
    key, k_seed = jax.random.split(js.key)
    seed = int(jax.random.randint(k_seed, (), 0, jnp.iinfo(jnp.int32).max,
                                  jnp.int32))
    _, k_update = jax.random.split(key)
    perms = [np.asarray(jax.random.permutation(k, cfg.batch_size))
             for k in jax.random.split(k_update, cfg.n_epochs)]
    params = flat_of(js.params, torch.float32)
    state = learner.TrainState(
        params=params, opt_state=learner.Optimizer(cfg).init(params),
        env_state=env_of(js.env_state), obs=torch.tensor(np.asarray(js.obs)),
        generator=torch.Generator())
    new, m = learner.make_train_step(cfg, TP, "cpu")(state, seed=seed,
                                                      perms=perms)
    assert float(jm["episodes"]) > 0, "the shape should end some episodes"
    for k in ("episodes", "goal_rate", "collision_rate", "timeout_rate"):
        assert float(m[k]) == float(jm[k]), k
    for k in ("ep_return_mean", "ep_length_mean"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for k in ("policy_loss", "value_loss", "entropy", "approx_kl",
              "clip_fraction", "loss", "explained_variance"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(new.params.numpy(),
                               flat_of(jnew.params, torch.float32).numpy(),
                               rtol=0, atol=2e-6)


@pytest.fixture(scope="module")
def members():
    P = 2
    shape = dict(SOLO, n_envs=4, minibatch_size=32)
    jcfg, cfg = JPPOConfig(**shape), PPOConfig(**shape)
    model = JActorCritic()
    tx = jlearner.make_optimizer(jcfg)
    js = jpopulation.init_population(model, jcfg, JP, P, jnp.float64)
    js = js.replace(params=jax.tree.map(lambda x: x.astype(jnp.float64),
                                        js.params))
    js = js.replace(opt_state=jax.vmap(tx.init)(js.params))
    jnew, jm = jax.jit(jpopulation.make_population_step(model, jcfg, JP))(js)
    member_draws = [jax_draws(js.key[i], cfg, i) for i in range(P)]
    draws = learner.RolloutDraws(
        noise=torch.stack([d.noise for d, _ in member_draws], 1),
        spawn=torch.stack([d.spawn for d, _ in member_draws], 1))
    perms = [np.stack([p[e] for _, p in member_draws])
             for e in range(cfg.n_epochs)]
    params = torch.stack([flat_of(jax.tree.map(lambda x: x[i], js.params))
                          for i in range(P)])
    state = population.PopulationState(
        params=params, opt_state=learner.Optimizer(cfg).init(params),
        env_state=env_of(js.env_state), obs=torch.tensor(np.asarray(js.obs)),
        generators=[torch.Generator() for _ in range(P)])
    step = population.make_population_step(cfg, TP, "cpu",
                                            dtype=torch.float64)
    new, m = step(state, perms=perms, draws=draws)
    solo_step = learner.make_train_step(cfg, TP, "cpu", dtype=torch.float64)
    solos = [solo_step(learner.TrainState(
        params=params[i], opt_state=learner.Optimizer(cfg).init(params[i]),
        env_state=member(state.env_state, i), obs=state.obs[i],
        generator=torch.Generator()),
        perms=[p[i] for p in perms], draws=member_draws[i][0])
        for i in range(P)]
    return js, jnew, jax.tree.map(np.asarray, jm), new, m, solos


def test_unfused_population_step_matches_jax(members):
    js, jnew, jm, new, m, _ = members
    assert (jm["episodes"] == 0).all(), "no episode may end here"
    for k in m:
        assert m[k].shape == (2,)
        np.testing.assert_allclose(m[k].numpy(), jm[k], rtol=1e-11,
                                   atol=F64_ATOL, err_msg=k)
    for i in range(2):
        one = learner.TrainState(
            params=new.params[i], opt_state=learner.AdamState(
                mu=new.opt_state.mu[i], nu=new.opt_state.nu[i]),
            env_state=member(new.env_state, i),
            obs=new.obs[i], generator=None)
        pick = lambda t: jax.tree.map(lambda x: x[i], t)  # noqa: E731
        assert_states_close(one, pick(jnew.params), pick(jnew.opt_state),
                            pick(jnew.env_state), np.asarray(jnew.obs)[i])


def test_unfused_population_step_is_two_solo_steps(members):
    _, _, _, new, m, solos = members
    for i, (s, sm_) in enumerate(solos):
        np.testing.assert_allclose(new.params[i].numpy(), s.params.numpy(),
                                   rtol=0, atol=F64_ATOL)
        np.testing.assert_allclose(new.opt_state.mu[i].numpy(),
                                   s.opt_state.mu.numpy(), rtol=0,
                                   atol=F64_ATOL)
        np.testing.assert_allclose(new.obs[i].numpy(), s.obs.numpy(),
                                   rtol=0, atol=F64_ATOL)
        for k in sm_:
            np.testing.assert_allclose(float(m[k][i]), float(sm_[k]),
                                       rtol=1e-12, atol=F64_ATOL,
                                       err_msg=k)
