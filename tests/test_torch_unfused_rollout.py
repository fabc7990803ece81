"""The port's unfused rollout (`learner.collect_rollout`, the step-by-step
path that JAX's `train.py` runs by default) against the JAX learner's
`collect_rollout`, on the CPU.

JAX draws each step's action noise from its carried key (`key, k_act =
split(key)`, `normal(k_act, (B, 1))`, learner.py:114-116) and each respawn
from the env's own key; the port takes both as inputs (`RolloutDraws`).
The tests re-derive JAX's noise from its key splits and hand it to the
port, so the two sample the same actions:

* float64 under x64 over a horizon in which no env ends (asserted): every
  buffer, the last value, the final env state and the six episode
  metrics to 1e-12 (float64 sums in two orders: the forward's products
  and the env's trigonometry differ by an ulp or two a step);
* with episode ends (envs near their timeout): each env's rewards, dones
  and outcomes up to its first end agree to the same tolerance, and the
  state after an end is the fresh spawn of that step's respawn uniforms
  (`core.spawn_from_uniforms`), not JAX's threefry spawn;
* the draws themselves (`rollout_draws`): in float32 the action noise of
  a seed is the fused rollout kernel's (the same hash and salts), so the
  first step's actions of the two rollouts agree to float32 rounding
  (1e-6); float64 uniforms refine the float32 ones; the respawn uniforms
  give spawns inside the reference's ranges.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu.config import DEFAULT_PARAMS as JP
from acas2d_tpu.envs import vector as jvector
from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.ppo import learner as jlearner
from acas2d_tpu.ppo.config import PPOConfig as JPPOConfig
from acas2d_tpu_torch.config import DEFAULT_PARAMS as TP
from acas2d_tpu_torch.envs import core
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ops.policy_rollout import fused_policy_rollout
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.ppo.config import PPOConfig
from acas2d_tpu_torch.types import EnvState
from acas2d_tpu_torch.utils.params_io import from_jax_params

F64_ATOL = 1e-12
FIELDS = ("px", "py", "ppsi", "pa_lat", "tx", "ty", "tv", "tpsi",
          "num_traffic", "steps", "total_reward", "outcome")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_of(jtree, dtype=torch.float64):
    """A flax param tree as the port's flat vector in `dtype`."""
    m = ActorCritic().to(dtype)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jtree),
                                      dtype))
    return flatten(m)


def env_of(jes) -> EnvState:
    return EnvState(**{f: torch.tensor(np.asarray(getattr(jes, f)))
                       for f in FIELDS})


def jax_noise(key, T, B, dtype):
    """The action noise JAX's collect_rollout draws from `key`, (T, B),
    and the key it leaves."""
    out = []
    for _ in range(T):
        key, k_act = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k_act, (B, 1), dtype))[:, 0])
    return np.stack(out), key


def rollout_pair(B, T, steps=None, seed=3):
    """JAX's collect_rollout and the port's on the same float64 start, the
    port given JAX's noise and numpy respawn uniforms."""
    cfg = dataclasses.replace(JPPOConfig(), n_envs=B, n_steps=T)
    model = JActorCritic()
    key = jax.random.PRNGKey(seed)
    k_model, k_env, k_carry = jax.random.split(key, 3)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float64), model.init(
        k_model, jnp.zeros((1, 8), jnp.float32)))
    jes, jobs = jvector.reset_batch(k_env, B, JP, jnp.float64)
    if steps is not None:
        jes = jes.replace(steps=jnp.asarray(steps, jnp.int32))
    js = jlearner.TrainState(params=jparams, opt_state=None, env_state=jes,
                             obs=jobs, key=k_carry,
                             iteration=jnp.asarray(0, jnp.int32))
    jnew, jbatch, jlast, jm = jax.jit(
        lambda s: jlearner.collect_rollout(model, s, cfg, JP))(js)

    noise, _ = jax_noise(k_carry, T, B, jnp.float64)
    spawn = np.random.default_rng(seed).uniform(
        size=(T, B, core.spawn_width(TP)))
    draws = learner.RolloutDraws(noise=torch.tensor(noise),
                                 spawn=torch.tensor(spawn))
    params = flat_of(jparams)
    state = learner.TrainState(
        params=params, opt_state=learner.Optimizer(PPOConfig()).init(params),
        env_state=env_of(jes), obs=torch.tensor(np.asarray(jobs)),
        generator=torch.Generator())
    new, batch, last, m = learner.collect_rollout(
        state, PPOConfig(n_envs=B, n_steps=T), TP, draws)
    return (jnew, jbatch, jlast, jax.tree.map(np.asarray, jm)), (
        new, batch, last, m), spawn


def test_rollout_matches_jax_without_episode_ends():
    (jnew, jbatch, jlast, jm), (new, batch, last, m), _ = rollout_pair(
        B=16, T=48)
    assert not np.asarray(jbatch.dones).any(), "no env may end here"
    assert batch.obs.dtype == torch.float64
    for f in ("obs", "actions", "log_probs", "values", "rewards"):
        np.testing.assert_allclose(getattr(batch, f).numpy(),
                                   np.asarray(getattr(jbatch, f)),
                                   rtol=0, atol=F64_ATOL, err_msg=f)
    np.testing.assert_array_equal(batch.dones.numpy(),
                                  np.asarray(jbatch.dones))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0,
                               atol=F64_ATOL)
    np.testing.assert_allclose(new.obs.numpy(), np.asarray(jnew.obs),
                               rtol=0, atol=F64_ATOL)
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(new.env_state, f).numpy(),
            np.asarray(getattr(jnew.env_state, f)), rtol=0, atol=1e-9,
            err_msg=f)                    # positions ~1e3 px: 1e-12 relative
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=0,
                                   atol=F64_ATOL, err_msg=k)
    assert new.iteration == 1


def test_rollout_with_episode_ends():
    """Envs 3 to 9 steps before their timeout: each env's transitions up to
    its first end agree with JAX's; after it the port's env holds the
    fresh spawn of that step's uniforms."""
    B, T = 12, 16
    steps = JP.max_steps - np.arange(3, 3 + B)
    (jnew, jbatch, jlast, jm), (new, batch, last, m), spawn = rollout_pair(
        B, T, steps=steps)
    jdones = np.asarray(jbatch.dones)
    assert jdones.any(axis=0).all(), "every env should end in the horizon"
    first = jdones.argmax(axis=0)
    fresh, fresh_obs = core.observe(core.spawn_from_uniforms(
        torch.tensor(spawn.reshape(T * B, -1)), TP, torch.float64), TP)
    fresh_obs = fresh_obs.view(T, B, -1)
    for b in range(B):
        t = int(first[b])
        for f in ("rewards", "dones", "actions", "values"):
            np.testing.assert_allclose(
                getattr(batch, f)[:t + 1, b].numpy().astype(float),
                np.asarray(getattr(jbatch, f))[:t + 1, b].astype(float),
                rtol=0, atol=F64_ATOL, err_msg=f"{f} env {b}")
        # the respawn is the fresh spawn of step t's uniforms
        if t + 1 < T:
            assert torch.equal(batch.obs[t + 1, b], fresh_obs[t, b])
            assert torch.equal(batch.obs[t + 1, b, :1],
                               torch.tensor([1.0 / TP.max_steps],
                                            dtype=torch.float64))
    # outcomes: all timeouts, as the JAX rollout's
    assert float(m["episodes"]) == float(jm["episodes"]) == B
    for k in ("timeout_rate", "goal_rate", "collision_rate"):
        assert float(m[k]) == float(jm[k]), k
    np.testing.assert_allclose(float(m["ep_length_mean"]),
                               float(jm["ep_length_mean"]), rtol=0,
                               atol=F64_ATOL)
    np.testing.assert_allclose(float(m["ep_return_mean"]),
                               float(jm["ep_return_mean"]), rtol=0,
                               atol=1e-9)     # returns of ~1e3 steps' sums


def test_float32_noise_is_the_fused_kernels():
    """The same seed, params and state: the unfused rollout's first actions
    are the fused rollout's (its plain version), to float32 rounding."""
    B = 2048
    gen = torch.Generator().manual_seed(4)
    params = flatten(ActorCritic(generator=gen))
    params[-1] = -0.5
    es, obs = core.reset(B, TP, gen, torch.float32, "cpu")
    cfg = PPOConfig(n_envs=B, n_steps=1)
    draws = learner.rollout_draws(123, 1, (B,), TP, torch.float32, "cpu")
    state = learner.TrainState(params=params, opt_state=None,
                               env_state=es, obs=obs, generator=gen)
    _, batch, _, _ = learner.collect_rollout(state, cfg, TP, draws)
    flat = dict(px=es.px, py=es.py, psi=es.ppsi, tx=es.tx[:, 0],
                ty=es.ty[:, 0], tv=es.tv[:, 0], tpsi=es.tpsi[:, 0],
                steps=es.steps, total_reward=es.total_reward)
    _, buf = fused_policy_rollout(flat, obs, params, 123, 0, 1, TP)
    np.testing.assert_allclose(batch.actions[0, :, 0].numpy(),
                               buf["actions"][0].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(batch.log_probs[0].numpy(),
                               buf["log_probs"][0].numpy(), rtol=0,
                               atol=1e-5)


def test_draws_are_one_stream_in_both_dtypes():
    """Same seed, same draws; float64 uniforms refine the float32 ones (their
    top 24 bits); a seed given as a (1,) int32 tensor draws as its int; the
    noise is standard normal and the respawns lie in the reference's
    ranges."""
    shape = (4, 512)
    a = learner.rollout_draws(-7, 8, shape, TP, torch.float32, "cpu")
    b = learner.rollout_draws(torch.tensor([-7], dtype=torch.int32), 8,
                              shape, TP, torch.float32, "cpu")
    c = learner.rollout_draws(-7, 8, shape, TP, torch.float64, "cpu")
    assert a.noise.shape == (8, 4, 512) and a.spawn.shape == (8, 4, 512, 5)
    assert torch.equal(a.noise, b.noise) and torch.equal(a.spawn, b.spawn)
    assert c.noise.dtype == c.spawn.dtype == torch.float64
    assert (c.spawn - a.spawn.double()).abs().max() < 2.0 ** -24
    assert not torch.equal(c.spawn, a.spawn.double())
    z = c.noise.flatten()
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1) < 0.02
    s = core.spawn_from_uniforms(c.spawn.reshape(-1, 5), TP, torch.float64)
    assert (s.num_traffic == 1).all()
    lim = TP.player_initial_heading_lim
    bearing = core._goal_bearing(TP)
    dev = torch.remainder(s.ppsi - bearing + 180, 360) - 180
    assert float(dev.abs().max()) <= lim + 1e-9
    corners = torch.tensor([TP.collision_radius,
                            TP.height - TP.collision_radius],
                           dtype=torch.float64)
    assert float((s.ty[:, 0, None] - corners).abs().min(1).values.max()
                 ) < 1e-9
    assert (s.ty[:, 0] < TP.height / 2).any() and (
        s.ty[:, 0] > TP.height / 2).any()
    assert torch.equal(s.tv[:, 0], torch.full_like(s.tv[:, 0], TP.airspeed))


def test_spawn_from_uniforms_covers_more_traffic():
    """Three traffic slots: the count and the further slots come from their
    own uniforms, within the reference's ranges."""
    p = dataclasses.replace(TP, min_traffic=1, max_traffic=3,
                            airspeed_factor_min=0.5)
    u = torch.rand(4096, core.spawn_width(p), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    s = core.spawn_from_uniforms(u, p, torch.float64)
    assert set(s.num_traffic.tolist()) == {1, 2, 3}
    assert s.tx.shape == (4096, 3)
    assert float(s.tx[:, 1:].max()) <= p.width - p.aircraft_size
    assert float(s.ty[:, 1:].max()) <= 3 * p.height / 5
    assert float(s.tv.min()) >= 0.5 * p.airspeed
    _, obs = core.observe(s, p)
    assert obs.shape == (4096, p.obs_dim) and torch.isfinite(obs).all()
