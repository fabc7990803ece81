"""One whole PPO iteration of the port's slice (fused rollout -> GAE ->
clipped-PPO epochs -> Adam) vs the JAX learner's `make_train_step` with
fused_rollout=True, on the CPU at a small shape: 2048 envs (two Pallas
programs) x 16 steps in chunks of 8, minibatch 4096, 2 epochs.

Both start from the same params and env state; the port receives the
rollout seed and the epoch permutations that the JAX step derives from its
key.  The JAX step runs its rollout kernel in interpret mode and its update
through jax.grad (its fused update needs a mesh on this 8-device test
backend); the port runs the plain versions of both kernels.

Tolerances: episode counts and outcome rates exactly; returns and lengths
to rtol 1e-5 (float32 rollouts, test_torch_policy_rollout.py); losses to
rtol 1e-4 (the minibatch means see a few envs whose wrapped heading angle
changed an action, see that file); params to 2e-6 (16 Adam steps of ~3e-4,
test_torch_learner.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu.config import DEFAULT_PARAMS as JP
from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.ppo import learner as jlearner
from acas2d_tpu.ppo.config import PPOConfig as JPPOConfig
from acas2d_tpu_torch.config import DEFAULT_PARAMS as TP
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.ppo.config import PPOConfig
from acas2d_tpu_torch.types import EnvState
from acas2d_tpu_torch.utils.params_io import from_jax_params

SHAPE = dict(n_envs=2048, n_steps=16, fused_rollout=True, fused_chunk=8,
             minibatch_size=4096, n_epochs=2, total_timesteps=2048 * 16)
PARAM_ATOL = 2e-6


def _flat_of(jtree):
    m = ActorCritic()
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jtree)))
    return flatten(m)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def steps():
    # the port's update is always the fused kernel (its plain version here)
    jcfg, cfg = JPPOConfig(**SHAPE), PPOConfig(**SHAPE, fused_update=True)
    model = JActorCritic()
    js = jlearner.init_train_state(jax.random.PRNGKey(5), model, jcfg, JP)
    # episodes part-way through, so that timeouts end some in 16 steps
    mid = np.random.default_rng(0).integers(1, JP.max_steps + 1, jcfg.n_envs)
    js = js.replace(env_state=js.env_state.replace(
        steps=jnp.asarray(mid, jnp.int32)))
    jnew, jm = jax.jit(jlearner.make_train_step(model, jcfg, JP))(js)

    # the draws the JAX step makes from its key (learner.py:170-172,501,460)
    key, k_seed = jax.random.split(js.key)
    seed = int(jax.random.randint(k_seed, (), 0, jnp.iinfo(jnp.int32).max,
                                  jnp.int32))
    _, k_update = jax.random.split(key)
    perms = [np.asarray(jax.random.permutation(k, cfg.batch_size
                                               // cfg.shuffle_block))
             for k in jax.random.split(k_update, cfg.n_epochs)]

    es = js.env_state
    env_state = EnvState(
        px=_t(es.px), py=_t(es.py), ppsi=_t(es.ppsi), pa_lat=_t(es.pa_lat),
        tx=_t(es.tx), ty=_t(es.ty), tv=_t(es.tv), tpsi=_t(es.tpsi),
        num_traffic=_t(es.num_traffic), steps=_t(es.steps),
        total_reward=_t(es.total_reward), outcome=_t(es.outcome))
    params = _flat_of(js.params)
    state = learner.TrainState(
        params=params, opt_state=learner.Optimizer(cfg).init(params),
        env_state=env_state, obs=_t(js.obs), generator=torch.Generator())
    new, m = learner.make_train_step(cfg, TP, device="cpu")(
        state, seed=seed, perms=perms)
    return jnew, jm, new, m


def test_metrics_match(steps):
    jnew, jm, new, m = steps
    assert float(jm["episodes"]) > 0, "the shape should end some episodes"
    for k in ("episodes", "goal_rate", "collision_rate", "timeout_rate"):
        assert float(m[k]) == float(jm[k]), k
    for k in ("ep_return_mean", "ep_length_mean"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for k in ("policy_loss", "value_loss", "entropy", "approx_kl",
              "clip_fraction", "loss", "explained_variance"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert new.iteration == int(jnew.iteration) == 1


def test_params_and_env_state_match(steps):
    jnew, jm, new, m = steps
    np.testing.assert_allclose(new.params.numpy(),
                               _flat_of(jnew.params).numpy(), rtol=0,
                               atol=PARAM_ATOL)
    assert new.opt_state.count == 2 * 8
    np.testing.assert_array_equal(new.env_state.steps.numpy(),
                                  np.asarray(jnew.env_state.steps))
    np.testing.assert_array_equal(new.env_state.outcome.numpy(), 0)
