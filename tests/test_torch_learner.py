"""The port's learner pieces vs the JAX learner, float32 on the CPU.

* `ppo_update`: one full update (epochs x minibatches of clipped-PPO Adam
  steps) from the same params, packed batch and epoch permutations — the
  port takes the permutations the JAX update derives from its key — against
  `acas2d_tpu.ppo.learner.ppo_update` with fused_update=False (jax.grad).
  Params and both Adam moments must agree to PARAM_ATOL: each Adam step
  moves a parameter by about lr = 3e-4, and the two gradients differ only
  by float32 summation order (test_torch_ppo_grads.py), so 1e-6 is under
  1% of one step.  The second moment holds squared gradients, whose
  relative rounding grows where a gradient is near 0: rtol 1e-4 (2.4e-5
  observed).  The loss metrics (means of float32 losses): rtol 1e-6.
* `compute_gae` against `acas2d_tpu.ppo.gae.compute_gae` (same recursion,
  float32: rtol 1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.ppo import learner as jlearner
from acas2d_tpu.ppo.config import PPOConfig as JPPOConfig
from acas2d_tpu.ppo.gae import compute_gae as jgae
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.ppo.config import PPOConfig
from acas2d_tpu_torch.ppo.gae import compute_gae
from acas2d_tpu_torch.utils.params_io import from_jax_params

PARAM_ATOL = 1e-6


def _flat_of(jtree):
    m = ActorCritic()
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jtree)))
    return flatten(m).numpy()


def _adam_state(opt_state):
    """The ScaleByAdamState inside the optax chain."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0]


def _batch(jparams, T=32, B=16, seed=0):
    rng = np.random.default_rng(seed)
    obs = (rng.normal(size=(T, B, 8)) * 0.3).astype(np.float32)
    mean, log_std, value = JActorCritic().apply(jparams, jnp.asarray(obs))
    act = np.asarray(mean) + rng.normal(size=(T, B, 1)).astype(np.float32) * 0.7
    logp = np.array(jlearner.gaussian_log_prob(jnp.asarray(act), mean,
                                                 log_std))
    logp = logp + rng.normal(size=(T, B)).astype(np.float32) * 0.3
    vals = np.array(value)
    adv = rng.normal(size=(T, B)).astype(np.float32)
    ret = (vals + adv).astype(np.float32)
    return obs, act, logp.astype(np.float32), vals, adv, ret


@pytest.mark.parametrize("anneal_lr", [False, True])
def test_ppo_update_matches_jax(anneal_lr):
    kw = dict(n_envs=16, n_steps=32, minibatch_size=128, n_epochs=3,
              total_timesteps=16 * 32 * 4, anneal_lr=anneal_lr)
    jcfg, cfg = JPPOConfig(**kw), PPOConfig(**kw, fused_update=True)
    model = JActorCritic()
    jparams = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.float32))
    obs, act, logp, vals, adv, ret = _batch(jparams)
    jbatch = jlearner.RolloutBatch(
        obs=jnp.asarray(obs), actions=jnp.asarray(act),
        log_probs=jnp.asarray(logp), values=jnp.asarray(vals),
        rewards=jnp.zeros_like(jnp.asarray(vals)),
        dones=jnp.zeros(vals.shape, bool))
    tx = jlearner.make_optimizer(jcfg)
    key = jax.random.PRNGKey(9)
    jnew, jopt, jmetrics = jlearner.ppo_update(
        model, tx, jparams, tx.init(jparams), jbatch, jnp.asarray(adv),
        jnp.asarray(ret), key, jcfg)

    # the epoch permutations the JAX update draws (learner.py:440,460)
    perms = [np.asarray(jax.random.permutation(k, cfg.batch_size // cfg.shuffle_block))
             for k in jax.random.split(key, cfg.n_epochs)]
    opt = learner.Optimizer(cfg)
    params0 = torch.as_tensor(_flat_of(jparams))
    batch = learner.RolloutBatch(
        obs=torch.as_tensor(obs), actions=torch.as_tensor(act),
        log_probs=torch.as_tensor(logp), values=torch.as_tensor(vals),
        rewards=torch.zeros(vals.shape), dones=torch.zeros(vals.shape, dtype=torch.bool))
    new, opt_state, metrics = learner.ppo_update(
        params0, opt.init(params0), opt, batch, torch.as_tensor(adv),
        torch.as_tensor(ret), cfg, perms=perms)

    n_steps = cfg.n_epochs * cfg.n_minibatches
    assert opt_state.count == n_steps == int(_adam_state(jopt).count)
    moved = np.abs(new.numpy() - params0.numpy()).max()
    assert moved > 10 * PARAM_ATOL, "the update should move the params"
    np.testing.assert_allclose(new.numpy(), _flat_of(jnew), rtol=0,
                               atol=PARAM_ATOL)
    adam = _adam_state(jopt)
    np.testing.assert_allclose(opt_state.mu.numpy(), _flat_of(adam.mu),
                               rtol=0, atol=PARAM_ATOL)
    np.testing.assert_allclose(opt_state.nu.numpy(), _flat_of(adam.nu),
                               rtol=1e-4, atol=1e-10)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


def test_gae_matches_jax():
    rng = np.random.default_rng(3)
    T, B = 64, 32
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    dones = rng.uniform(size=(T, B)) < 0.05
    last = rng.normal(size=B).astype(np.float32)
    ja, jr = jgae(*(jnp.asarray(x) for x in (rewards, values, dones, last)),
                  0.99, 0.95)
    ta, tr = compute_gae(*(torch.as_tensor(x) for x in (rewards, values,
                                                        dones, last)),
                         0.99, 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)
