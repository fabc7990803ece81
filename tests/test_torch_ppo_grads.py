"""The port's PPO minibatch gradient (plain version, ops/ppo_grads.py) vs the
Pallas kernel `acas2d_tpu/ops/pallas_update.py:ppo_minibatch_grads` in
interpret mode and vs `jax.grad` of `acas2d_tpu/ppo/learner.py:ppo_loss`,
float32 on the CPU, on minibatches whose ratios straddle the clip band
(the fixture of tests/test_pallas_update.py:26-44).

Tolerance: each parameter block to 1e-5 of its largest gradient (the JAX
package's own bound for its kernel against jax.grad: float32 sums in another
order); loss statistics to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.models.actor_critic import gaussian_log_prob as jlogp
from acas2d_tpu.ops import pallas_update
from acas2d_tpu.ppo import learner as jlearner
from acas2d_tpu.ppo.config import PPOConfig
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ops import ppo_grads
from acas2d_tpu_torch.utils.params_io import from_jax_params

REL_TOL = 1e-5


def _minibatch(jparams, n=256, seed=1, ratio_spread=0.3):
    rng = np.random.default_rng(seed)
    model = JActorCritic()
    obs = rng.normal(size=(n, 8)).astype(np.float32) * 0.3
    mean, log_std, value = model.apply(jparams, jnp.asarray(obs))
    act = np.asarray(mean) + rng.normal(size=(n, 1)).astype(np.float32) * 0.7
    old_logp = np.asarray(jlogp(jnp.asarray(act), mean, log_std))
    old_logp = old_logp + rng.normal(size=n).astype(np.float32) * ratio_spread
    adv = rng.normal(size=n).astype(np.float32)
    ret = rng.normal(size=n).astype(np.float32)
    vals = np.asarray(value)
    packed = np.concatenate([obs, act, old_logp[:, None], vals[:, None],
                             adv[:, None], ret[:, None]], axis=1)
    fields = tuple(jnp.asarray(x) for x in (obs, act, old_logp, vals, adv, ret))
    return packed.astype(np.float32), fields


def _flat_of(jtree):
    m = ActorCritic()
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jtree)))
    return flatten(m)


def _assert_grads_close(got, want_tree, what):
    want = _flat_of(want_tree).numpy()
    got = got.numpy()
    # blocks of the flat layout: per tower w1, b1, w2, b2, w_head, b_head
    sizes = [512, 64, 4096, 64, 64, 1] * 2 + [1]
    i = 0
    for k, n in enumerate(sizes):
        a, b = got[i:i + n], want[i:i + n]
        scale = np.abs(b).max() + 1e-12
        assert np.abs(a - b).max() / scale < REL_TOL, (what, k)
        i += n


@pytest.mark.parametrize("ent_coef,seed", [(0.0, 0), (0.01, 2)])
def test_grads_match_pallas_kernel_and_jax_grad(ent_coef, seed):
    cfg = PPOConfig(n_envs=2, n_steps=128, minibatch_size=256,
                    total_timesteps=256, ent_coef=ent_coef)
    jparams = JActorCritic().init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, 8), jnp.float32))
    packed, fields = _minibatch(jparams, seed=seed + 1)

    (loss, aux), ref = jax.value_and_grad(jlearner.ppo_loss, has_aux=True)(
        jparams, JActorCritic(), fields, cfg)
    kgrads, kaux = pallas_update.ppo_minibatch_grads(
        jparams, jnp.asarray(packed), clip_range=cfg.clip_range,
        vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef, interpret=True)
    grads, taux = ppo_grads.ppo_minibatch_grads(
        _flat_of(jparams), torch.as_tensor(packed), clip_range=cfg.clip_range,
        vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef)

    assert 0.1 < float(aux["clip_fraction"]) < 0.9   # both clip regimes
    _assert_grads_close(grads, kgrads, "vs pallas interpret")
    _assert_grads_close(grads, ref, "vs jax.grad")
    for k in ("policy_loss", "value_loss", "entropy", "approx_kl",
              "clip_fraction"):
        for other in (aux, kaux):
            np.testing.assert_allclose(float(taux[k]), float(other[k]),
                                       rtol=REL_TOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(taux["loss"]), float(loss), rtol=REL_TOL)


def test_log_ratio_clamp_and_shapes():
    """Rows whose |log-ratio| exceeds 20 get no policy gradient (delta_in),
    and the function rejects packed widths other than 13."""
    jparams = JActorCritic().init(jax.random.PRNGKey(4),
                                  jnp.zeros((1, 8), jnp.float32))
    packed, _ = _minibatch(jparams, n=128, seed=5)
    packed[:64, 9] += 40.0                       # old_logp far off
    kgrads, _ = pallas_update.ppo_minibatch_grads(
        jparams, jnp.asarray(packed), clip_range=0.2, vf_coef=0.5,
        ent_coef=0.0, interpret=True)
    grads, _ = ppo_grads.ppo_minibatch_grads(
        _flat_of(jparams), torch.as_tensor(packed), clip_range=0.2,
        vf_coef=0.5, ent_coef=0.0)
    _assert_grads_close(grads, kgrads, "clamped rows")
    with pytest.raises(ValueError):
        ppo_grads.ppo_minibatch_grads(_flat_of(jparams),
                                      torch.zeros(128, 12), clip_range=0.2,
                                      vf_coef=0.5, ent_coef=0.0)


def test_normalize_adv_column_is_population_std():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(64, 13)),
                        dtype=torch.float32)
    got = ppo_grads.normalize_adv_column(x)
    want = pallas_update.normalize_adv_column(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(got[:, :11], x[:, :11]) and torch.equal(got[:, 12], x[:, 12])
