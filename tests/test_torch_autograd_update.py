"""The port's autograd update (`learner.ppo_loss`, `ppo_loss_grads` and
`ppo_update` with fused_update=False) against the JAX learner's
`ppo_loss` under `jax.grad` and its `ppo_update(fused_update=False)`, on
the CPU in float32 and float64 (JAX under x64).

* `ppo_loss` and its gradients on minibatches whose ratios straddle the
  clip band (tests/test_torch_ppo_grads.py's fixture), with the log-ratio
  clamp reached: each parameter block to GRAD_TOL of its largest gradient
  (float32 1e-4, chip_smoke.py's GRAD_REL_TOL: sums in another order, and
  log_std's gradient is one sum with cancellation, 1.6e-5 of itself here;
  float64 1e-12), the loss statistics to REL_TOL (1e-5 / 1e-12).  Advantages are normalised by the
  population std (JAX's `std`, ddof 0), which a test pins.
* Members: one backward of the sum of two members' losses gives each
  member the gradient of its own loss (1e-13 relative in float64: the
  batched products may sum in another order).
* One whole update at a reference-shaped tiny config (1 env x 256 steps,
  minibatch 64, shuffle block 1, SB3's row shuffle; 2 epochs, 8 Adam
  steps) from the same params and batch, the port given the permutations
  the JAX update derives from its key: params and Adam's first moment to
  PARAM_ATOL (float32: tests/test_torch_learner.py's 1e-6; float64
  1e-12), the second moment to rtol 1e-4 / 1e-9 (squared gradients near
  0), the metrics (loss included) to rtol 1e-4 / 1e-11 (means of the
  steps' losses).  In float64 the
  Adam scalars stay float64, as optax computes them for float64 params.
  With the learning-rate anneal, optax's linear schedule computes in
  float32 even under x64 (its step count is int32), where the port's is
  float64 rounded to the params' dtype: in float64 the params then differ
  by the step size's float32 rounding, 2^-24 of ~3e-4 a step (8 steps:
  ANNEALED_F64_ATOL 1e-9; 8.8e-11 seen), and the moments, of gradients
  taken there, by ~1e-7 of themselves (rtol 1e-6; 2.5e-7 seen).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.models.actor_critic import gaussian_log_prob as jlogp
from acas2d_tpu.ppo import learner as jlearner
from acas2d_tpu.ppo.config import PPOConfig as JPPOConfig
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.ppo.config import PPOConfig
from acas2d_tpu_torch.utils.params_io import from_jax_params

DTYPES = {"float32": (jnp.float32, torch.float32),
          "float64": (jnp.float64, torch.float64)}
REL_TOL = {"float32": 1e-5, "float64": 1e-12}
GRAD_TOL = {"float32": 1e-4, "float64": 1e-12}
PARAM_ATOL = {"float32": 1e-6, "float64": 1e-12}
NU_RTOL = {"float32": 1e-4, "float64": 1e-9}
ANNEALED_F64_ATOL = 1e-9
BLOCKS = [512, 64, 4096, 64, 64, 1] * 2 + [1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_of(jtree, dtype):
    m = ActorCritic().to(dtype)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jtree),
                                      dtype))
    return flatten(m)


def init_params(seed, jdt, log_std=0.0):
    p = JActorCritic().init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 8), jnp.float32))
    p = jax.tree.map(lambda x: x.astype(jdt), p)
    p["params"]["log_std"] = jnp.full_like(p["params"]["log_std"], log_std)
    return p


def minibatch(jparams, n, seed, jdt, spread=0.3):
    """Packed (n, 13) rows and JAX's six fields: actions around the
    policy's mean, old log-probs perturbed so that ratios straddle the
    clip band, a few far enough to reach the +-20 nat clamp."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 8)) * 0.3
    mean, log_std, value = JActorCritic().apply(jparams,
                                                jnp.asarray(obs, jdt))
    act = np.asarray(mean) + rng.normal(size=(n, 1)) * 0.7
    old_logp = np.asarray(jlogp(jnp.asarray(act, jdt), mean, log_std))
    old_logp = old_logp + rng.normal(size=n) * spread
    old_logp[:3] += np.array([30.0, -30.0, 25.0])
    adv = rng.normal(size=n) * 2 + 0.5
    ret = rng.normal(size=n)
    cols = [obs, act, old_logp[:, None], np.asarray(value)[:, None],
            adv[:, None], ret[:, None]]
    packed = np.concatenate(cols, axis=1)
    fields = tuple(jnp.asarray(x, jdt) for x in
                   (obs, act, old_logp, np.asarray(value), adv, ret))
    return packed, fields


def assert_blocks_close(got, want, tol, what):
    i = 0
    for k, n in enumerate(BLOCKS):
        a, b = got[i:i + n], want[i:i + n]
        scale = np.abs(b).max() + 1e-30
        assert np.abs(a - b).max() / scale < tol, (what, k)
        i += n


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ent_coef,normalize", [(0.0, True), (0.01, False)])
def test_loss_and_gradients_match_jax_grad(dtype, ent_coef, normalize):
    jdt, tdt = DTYPES[dtype]
    cfg = PPOConfig(ent_coef=ent_coef, normalize_advantage=normalize)
    jcfg = JPPOConfig(ent_coef=ent_coef, normalize_advantage=normalize)
    jparams = init_params(3, jdt, log_std=-0.3)
    packed, fields = minibatch(jparams, 192, 4, jdt)
    (jloss, jaux), jgrads = jax.value_and_grad(
        jlearner.ppo_loss, has_aux=True)(jparams, JActorCritic(), fields,
                                         jcfg)
    params = flat_of(jparams, tdt)
    data = torch.tensor(packed, dtype=tdt)
    loss, aux = learner.ppo_loss(params[None], data[None], cfg)
    grads, gaux = learner.ppo_loss_grads(params[None], data[None], cfg)
    assert grads.dtype == tdt and grads.shape == (1, params.numel())
    tol = REL_TOL[dtype]
    assert_blocks_close(grads[0].numpy(), flat_of(jgrads, tdt).numpy(),
                        GRAD_TOL[dtype], "grads")
    np.testing.assert_allclose(float(loss[0]), float(jloss), rtol=tol)
    np.testing.assert_allclose(float(gaux["loss"][0]), float(jloss),
                               rtol=tol)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k][0]), float(v), rtol=tol,
                                   atol=1e-30, err_msg=k)
    ratio_moved = float(aux["clip_fraction"][0])
    assert 0.05 < ratio_moved < 0.95, "both clip regimes should be exercised"


def test_advantages_are_normalised_by_the_population_std():
    """A minibatch of two advantages, +-1 around 0: the population std is 1
    (ddof 1 would give sqrt(2)), so the normalised advantages stay +-1 and
    at ratio 1 the policy loss is their mean's negative, 0; with ddof 1 the
    unclipped surrogate would be +-1/sqrt(2)."""
    cfg = PPOConfig(clip_range=10.0)
    model = ActorCritic().double()
    params = flatten(model)
    obs = torch.zeros(2, 8, dtype=torch.float64)
    mean, log_std, value = model(obs)
    act = torch.tensor([[0.4], [-0.2]], dtype=torch.float64)
    logp = learner.gaussian_log_prob(act, mean, log_std)
    data = torch.cat([obs, act, logp[:, None] + torch.tensor(
        [[0.5], [0.0]], dtype=torch.float64), value[:, None],
        torch.tensor([[1.0], [-1.0]], dtype=torch.float64),
        value[:, None]], 1)
    _, aux = learner.ppo_loss(params[None], data[None].detach(), cfg)
    # ratios exp(-0.5) and 1 times advantages +1 and -1 (ddof 0)
    want = -float((np.exp(-0.5) * 1.0 + 1.0 * -1.0) / 2)
    np.testing.assert_allclose(float(aux["policy_loss"][0]), want,
                               rtol=1e-7)


def test_one_backward_gives_each_member_its_own_gradient():
    jdt, tdt = DTYPES["float64"]
    cfg = PPOConfig(ent_coef=0.01)
    members = [init_params(s, jdt, log_std=-0.2 * s) for s in (5, 6)]
    params = torch.stack([flat_of(p, tdt) for p in members])
    data = torch.stack([torch.tensor(minibatch(p, 128, 10 + i, jdt)[0])
                        for i, p in enumerate(members)])
    grads, aux = learner.ppo_loss_grads(params, data, cfg)
    for m in range(2):
        g, a = learner.ppo_loss_grads(params[m:m + 1], data[m:m + 1], cfg)
        assert_blocks_close(grads[m].numpy(), g[0].numpy(), 1e-13,
                            f"member {m}")
        for k in a:
            np.testing.assert_allclose(float(aux[k][m]), float(a[k][0]),
                                       rtol=1e-13, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("anneal_lr", [False, True])
def test_autograd_update_matches_jax(dtype, anneal_lr):
    jdt, tdt = DTYPES[dtype]
    kw = dict(n_envs=1, n_steps=256, minibatch_size=64, n_epochs=2,
              total_timesteps=256 * 4, anneal_lr=anneal_lr)
    jcfg, cfg = JPPOConfig(**kw), PPOConfig(**kw)
    assert cfg.shuffle_block == 1 and not cfg.fused_update
    model = JActorCritic()
    jparams = init_params(1, jdt)
    packed, fields = minibatch(jparams, cfg.batch_size, 2, jdt, spread=0.1)
    obs, act, logp, vals, adv, ret = (np.asarray(x) for x in fields)
    T, B = cfg.n_steps, cfg.n_envs
    jbatch = jlearner.RolloutBatch(
        obs=jnp.asarray(obs.reshape(T, B, 8)),
        actions=jnp.asarray(act.reshape(T, B, 1)),
        log_probs=jnp.asarray(logp.reshape(T, B)),
        values=jnp.asarray(vals.reshape(T, B)),
        rewards=jnp.zeros((T, B), jdt), dones=jnp.zeros((T, B), bool))
    tx = jlearner.make_optimizer(jcfg)
    key = jax.random.PRNGKey(9)
    jnew, jopt, jm = jax.jit(lambda p, o: jlearner.ppo_update(
        model, tx, p, o, jbatch, jnp.asarray(adv.reshape(T, B)),
        jnp.asarray(ret.reshape(T, B)), key, jcfg))(jparams,
                                                     tx.init(jparams))
    perms = [np.asarray(jax.random.permutation(k, cfg.batch_size))
             for k in jax.random.split(key, cfg.n_epochs)]

    opt = learner.Optimizer(cfg)
    params0 = flat_of(jparams, tdt)
    batch = learner.RolloutBatch(
        obs=torch.tensor(obs.reshape(T, B, 8)),
        actions=torch.tensor(act.reshape(T, B, 1)),
        log_probs=torch.tensor(logp.reshape(T, B)),
        values=torch.tensor(vals.reshape(T, B)),
        rewards=torch.zeros(T, B, dtype=tdt),
        dones=torch.zeros(T, B, dtype=torch.bool))
    new, opt_state, m = learner.ppo_update(
        params0, opt.init(params0), opt, batch,
        torch.tensor(adv.reshape(T, B)), torch.tensor(ret.reshape(T, B)),
        cfg, perms=perms)

    assert new.dtype == opt_state.mu.dtype == tdt
    assert opt_state.count == cfg.n_epochs * cfg.n_minibatches == 8
    atol = (ANNEALED_F64_ATOL if anneal_lr and dtype == "float64"
            else PARAM_ATOL[dtype])
    assert float((new - params0).abs().max()) > 100 * atol
    np.testing.assert_allclose(new.numpy(), flat_of(jnew, tdt).numpy(),
                               rtol=0, atol=atol)
    adam = [s for s in jax.tree_util.tree_leaves(
        jopt, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")][0]
    np.testing.assert_allclose(opt_state.mu.numpy(),
                               flat_of(adam.mu, tdt).numpy(), rtol=0,
                               atol=atol)
    annealed_f64 = anneal_lr and dtype == "float64"
    np.testing.assert_allclose(opt_state.nu.numpy(),
                               flat_of(adam.nu, tdt).numpy(),
                               rtol=1e-6 if annealed_f64 else NU_RTOL[dtype],
                               atol=1e-30)
    assert set(m) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(
            float(m[k]), float(v),
            rtol=1e-6 if annealed_f64 else 10 * REL_TOL[dtype], atol=1e-30,
            err_msg=k)


def test_float64_adam_scalars_stay_float64():
    """optax's bias corrections for float64 params are float64: the port's
    scalars are the float64 values, not their float32 roundings."""
    opt = learner.Optimizer(dataclasses.replace(PPOConfig(),
                                                anneal_lr=True))
    s64 = opt.scalars(0, 3, torch.float64)
    s32 = opt.scalars(0, 3)
    assert s64.dtype == torch.float64 and s32.dtype == torch.float32
    np.testing.assert_array_equal(
        s64[:, 0].numpy(), 1 - 0.9 ** np.arange(1, 4))
    assert not torch.equal(s64, s32.double())
