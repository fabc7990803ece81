"""The epoch's advantage normalisation (`ops/ppo_grads.py:
normalize_adv_minibatches`, called once an epoch by `learner.
ppo_update_members`) on the CPU, where it runs its plain version.

SB3 normalises each minibatch's advantages over its rows before the step's
gradients.  The update now does that for every minibatch of an epoch at
once, on the epoch's minibatch-major copy, and the steps normalise nothing.
On the CPU the plain version runs `normalize_adv_column`'s torch ops a
step's (P, M, 13) slice at a time, so everything here holds bit for bit:
the normalised minibatches, and the params, Adam moments and metrics of
whole updates against a loop written here that normalises at every step,
as the update did before.  (A reduction over the whole epoch view would
not: torch's CPU std of one float64 row sums in another order than that of
several, and its results differ by up to 15 ulps.)  The kernel the card
runs is held to a float64 yardstick in tests/test_torch_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acas2d_tpu.ops import pallas_update
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ops import ppo_grads
from acas2d_tpu_torch.ppo import learner, population
from acas2d_tpu_torch.ppo.config import PPOConfig

# (minibatches, members, rows) of each training cell's form, cut down:
# solo_tpu 4 x 1, solo32k_x4 64 x 1 (cut to 16), pop32 4 x 32 (cut to 3)
FORMS = [(4, 1, 512), (16, 1, 256), (4, 3, 256)]


def _epoch(shape, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, 13, generator=gen, dtype=torch.float64)
    x[..., 11] = x[..., 11] * 2.0 + 0.3
    x[0, 0, :, 11] = 1e4 + torch.randn(shape[2], generator=gen,
                                       dtype=torch.float64) * 1e-2
    x[-1, -1, :, 11] = 3.0                      # std 0: the result is 0
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", FORMS, ids=["solo", "many", "members"])
def test_epoch_pass_equals_normalize_adv_column_step_by_step(shape, dtype):
    """Bit for bit what each step's `normalize_adv_column` gave, and the
    means and stds it used."""
    x = _epoch(shape, dtype)
    got = x.clone()
    stats = ppo_grads.normalize_adv_minibatches(got)
    for j in range(shape[0]):
        assert torch.equal(got[j], ppo_grads.normalize_adv_column(x[j]))
        adv = x[j][..., 11]
        assert torch.equal(stats[j, :, 0], adv.mean(-1))
        assert torch.equal(stats[j, :, 1], adv.std(-1, correction=0))
    assert (got[-1, -1, :, 11] == 0).all()
    assert ppo_grads.normalize_adv_minibatches.launches == 0


def test_epoch_pass_matches_jax_per_minibatch():
    """Against the JAX package's `normalize_adv_column`, minibatch by
    minibatch and member by member."""
    x = _epoch((4, 3, 256))
    x[0, 0, :, 11] = x[1, 0, :, 11]             # no cancelling column here
    got = x.clone()
    ppo_grads.normalize_adv_minibatches(got)
    for j in range(4):
        for m in range(3):
            want = pallas_update.normalize_adv_column(
                jnp.asarray(x[j, m].numpy()))
            np.testing.assert_allclose(got[j, m].numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)


def test_epoch_pass_refuses_other_shapes():
    for bad in (torch.zeros(4, 64, 12), torch.zeros(13), torch.zeros(0, 13)):
        with pytest.raises(ValueError, match="M, 13"):
            ppo_grads.normalize_adv_minibatches(bad)


# --------------------------------------------------------------- updates

def _update_case(P, fused, normalize, dtype, seed=1):
    cfg = PPOConfig(n_envs=16, n_steps=64, minibatch_size=256, n_epochs=3,
                    fused_update=fused, normalize_advantage=normalize,
                    total_timesteps=1024)
    gen = torch.Generator().manual_seed(seed)
    params = torch.stack([flatten(ActorCritic(generator=gen))
                          for _ in range(P)]).to(dtype)
    data = torch.randn(P, cfg.batch_size, 13, generator=gen, dtype=dtype)
    data[..., :11] *= 0.5
    data[..., 11] = data[..., 11] * 3.0 + 0.7
    perms = learner.draw_perms(
        cfg, [torch.Generator().manual_seed(5 + m) for m in range(P)],
        cfg.batch_size // cfg.shuffle_block)
    return cfg, params, data, perms


def _per_step_update(params, opt_state, optimizer, data, cfg, perms):
    """The update as it ran before the epoch pass: each epoch gathered
    member-major, each step normalising its own minibatch."""
    P, N = data.shape[:2]
    block = cfg.shuffle_block
    blocks = data.view(P, N // block, block, 13)
    members = torch.arange(P)[:, None]
    scalars = optimizer.scalars(opt_state.count,
                                cfg.n_epochs * cfg.n_minibatches,
                                params.dtype)
    aux_all = {}
    for epoch in range(cfg.n_epochs):
        mbs = blocks[members, perms[epoch]].view(
            P, cfg.n_minibatches, cfg.minibatch_size, 13)
        for j in range(cfg.n_minibatches):
            if cfg.fused_update:
                grads, aux = ppo_grads.ppo_minibatch_grads_members(
                    params, mbs[:, j], clip_range=cfg.clip_range,
                    vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef,
                    normalize_advantage=cfg.normalize_advantage)
            else:
                grads, aux = learner.ppo_loss_grads(params, mbs[:, j], cfg)
            updates, opt_state = optimizer.update(
                grads, opt_state, scalars[epoch * cfg.n_minibatches + j])
            params = params + updates
            for k, v in aux.items():
                aux_all.setdefault(k, []).append(v)
    return params, opt_state, {k: torch.stack(v, -1).mean(-1)
                               for k, v in aux_all.items()}


@pytest.mark.parametrize("P,fused,normalize,dtype", [
    (1, True, True, torch.float32), (3, True, True, torch.float32),
    (1, False, True, torch.float32), (1, False, True, torch.float64),
    (3, False, True, torch.float64), (1, True, False, torch.float32),
    (3, False, False, torch.float32)],
    ids=["fused_solo", "fused_members", "autograd_solo", "autograd_f64",
         "autograd_members_f64", "fused_off", "autograd_off"])
def test_update_equals_a_per_step_normalising_loop(P, fused, normalize,
                                                   dtype):
    """Params, Adam moments and every metric bit for bit."""
    cfg, params, data, perms = _update_case(P, fused, normalize, dtype)
    optimizer = learner.Optimizer(cfg)
    state = optimizer.init(params)
    got = learner.ppo_update_members(params, state, optimizer, data.clone(),
                                     cfg, perms)
    want = _per_step_update(params, state, optimizer, data.clone(), cfg,
                            learner.as_perms(perms, P, data.shape[1]))
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].mu, want[1].mu)
    assert torch.equal(got[1].nu, want[1].nu)
    assert got[1].count == want[1].count
    assert set(got[2]) == set(want[2])
    for k in got[2]:
        assert torch.equal(got[2][k], want[2][k]), k


@pytest.mark.parametrize("P", [1, 3])
def test_minibatch_major_gather_gives_each_step_its_rows(P):
    """Each step receives, as a contiguous (P, M, 13) tensor, exactly the
    rows the member-major gather gave it; the raw data is not changed."""
    cfg, params, data, perms = _update_case(P, True, False, torch.float32)
    cfg = dataclasses.replace(cfg, shuffle_block_size=8)
    perms = learner.draw_perms(cfg, [torch.Generator().manual_seed(9)] * P,
                               cfg.batch_size // 8)
    seen = []

    def grads_fn(params, mb):
        seen.append((mb.is_contiguous(), mb.clone()))
        return torch.zeros_like(params), {"loss": torch.zeros(P)}

    optimizer = learner.Optimizer(cfg)
    raw = data.clone()
    learner.ppo_update_members(params, optimizer.init(params), optimizer,
                               data, cfg, perms, grads_fn=grads_fn)
    assert torch.equal(data, raw)
    blocks = data.view(P, cfg.batch_size // 8, 8, 13)
    members = torch.arange(P)[:, None]
    want = [blocks[members, perms[e]].view(
        P, cfg.n_minibatches, cfg.minibatch_size, 13)[:, j]
        for e in range(cfg.n_epochs) for j in range(cfg.n_minibatches)]
    assert len(seen) == len(want)
    for (contiguous, mb), w in zip(seen, want):
        assert contiguous and torch.equal(mb, w)


# ------------------------------------------------------ counts an iteration

TINY = ["--preset", "tpu", "--device", "cpu", "--n-envs", "64", "--n-steps",
        "16", "--minibatch-size", "256", "--n-epochs", "3", "--fused-rollout",
        "--fused-update", "--total-steps", str(64 * 16 * 4)]


@pytest.mark.parametrize("pop", [0, 2], ids=["solo", "population"])
@pytest.mark.parametrize("normalize", [True, False], ids=["on", "off"])
def test_epoch_pass_runs_once_an_epoch(monkeypatch, pop, normalize):
    """An iteration runs the epoch pass n_epochs times (members and
    minibatches all at once), and never with the normalisation off; its
    launch counter, a `learner.KERNELS` entry, stays 0 on the CPU."""
    from acas2d_tpu_torch import train
    cfg = dataclasses.replace(train.build_config(train.parse_args(TINY)),
                              normalize_advantage=normalize)
    calls = []
    real = learner.normalize_adv_minibatches

    def counted(mbs):
        calls.append(tuple(mbs.shape))
        return real(mbs)

    monkeypatch.setattr(learner, "normalize_adv_minibatches", counted)
    assert learner.KERNELS["adv_norm"] is ppo_grads.normalize_adv_minibatches
    n0 = ppo_grads.normalize_adv_minibatches.launches
    if pop:
        state = population.init_population(cfg, DEFAULT_PARAMS, pop, "cpu")
        step = population.make_population_step(cfg, DEFAULT_PARAMS, "cpu")
    else:
        state = learner.init_train_state(cfg, DEFAULT_PARAMS, "cpu")
        step = learner.make_train_step(cfg, DEFAULT_PARAMS, "cpu")
    for _ in range(2):
        state, _ = step(state)
    want = (cfg.n_minibatches, max(pop, 1), cfg.minibatch_size, 13)
    assert calls == [want] * (2 * cfg.n_epochs if normalize else 0)
    assert ppo_grads.normalize_adv_minibatches.launches == n0
