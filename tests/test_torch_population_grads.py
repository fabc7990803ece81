"""The port's member-batched PPO gradient (plain version,
ops/ppo_grads.py:ppo_minibatch_grads_members) vs the JAX population's
packed-update gradient, `jax.vmap(pallas_update.ppo_minibatch_grads_packed)`
in interpret mode (`acas2d_tpu/ppo/population.py:76-94`), float32 on the
CPU: P = 2 members with their own weights and minibatches (N = 1024 rows),
ratios straddling the clip band.

The packed 7-leaf gradient tree is converted to the flat layout
(`params_io.packed_to_flat`); its off-diagonal packing entries, which the
flat layout has no place for, must be exactly zero (they are masked).
Tolerances are the solo test's (tests/test_torch_ppo_grads.py): each
parameter block to 1e-5 of its largest gradient, the loss statistics of
each member to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.models.actor_critic import gaussian_log_prob as jlogp
from acas2d_tpu.ops import pallas_update
from acas2d_tpu_torch.ops import ppo_grads
from acas2d_tpu_torch.utils.params_io import packed_to_flat, tree_to_flat

P, N = 2, 1024
REL_TOL = 1e-5
SIZES = [512, 64, 4096, 64, 64, 1] * 2 + [1]


def _member_minibatch(jparams, seed):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(N, 8)).astype(np.float32) * 0.3
    mean, log_std, value = JActorCritic().apply(jparams, jnp.asarray(obs))
    act = np.asarray(mean) + rng.normal(size=(N, 1)).astype(np.float32) * 0.7
    old_logp = np.asarray(jlogp(jnp.asarray(act), mean, log_std))
    old_logp = old_logp + rng.normal(size=N).astype(np.float32) * 0.3
    adv = rng.normal(size=N).astype(np.float32) * (1.0 + seed) + seed
    ret = rng.normal(size=N).astype(np.float32)
    return np.concatenate([obs, act, old_logp[:, None],
                           np.asarray(value)[:, None], adv[:, None],
                           ret[:, None]], axis=1).astype(np.float32)


@pytest.fixture(scope="module", params=[0.0, 0.01], ids=["ent0", "ent0.01"])
def grads(request):
    ent_coef = request.param
    model = JActorCritic()
    members = [model.init(jax.random.PRNGKey(20 + m),
                          jnp.zeros((1, 8), jnp.float32)) for m in range(P)]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *members)
    data = np.stack([_member_minibatch(p, seed=m + 1)
                     for m, p in enumerate(members)])
    kw = dict(clip_range=0.2, vf_coef=0.5, ent_coef=ent_coef)
    packed = jax.vmap(pallas_update.pack_params_tree)(stacked)
    jgrads, jaux = jax.vmap(lambda p, d: pallas_update.ppo_minibatch_grads_packed(
        p, d, interpret=True, **kw))(packed, jnp.asarray(data))
    params = tree_to_flat(jax.tree.map(np.asarray, stacked), n_lead=1)
    tgrads, taux = ppo_grads.ppo_minibatch_grads_members(
        params, torch.as_tensor(data), **kw)
    return (jax.tree.map(np.asarray, jgrads),
            {k: np.asarray(v) for k, v in jaux.items()},
            tgrads, taux, params, data, kw)


def test_member_grads_match_vmapped_packed_kernel(grads):
    jgrads, jaux, tgrads, taux, *_ = grads
    want, off = packed_to_flat(jgrads)
    assert want.shape == tuple(tgrads.shape) == (P, 9603)
    assert off.shape[0] == P and np.all(off == 0.0), "masked entries"
    got = tgrads.numpy()
    for m in range(P):
        i = 0
        for k, n in enumerate(SIZES):
            a, b = got[m, i:i + n], want[m, i:i + n]
            scale = np.abs(b).max() + 1e-12
            assert np.abs(a - b).max() / scale < REL_TOL, (m, k)
            i += n


def test_member_aux_matches_per_member(grads):
    jgrads, jaux, tgrads, taux, *_ = grads
    assert 0.1 < float(np.mean(jaux["clip_fraction"])) < 0.9
    for k in ("policy_loss", "value_loss", "entropy", "approx_kl",
              "clip_fraction", "loss"):
        assert taux[k].shape == (P,), k
        np.testing.assert_allclose(taux[k].numpy(), jaux[k], rtol=REL_TOL,
                                   atol=1e-7, err_msg=k)


def test_members_equal_solo_calls(grads):
    """Each member's row is the solo gradient of its own minibatch, with
    the advantages normalised over that member's rows only."""
    _, _, tgrads, taux, params, data, kw = grads
    for m in range(P):
        g, aux = ppo_grads.ppo_minibatch_grads(params[m],
                                               torch.as_tensor(data[m]), **kw)
        assert torch.equal(g, tgrads[m])
        for k, v in aux.items():
            assert torch.equal(v, taux[k][m]), k


def test_normalize_adv_column_is_per_member():
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(3, 64, 13)),
                        dtype=torch.float32) * torch.tensor([1.0, 5.0, 0.1]
                                                            )[:, None, None]
    got = ppo_grads.normalize_adv_column(x)
    for m in range(3):
        want = pallas_update.normalize_adv_column(jnp.asarray(x[m].numpy()))
        np.testing.assert_allclose(got[m].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("P_,n,per_tower", [(1, 65536, 128), (1, 1000, 16),
                                            (32, 32768, 4), (16, 32768, 8),
                                            (256, 1024, 1)])
def test_launch_blocks_bound_the_partials(P_, n, per_tower):
    """A solo launch keeps its 128 blocks per tower; a member launch shares
    about 256 first-pass blocks over all members, so the partials that the
    second pass reads stay ~5 MB however large the population."""
    rows, nblocks = ppo_grads.launch_blocks(P_, n)
    assert rows % ppo_grads.TILE_ROWS == 0
    assert nblocks == per_tower and (nblocks - 1) * rows < n <= nblocks * rows
    partial_bytes = 4 * P_ * 2 * nblocks * (4801 + 5)
    assert partial_bytes <= 4 * 2 * max(256, 2 * P_) * (4801 + 5)
