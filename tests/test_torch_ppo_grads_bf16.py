"""The bf16 variant of the port's PPO minibatch gradient (plain version,
ops/ppo_grads.py with bf16=True) vs the Pallas kernel's bf16 path
(`acas2d_tpu/ops/pallas_update.py:ppo_minibatch_grads(..., bf16=True)` and,
for a population, `vmap(ppo_minibatch_grads_packed, bf16=True)`) in
interpret mode, on minibatches whose ratios straddle the clip band (the
fixtures of tests/test_torch_ppo_grads.py and
tests/test_torch_population_grads.py).

Tolerance: each parameter block to BF16_REL_TOL of its largest entry.  Both
sides round the same operands to bf16, but an activation or error that the
two sides compute an ulp apart in float32 can round to the neighbouring
bf16 value (2^-8 relative) and carry that into its products; the worst
block seen on these fixtures is 2e-4.  BF16_REL_TOL is five times that and
still below the bf16-vs-f32 deviation (~4e-3), so an f32 result fails it.
The bf16 gradients must deviate from the f32 ones, by more than 0 and by
less than 3e-2 of each block's scale plus 5e-6 (the JAX package's own bound,
tests/test_pallas_update.py:133-160).  The loss statistics come from the
float32 accumulator and agree to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.ops import pallas_update
from acas2d_tpu_torch.ops import ppo_grads
from acas2d_tpu_torch.utils.params_io import packed_to_flat, tree_to_flat

from test_torch_population_grads import _member_minibatch
from test_torch_ppo_grads import _flat_of, _minibatch

N = 1024
BF16_REL_TOL = 1e-3
SIZES = [512, 64, 4096, 64, 64, 1] * 2 + [1]
AUX_KEYS = ("policy_loss", "value_loss", "entropy", "approx_kl",
            "clip_fraction", "loss")


def _blocks(flat):
    return np.split(np.asarray(flat), np.cumsum(SIZES)[:-1], axis=-1)


def _assert_blocks_close(got, want, tol, what):
    for k, (a, b) in enumerate(zip(_blocks(got), _blocks(want))):
        scale = np.abs(b).max() + 1e-12
        assert np.abs(a - b).max() / scale < tol, (what, k)


@pytest.fixture(scope="module", params=[(0.0, 0), (0.01, 2)],
                ids=["ent0", "ent0.01"])
def solo(request):
    ent_coef, seed = request.param
    jparams = JActorCritic().init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, 8), jnp.float32))
    packed, _ = _minibatch(jparams, n=N, seed=seed + 1)
    kw = dict(clip_range=0.2, vf_coef=0.5, ent_coef=ent_coef)
    kgrads, kaux = pallas_update.ppo_minibatch_grads(
        jparams, jnp.asarray(packed), interpret=True, bf16=True, **kw)
    flat = _flat_of(jparams)
    data = torch.as_tensor(packed)
    g16, aux16 = ppo_grads.ppo_minibatch_grads(flat, data, bf16=True, **kw)
    g32, aux32 = ppo_grads.ppo_minibatch_grads(flat, data, **kw)
    return (_flat_of(kgrads).numpy(), {k: float(v) for k, v in kaux.items()},
            g16.numpy(), aux16, g32.numpy(), aux32)


def test_bf16_grads_match_pallas_bf16(solo):
    want, _, got, *_ = solo
    _assert_blocks_close(got, want, BF16_REL_TOL, "solo bf16")


def test_bf16_deviates_from_f32_within_the_envelope(solo):
    _, _, g16, _, g32, _ = solo
    devs = []
    for a, b in zip(_blocks(g16), _blocks(g32)):
        scale = np.abs(b).max() + 1e-12
        assert np.abs(a - b).max() < 3e-2 * scale + 5e-6
        devs.append(np.abs(a - b).max() / scale)
    # the rounding shows in every weight block of both towers
    assert min(devs[k] for k in (0, 2, 4, 6, 8, 10)) > 1e-4


def test_bf16_aux_matches_pallas_and_f32(solo):
    _, kaux, _, aux16, _, aux32 = solo
    assert 0.1 < kaux["clip_fraction"] < 0.9
    for k in AUX_KEYS:
        np.testing.assert_allclose(float(aux16[k]), kaux[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    # the forward's bf16 rounding moves the losses a little, not the entropy
    np.testing.assert_allclose(float(aux16["loss"]), float(aux32["loss"]),
                               rtol=5e-3)
    assert float(aux16["entropy"]) == float(aux32["entropy"])


def test_bf16_member_grads_match_vmapped_packed_kernel():
    P = 2
    members = [JActorCritic().init(jax.random.PRNGKey(20 + m),
                                   jnp.zeros((1, 8), jnp.float32))
               for m in range(P)]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *members)
    data = np.stack([_member_minibatch(p, seed=m + 1)
                     for m, p in enumerate(members)])
    kw = dict(clip_range=0.2, vf_coef=0.5, ent_coef=0.0)
    packed = jax.vmap(pallas_update.pack_params_tree)(stacked)
    jgrads, jaux = jax.vmap(
        lambda p, d: pallas_update.ppo_minibatch_grads_packed(
            p, d, interpret=True, bf16=True, **kw))(packed, jnp.asarray(data))
    want, off = packed_to_flat(jax.tree.map(np.asarray, jgrads))
    assert np.all(off == 0.0)
    params = tree_to_flat(jax.tree.map(np.asarray, stacked), n_lead=1)
    tgrads, taux = ppo_grads.ppo_minibatch_grads_members(
        params, torch.as_tensor(data), bf16=True, **kw)
    for m in range(P):
        _assert_blocks_close(tgrads[m].numpy(), want[m], BF16_REL_TOL,
                             f"member {m}")
        # each member's row is its solo bf16 call
        g, _ = ppo_grads.ppo_minibatch_grads(params[m],
                                             torch.as_tensor(data[m]),
                                             bf16=True, **kw)
        assert torch.equal(g, tgrads[m])
    for k in AUX_KEYS:
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
