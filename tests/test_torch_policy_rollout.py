"""The port's fused rollout (plain version, ops/policy_rollout.py) vs the
Pallas kernel `acas2d_tpu/ops/pallas_policy.py:fused_policy_rollout` in
interpret mode: B = 2048 envs (two Pallas programs enter the hash), two
chunks of K = 8 steps joined by `step_offset`, the same weights carried
across with `from_jax_params`, episodes part-way through so that timeouts
respawn inside the chunks.

The RNG streams are the same, so every sample and respawn matches.  The
MLP's dot products sum in another order than XLA's, so continuous outputs
agree to float32 rounding carried through 16 closed-loop steps: ATOL below,
relative to each field's scale.  Done flags, outcomes and episode lengths
must match exactly.

Two observation features are angles over 360 degrees (heading, bearing to
the goal), which wrap from ~1 to 0.  An env flying along the goal line has
a bearing of ~0, and an ulp of position decides the side of the wrap, so
those features are compared modulo 1.  Once an env's policy has seen such a
wrapped input its action legitimately differs; its later continuous values
are excluded, and such envs must stay rare (MAX_WRAPPED).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu.config import DEFAULT_PARAMS as JP
from acas2d_tpu.envs import vector as jvector
from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.ops import pallas_policy
from acas2d_tpu_torch.config import DEFAULT_PARAMS as TP
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ops.policy_rollout import fused_policy_rollout
from acas2d_tpu_torch.utils.params_io import from_jax_params

B, K, SEED = 2 * pallas_policy.E, 8, 3
ATOL = 2e-6       # x max|field|: a few float32 ulps after 16 steps
# the shaped reward's 4th powers and the CPA distance's sine of a
# difference of angles turn an ulp of geometry into ~1e-5 of reward
# per step; the episode sums carry up to 2K of these
REWARD_ATOL = 5e-5
REWARD_FIELDS = ("rewards",)
SUM_FIELDS = ("episode_return", "total_reward")
ANGLE_FEATURES = (1, 4)   # obs features that are angles / 360
MAX_WRAPPED = 0.01        # share of envs that may see a wrapped angle
KEYS = ("px", "py", "psi", "tx", "ty", "tv", "tpsi", "steps", "total_reward")


@pytest.fixture(scope="module")
def runs():
    jmodel = JActorCritic()
    jp = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.float32))
    # sigma ~0.6 so that actions vary and some clip
    jp = {"params": {**jp["params"],
                     "log_std": jnp.full((1,), -0.5, jnp.float32)}}
    s, obs = jvector.reset_batch(jax.random.PRNGKey(7), B, JP, jnp.float32)
    steps = np.random.default_rng(0).integers(1, JP.max_steps + 1, B)
    state0 = dict(px=s.px, py=s.py, psi=s.ppsi, tx=s.tx[:, 0], ty=s.ty[:, 0],
                  tv=s.tv[:, 0], tpsi=s.tpsi[:, 0],
                  steps=steps.astype(np.int32),
                  total_reward=np.zeros(B, np.float32))
    state0 = {k: np.asarray(v) for k, v in state0.items()}
    obs0 = np.asarray(obs, np.float32)

    jst, jobs, jbufs = state0, obs0, []
    for chunk in range(2):
        jst, buf = pallas_policy.fused_policy_rollout(
            *(jnp.asarray(jst[k]) for k in KEYS), jnp.asarray(jobs), jp,
            seed=SEED, step_offset=chunk * K, K=K, params=JP, interpret=True)
        jst = {k: np.asarray(v) for k, v in jst.items()}
        jobs = jst["obs"]
        jbufs.append({k: np.asarray(v) for k, v in buf.items()})

    model = ActorCritic()
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    params = flatten(model)
    tst = {k: torch.as_tensor(v) for k, v in state0.items()}
    tobs, tbufs = torch.as_tensor(obs0), []
    for chunk in range(2):
        tst, buf = fused_policy_rollout(tst, tobs, params, SEED, chunk * K, K,
                                        TP)
        tobs = tst["obs"]
        tbufs.append({k: v.numpy() for k, v in buf.items()})
    tst = {k: v.numpy() for k, v in tst.items()}
    return jst, jbufs, tst, tbufs


def _close(got, want, name, field=""):
    atol = (REWARD_ATOL if field in REWARD_FIELDS
            else 2 * K * REWARD_ATOL if field in SUM_FIELDS
            else ATOL * max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


def _wrap_dist(a, b):
    d = np.abs(a - b) % 1.0
    return np.minimum(d, 1.0 - d)


def test_buffers_match(runs):
    jst, jbufs, tst, tbufs = runs
    total_dones = 0
    wrapped = np.zeros(B, bool)           # envs that saw a wrapped angle
    for chunk in range(2):
        jb, tb = jbufs[chunk], tbufs[chunk]
        assert set(jb) == set(tb)
        for k in ("dones", "outcome", "episode_steps"):
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert tb["episode_steps"].dtype == tb["outcome"].dtype == np.int32
        for t in range(K):
            to, jo = tb["obs"][t], jb["obs"][t]
            for f in ANGLE_FEATURES:
                np.testing.assert_allclose(
                    _wrap_dist(to[~wrapped, f], jo[~wrapped, f]), 0,
                    atol=ATOL, err_msg=f"angle {f}")
            for f in ANGLE_FEATURES:     # the policy sees this step's obs
                wrapped |= np.abs(to[:, f] - jo[:, f]) > 0.5
            keep = ~wrapped
            other = [f for f in range(8) if f not in ANGLE_FEATURES]
            _close(to[keep][:, other], jo[keep][:, other], f"obs t={t}")
            for k in ("actions", "log_probs", "values", "rewards",
                      "episode_return"):
                _close(tb[k][t][keep], jb[k][t][keep], f"chunk {chunk} {k}",
                       k)
        total_dones += int(jb["dones"].sum())
    assert total_dones > 0, "the fixture should exercise respawns"
    assert wrapped.mean() <= MAX_WRAPPED, wrapped.mean()


def test_final_state_matches(runs):
    jst, jbufs, tst, tbufs = runs
    np.testing.assert_array_equal(tst["steps"], jst["steps"])
    seen = [b["obs"][..., list(ANGLE_FEATURES)] for b in tbufs + jbufs]
    wrapped = (np.abs(seen[0] - seen[2]) > 0.5).any(axis=(0, 2)) | (
        np.abs(seen[1] - seen[3]) > 0.5).any(axis=(0, 2))
    keep = ~wrapped
    for k in ("px", "py", "psi", "tx", "ty", "tv", "tpsi", "total_reward",
              "pa_lat"):
        _close(tst[k][keep], jst[k][keep], k, k)
    for f in range(8):
        a, b = tst["obs"][keep, f], jst["obs"][keep, f]
        if f in ANGLE_FEATURES:
            np.testing.assert_allclose(_wrap_dist(a, b), 0, atol=ATOL)
        else:
            _close(a, b, f"obs {f}")
