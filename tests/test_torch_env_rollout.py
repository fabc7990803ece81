"""The port's fused env-only rollout (plain version, ops/env_rollout.py) vs
the Pallas kernel `acas2d_tpu/ops/pallas_step.py:fused_rollout` in
interpret mode, and vs the port's general engine (`envs/core.py`).

Against Pallas: B = 2048 envs (two Pallas programs enter the hash), T = 64
steps, from mid-episode states so that timeouts, goals and collisions
respawn inside the window; random actions without and with the observation
checksum, and forced-zero actions with it.  The RNG streams are the same,
so every action and respawn matches.  The transcendentals of XLA's CPU
backend and of torch's differ by an ulp, and XLA contracts multiply-adds,
so floats agree to float32 rounding:
  * state fields to POS_RTOL of each field's largest magnitude (an ulp per
    step of a ~1e3 px position, over T steps);
  * reward and obs sums to SUM_ATOL_PER_STEP per step: the shaped reward's
    4th powers and the CPA distance's sine of a difference of angles turn
    an ulp of geometry into ~1e-5 per step.
Integer outputs are equal.  An ulp can still flip a float32 threshold
(collision or goal distance) and end one env's episode a step earlier; its
later state then differs.  At most MAX_DIVERGED of the envs may do so, and
their floats are left out; in the seeded fixture none does.

Against the engine, under forced-zero actions from fresh spawns (no episode
ends in 64 steps), in the shape of tests/test_pallas.py:42-63, 138-166:
step counters exact, positions to 2e-2 px, reward sums to 2e-3 + 2e-3 x
scale, and the obs checksum to the engine's summed observations.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu.config import DEFAULT_PARAMS as JP
from acas2d_tpu.envs import vector as jvector
from acas2d_tpu.ops import pallas_step
from acas2d_tpu_torch.config import DEFAULT_PARAMS as TP
from acas2d_tpu_torch.envs import vector
from acas2d_tpu_torch.ops import env_rollout
from acas2d_tpu_torch.ops.env_rollout import STATE_KEYS, fused_rollout

B, T, SEED = 2 * pallas_step.LANES, 64, 3
POS_RTOL = 1e-5
SUM_ATOL_PER_STEP = 5e-5
MAX_DIVERGED = 0.001
INT_KEYS = ("steps", "episodes", "goals", "collisions")


def _mid_episode_state():
    """Fresh JAX spawns flown part-way by the plain rollout: the first half
    of the envs 320 steps (random-action collisions come at ~320-450), the
    second 576 (goals at ~576-640); every third env's step counter is then
    moved to 940-1000 so that timeouts occur too."""
    s, _ = jvector.reset_batch(jax.random.PRNGKey(7), B, JP, jnp.float32)
    st = {k: torch.as_tensor(np.array(v))
          for k, v in env_rollout.flat_state(s).items()}
    half = B // 2
    parts = [fused_rollout({k: v[sl] for k, v in st.items()}, 11, n, TP)[0]
             for sl, n in ((slice(0, half), 320), (slice(half, B), 576))]
    st = {k: torch.cat([p[k] for p in parts]).numpy() for k in STATE_KEYS}
    late = np.random.default_rng(0).integers(940, JP.max_steps + 1, B)
    st["steps"][::3] = late[::3]
    return st


@pytest.fixture(scope="module")
def state0():
    return _mid_episode_state()


def _both(state0, **kw):
    jst, jstats = pallas_step.fused_rollout(
        *(jnp.asarray(state0[k]) for k in STATE_KEYS), seed=SEED, T=T,
        params=JP, interpret=True, **kw)
    tst, tstats = fused_rollout({k: torch.as_tensor(v)
                                 for k, v in state0.items()}, SEED, T, TP,
                                **kw)
    want = {k: np.asarray(v) for k, v in {**jst, **jstats}.items()}
    got = {k: v.numpy() for k, v in {**tst, **tstats}.items()}
    return got, want


@pytest.mark.parametrize("kw", [dict(), dict(with_obs=True),
                                dict(zero_actions=True, with_obs=True)],
                         ids=["random", "random_obs", "zero_obs"])
def test_plain_matches_pallas_interpret(state0, kw):
    got, want = _both(state0, **kw)
    assert set(got) == set(want)
    diverged = np.zeros(B, bool)
    for k in INT_KEYS:
        assert got[k].dtype == want[k].dtype == np.int32, k
        diverged |= got[k] != want[k]
    assert diverged.mean() <= MAX_DIVERGED, diverged.sum()
    keep = ~diverged
    # every kind of episode end occurs in the window
    assert int(want["goals"].sum()) > 10 and int(want["collisions"].sum()) > 10
    assert int(want["episodes"].sum()) > int(want["goals"].sum()
                                             + want["collisions"].sum()) + 10
    for k in ("px", "py", "psi", "tx", "ty", "tv", "tpsi"):
        w = want[k]
        np.testing.assert_allclose(got[k][keep], w[keep], rtol=0,
                                   atol=POS_RTOL * np.abs(w).max(), err_msg=k)
    for k in ("total_reward", "reward_sum", "obs_sum"):
        np.testing.assert_allclose(got[k][keep], want[k][keep], rtol=0,
                                   atol=T * SUM_ATOL_PER_STEP, err_msg=k)
    if not kw.get("with_obs"):
        assert float(np.abs(got["obs_sum"]).max()) == 0.0


def _engine_zero_actions(n, steps):
    """The port's general engine under zero actions: (final state, summed
    rewards, summed observations), float32 on the CPU."""
    gen = torch.Generator().manual_seed(42)
    s, _ = vector.reset_batch(n, TP, gen, torch.float32, "cpu")
    s0 = s
    rsum = torch.zeros(n)
    osum = torch.zeros(n)
    for _ in range(steps):
        s, out = vector.step_autoreset_batch(s, torch.zeros(n), TP, gen)
        rsum = rsum + out.reward
        osum = osum + out.obs.sum(-1)
    return s0, s, rsum, osum


def test_zero_actions_match_the_engine():
    n = pallas_step.LANES
    s0, s, rsum, osum = _engine_zero_actions(n, T)
    flat = env_rollout.flat_state(s0)
    st, stats = fused_rollout(flat, 7, T, TP, zero_actions=True,
                              with_obs=True)
    assert torch.equal(st["steps"], s.steps)
    assert int(stats["episodes"].sum()) == 0       # no ends in the window
    for name, a, b in (("px", s.px, st["px"]), ("py", s.py, st["py"]),
                       ("psi", s.ppsi, st["psi"]),
                       ("tx", s.tx[:, 0], st["tx"]),
                       ("ty", s.ty[:, 0], st["ty"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=2e-2,
                                   err_msg=name)
    np.testing.assert_allclose(stats["reward_sum"].numpy(), rsum.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(stats["obs_sum"].numpy(), osum.numpy(),
                               rtol=1e-5, atol=2e-4)
    _, stats0 = fused_rollout(flat, 7, T, TP, zero_actions=True)
    assert float(stats0["obs_sum"].abs().max()) == 0.0


def test_batch_and_params_are_checked(state0):
    import dataclasses
    small = {k: torch.as_tensor(v[:1000]) for k, v in state0.items()}
    with pytest.raises(ValueError, match="multiple of 1024"):
        fused_rollout(small, SEED, 2, TP)
    full = {k: torch.as_tensor(v) for k, v in state0.items()}
    for bad in (dict(max_traffic=2), dict(airspeed_factor_min=0.5),
                dict(bug_compat=False)):
        with pytest.raises(ValueError):
            fused_rollout(full, SEED, 2, dataclasses.replace(TP, **bad))
    n0 = fused_rollout.launches
    with pytest.raises(ValueError, match="CUDA"):
        env_rollout._env_rollout_cuda({}, 0, full, SEED, 2, False, False)
    assert fused_rollout.launches == n0


def _perturbed(state0, how):
    """The plain version's outputs after 4 steps and a copy changed as
    `how` says: (got, want)."""
    st = {k: torch.as_tensor(v) for k, v in state0.items()}
    fs, fstats = fused_rollout(st, SEED, 4, TP, with_obs=True)
    want = {**fs, **fstats}
    got = {k: v.clone() for k, v in want.items()}
    if how == "heading_at_wrap":
        want["psi"][0], got["psi"][0] = 0.0, 360.0
    elif how == "heading_off_wrap":
        want["psi"][0], got["psi"][0] = 180.0, 180.0 + 360.0
    elif how == "obs_wrap":
        got["obs_sum"][:2] += 1.0
    elif how == "obs_wrap_3":
        got["obs_sum"][:3] += 1.0
    elif how == "episode_end":
        got["steps"][5] += 1
    elif how == "position":
        got["px"][7] += 1.0
    elif how == "reward_branch":
        got["reward_sum"][9] += 0.4
        got["total_reward"][9] += 0.4
    elif how == "reward_off":
        got["reward_sum"][9] += 1.5
    elif how == "reward_branch_position":
        got["reward_sum"][9] += 0.4
        got["px"][9] += 1.0
    elif how == "reward_branch_obs":
        got["reward_sum"][9] += 0.4
        got["obs_sum"][9] += 0.5
    elif how == "reward_branch_total":
        got["reward_sum"][9] += 0.4
        got["total_reward"][9] += 1.5
    return got, want


@pytest.mark.parametrize("how,n_flipped,failed", [
    ("none", 0, []),
    ("heading_at_wrap", 0, []),
    ("heading_off_wrap", 0, ["psi"]),
    ("obs_wrap", 2, []),
    ("obs_wrap_3", 3, ["3 envs flipped"]),
    ("episode_end", 1, []),
    ("position", 0, ["px"]),
    ("reward_branch", 1, []),
    ("reward_off", 0, ["reward_sum"]),
    ("reward_branch_position", 1, ["px"]),
    ("reward_branch_obs", 1, ["obs_sum"]),
    ("reward_branch_total", 1, ["total_reward of a reward flip"]),
])
def test_agreement_rule(state0, how, n_flipped, failed):
    """`env_rollout.agreement`, the rule the card holds the kernel to: an
    integer, a whole-number obs_sum or an at most unit reward_sum
    difference is a threshold flip (at most 0.1% of the envs, 2 of 2048),
    the heading differs by 360 only at its wrap, and a position by no more
    than its ulps.  A reward flip frees only the reward sums: that env's
    state and obs_sum stay held."""
    got, want = _perturbed(state0, how)
    flipped, errs, bad = env_rollout.agreement(got, want, 4)
    assert len(flipped) == n_flipped
    assert bad == failed
    if not bad:
        assert set(errs) == {"px", "py", "psi", "tx", "ty", "tv", "tpsi",
                             "total_reward", "reward_sum", "obs_sum"}


def test_seed_is_its_int32_bit_pattern(state0):
    """A seed and the same seed plus 2^32 draw the same stream, as the
    kernel takes the seed's int32 bit pattern."""
    st = {k: torch.as_tensor(v) for k, v in state0.items()}
    a, sa = fused_rollout(st, -5, 4, TP)
    b, sb = fused_rollout(st, 2 ** 32 - 5, 4, TP)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
