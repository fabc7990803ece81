"""The port's plain device math (ops/step_math.py) vs the Pallas kernels'
shared math (acas2d_tpu/ops/pallas_step.py), float32 on the CPU.

The hash RNG must be bit-equal (it decides every sample and respawn).  The
float math follows the same op order, so it is held to a few float32 ulps:
rtol 1e-6 (XLA on the CPU may fuse or reorder a multiply-add that torch
evaluates as written; transcendentals may differ by an ulp).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acas2d_tpu.config import DEFAULT_PARAMS as JP
from acas2d_tpu.ops import pallas_step as ps
from acas2d_tpu_torch.config import DEFAULT_PARAMS as TP
from acas2d_tpu_torch.ops import step_math as sm

RTOL = 1e-6


@pytest.mark.parametrize("seed", [0, 3, 12345, -7, 2 ** 31 - 1, -2 ** 31])
def test_u01_hash_bit_equal(seed):
    ids = np.arange(0, 4 * ps.LANES, 13)
    lane = jnp.asarray(ids % ps.LANES, jnp.uint32)
    prog = jnp.asarray(ids // ps.LANES, jnp.uint32)
    jbase = (jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
             * jnp.uint32(0x9E3779B9) + prog * jnp.uint32(0xC2B2AE35)
             + lane * jnp.uint32(0x27D4EB2F))
    tbase = sm.rng_base(seed, torch.as_tensor(ids))
    assert np.array_equal(np.asarray(jbase).astype(np.int64), tbase.numpy())
    for step in (0, 1, 17, 1000, 2 ** 20 + 3):
        for salt in range(6):
            uj = np.asarray(ps._u01_hash(jbase, jnp.int32(step), salt))
            ut = sm._u01_hash(tbase, step, salt).numpy()
            assert uj.dtype == ut.dtype == np.float32
            assert np.array_equal(uj, ut), (step, salt)
    # a tensor step counter gives the same stream as the Python int
    steps = torch.full_like(tbase, 17)
    assert torch.equal(sm._u01_hash(tbase, steps, 4), sm._u01_hash(tbase, 17, 4))


def _f32(rng, n, scale=1.0):
    return (rng.normal(size=n) * scale).astype(np.float32)


def test_atan_atan2():
    rng = np.random.default_rng(0)
    x = _f32(rng, 20000, 5.0)
    x[:8] = [0.0, -0.0, 1.0, -1.0, 2.414213562373095, 0.414213562373095,
             1e30, -1e30]
    y = _f32(rng, 20000)
    y[:4] = [0.0, 1.0, -1.0, 0.0]
    np.testing.assert_allclose(sm._atan(torch.as_tensor(x)).numpy(),
                               np.asarray(ps._atan(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-7)
    for xs in (x, np.zeros_like(x)):              # incl. the x == 0 branches
        np.testing.assert_allclose(
            sm._atan2(torch.as_tensor(y), torch.as_tensor(xs)).numpy(),
            np.asarray(ps._atan2(jnp.asarray(y), jnp.asarray(xs))),
            rtol=RTOL, atol=1e-7)


def _geometry_inputs(n=4096, seed=1):
    rng = np.random.default_rng(seed)
    f = np.float32
    px = rng.uniform(0, 1600, n).astype(f)
    py = rng.uniform(0, 1000, n).astype(f)
    psi = rng.uniform(0, 360, n).astype(f)
    tx = rng.uniform(0, 1600, n).astype(f)
    ty = rng.uniform(0, 1000, n).astype(f)
    tv = np.full(n, 200.0, f)
    tpsi = rng.uniform(0, 360, n).astype(f)
    a_lat = rng.uniform(-196, 196, n).astype(f)
    pr, tr = psi * f(ps.DEG2RAD), tpsi * f(ps.DEG2RAD)
    return (px, py, np.cos(pr), np.sin(pr), psi, tx, ty, tv, np.cos(tr),
            np.sin(tr), a_lat)


def test_env_geometry_and_reward():
    args = _geometry_inputs()
    c = sm.kernel_constants(TP)
    tg = sm.env_geometry(*(torch.as_tensor(a) for a in args), c)
    jg = ps.env_geometry(*(jnp.asarray(a) for a in args),
                         v=jnp.float32(JP.airspeed), dt=jnp.float32(JP.dt),
                         gx=jnp.float32(JP.goal_x), gy=jnp.float32(JP.goal_y))
    # each field to RTOL of its largest magnitude: an ulp or two of the
    # operands (the closing speed cancels near 0, so not elementwise)
    names = ("d_goal", "h_goal_rad", "d_dev", "d_sep", "d_cpa", "v_closing")
    for name, t, j in zip(names, tg, jg):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=RTOL * np.abs(j).max(), err_msg=name)
    psi = torch.as_tensor(args[4])
    h_deg = [g * np.float32(1.0 / ps.DEG2RAD) for g in (tg[1], jg[1])]
    rt = sm.shaped_step_reward(psi, h_deg[0], tg[0], tg[2], tg[4], tg[5], c)
    rj = ps.shaped_step_reward(jnp.asarray(args[4]), h_deg[1], jg[0], jg[2],
                               jg[4], jg[5], p=JP)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-5)
    # on identical inputs the reward is the same arithmetic: a few ulps
    jin = [jnp.asarray(t.numpy()) for t in tg]
    rj2 = ps.shaped_step_reward(jnp.asarray(args[4]),
                                jnp.asarray(h_deg[0].numpy()), jin[0], jin[2],
                                jin[4], jin[5], p=JP)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj2), rtol=RTOL, atol=1e-7)


def test_respawn_and_constants():
    c = sm.kernel_constants(TP)
    assert c["bearing"] == float(ps.goal_bearing(JP))
    u = np.random.default_rng(2).uniform(size=(3, 1000)).astype(np.float32)
    tr = sm.respawn(*(torch.as_tensor(x) for x in u), c)
    jr = ps.respawn(*(jnp.asarray(x) for x in u), p=JP,
                    bearing=ps.goal_bearing(JP))
    for t, j in zip(tr, jr):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=0)
    with pytest.raises(ValueError):
        sm.kernel_constants(TP.__class__(bug_compat=False))
