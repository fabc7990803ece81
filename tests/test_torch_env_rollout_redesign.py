"""CPU checks of the env rollout kernel's arithmetic rewrites
(csrc/step_math.cuh, csrc/env_rollout.cu), in numpy float32 (IEEE, denormals
kept, no fused multiply-add unless emulated):

- the arctan's one divide with selected operands equals the reference's
  select of three divides bit for bit;
- the 2pi wrap as a select equals x - 2pi * floor(x / 2pi) bit for bit on
  every output of the arctan2;
- the premise of the observation's reuse: in the plain version, a lane
  whose episode went on observes exactly the geometry of its step;
- the bounded-range sin/cos (`acas::BoundedTrig`, its constants read from
  the source, its fused multiply-adds emulated exactly in long double)
  stays within 2 ulp of the correctly rounded value over |x| <= 8.
"""

import re

import numpy as np
import pytest
import torch

from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.envs import vector
from acas2d_tpu_torch.ops import _cuda, env_rollout
from acas2d_tpu_torch.ops import step_math as sm

f32 = np.float32
TAN_PI_8, TAN_3PI_8 = f32(0.4142135623730950), f32(2.414213562373095)
TWO_PI = f32(2 * np.pi)


def xr_select_of_three(x):
    """The reference's reduced argument (pallas_step.py:80-99)."""
    ax = np.abs(x)
    big, mid = ax > TAN_3PI_8, ax > TAN_PI_8
    safe = np.maximum(ax, f32(1e-30))
    with np.errstate(all="ignore"):
        return np.where(big, f32(-1.0) / safe,
                        np.where(mid, (ax - f32(1)) / (ax + f32(1)), ax))


def xr_one_divide(x):
    """acas::atan_ceph's reduced argument."""
    ax = np.abs(x)
    big, mid = ax > TAN_3PI_8, ax > TAN_PI_8
    num = np.where(big, f32(-1), np.where(mid, ax - f32(1), ax))
    den = np.where(big, ax, np.where(mid, ax + f32(1), f32(1)))
    with np.errstate(all="ignore"):
        return num / den


def atan_from(xr, x):
    ax = np.abs(x)
    off = np.where(ax > TAN_3PI_8, f32(np.pi / 2),
                   np.where(ax > TAN_PI_8, f32(np.pi / 4), f32(0)))
    z = xr * xr
    y = (((f32(8.05374449538e-2) * z - f32(1.38776856032e-1)) * z
          + f32(1.99777106478e-1)) * z - f32(3.33329491539e-1)) * z * xr + xr
    return np.sign(x) * (off + y)


def atan2_ceph(y, x):
    safe = np.where(x == 0, f32(1), x)
    with np.errstate(all="ignore"):
        q = y / safe
    base = atan_from(xr_select_of_three(q), q)
    pi = f32(np.pi)
    res = np.where(x > 0, base, np.where(y >= 0, base + pi, base - pi))
    return np.where(x == 0, np.where(y > 0, pi / f32(2),
                                     np.where(y < 0, -pi / f32(2), f32(0))),
                    res).astype(f32)


def bits(a):
    return np.asarray(a, dtype=f32).view(np.uint32)


def neighbours(v, n=4):
    """v and its n float32 neighbours on each side."""
    u = bits(np.array([v], dtype=f32))[0].astype(np.int64)
    return (np.arange(u - n, u + n + 1) % (1 << 32)).astype(
        np.uint32).view(f32)


def test_one_divide_arctan_equals_the_select_of_three():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        (rng.standard_normal(500_000) * 3).astype(f32),
        np.exp(rng.uniform(-100, 88, 500_000)).astype(f32),
        neighbours(TAN_PI_8), neighbours(TAN_3PI_8), neighbours(1.0),
        np.array([0.0, 1e-45, 1e-40, 1.1754942e-38, 1e-30, 3e38, np.inf],
                 dtype=f32)])
    x = np.concatenate([x, -x])
    a, b = xr_select_of_three(x), xr_one_divide(x)
    assert np.array_equal(bits(a), bits(b))
    assert np.array_equal(bits(atan_from(a, x)), bits(atan_from(b, x)))


def test_2pi_wrap_as_a_select_equals_the_floor_wrap():
    rng = np.random.default_rng(1)
    y = np.concatenate([(rng.standard_normal(500_000) * 500).astype(f32),
                        np.array([0.0, -0.0, 1e-45, -1e-45, 1.0, -1.0],
                                 dtype=f32)])
    x = np.concatenate([(rng.standard_normal(500_000) * 500).astype(f32),
                        np.array([0.0, -0.0, -1.0, -1e-45, 1e-45, 0.0],
                                 dtype=f32)])
    out = atan2_ceph(np.concatenate([y, y, -y]), np.concatenate([x, -x, x]))
    # every negative denormal (the threshold is the fourth, -0x1p-147)
    denormals = (np.arange(1 << 23, dtype=np.uint32)
                 | np.uint32(0x80000000)).view(f32)
    vals = np.concatenate([out, denormals, -denormals,
                           np.array([np.pi, -np.pi], dtype=f32)])
    assert float(np.abs(vals).max()) <= np.pi + 1e-6
    floor_wrap = vals - TWO_PI * np.floor(vals / TWO_PI)
    select = np.where(vals <= f32(-2.0 ** -147), vals + TWO_PI,
                      vals + f32(0))
    assert np.array_equal(bits(floor_wrap), bits(select))
    assert bits(select[vals == 0]).max() == 0        # -0 wraps to +0


def test_a_lane_that_goes_on_observes_its_steps_geometry():
    """One step of the plain version with obs: for every env whose
    episode did not end, obs_sum is the eight features of the geometry
    the reward used (the step's cos/sin and live action), bit for bit."""
    B = 2048
    gen = torch.Generator().manual_seed(3)
    es, _ = vector.reset_batch(B, DEFAULT_PARAMS, gen, torch.float32, "cpu")
    st = env_rollout.flat_state(es)
    st["steps"] = torch.randint(990, 1001, (B,), generator=gen,
                                dtype=torch.int32)
    c = sm.kernel_constants(DEFAULT_PARAMS)
    seed = 11
    final, stats = env_rollout.fused_rollout(st, seed, 1, with_obs=True)
    base = sm.rng_base(seed, torch.arange(B))
    a_lat = (sm._u01_hash(base, 0, 0) * 2.0 - 1.0) * c["acc"]
    psi = sm._mod360(st["psi"] + a_lat / c["v"])
    pr = psi * sm.DEG2RAD
    cp, sp = torch.cos(pr), torch.sin(pr)
    px = st["px"] + c["v"] * cp * c["dt"]
    py = st["py"] + c["v"] * sp * c["dt"]
    tr = st["tpsi"] * sm.DEG2RAD
    tcos, tsin = torch.cos(tr), torch.sin(tr)
    tx = st["tx"] + st["tv"] * tcos * c["dt"]
    ty = st["ty"] + st["tv"] * tsin * c["dt"]
    geo = sm.env_geometry(px, py, cp, sp, psi, tx, ty, st["tv"], tcos, tsin,
                          a_lat, c)
    obs = torch.zeros(B)
    for feature in sm.build_obs(st["steps"] + 1, psi, *geo, c).unbind(-1):
        obs = obs + feature
    went_on = stats["episodes"] == 0
    assert 0 < int(went_on.sum()) < B
    assert torch.equal(obs[went_on], stats["obs_sum"][went_on])
    assert torch.equal(final["px"][went_on], px[went_on])


# ------------------------------------------------------------ bounded trig

def bounded_trig_constants():
    """The hex float literals of acas::BoundedTrig, in source order: 2/pi,
    the three parts of pi/2, the sine's three and the cosine's three
    coefficients."""
    src = (_cuda.CSRC / "step_math.cuh").read_text()
    body = src[src.index("struct BoundedTrig {"):]
    body = body[:body.index("\n};")]
    lits = re.findall(r"-?0x1\.[0-9a-f]+p[+-]\d+f", body)
    assert len(lits) == 10, lits
    return [f32(float.fromhex(s[:-1])) for s in lits]


def fma(a, b, c):
    """float32 fused multiply-add: the product of two float32 values is
    exact in long double's 64-bit significand; the sum rounds there only
    where its terms lie over 2^40 apart, far from a float32 tie; then one
    rounding to float32."""
    ld = np.longdouble
    return (ld(a) * ld(b) + ld(c)).astype(f32)


def bounded_sincos(x):
    two_over_pi, p1, p2, p3, s0, s1, s2, c0, c1, c2 = \
        bounded_trig_constants()
    magic = f32(12582912.0)
    t = fma(x, two_over_pi, magic)
    q = t.view(np.int32)
    j = (t - magic).astype(f32)
    r = fma(-j, p1, x)
    r = fma(-j, p2, r)
    r = fma(-j, p3, r)
    z = (r * r).astype(f32)
    ps = (fma(fma(s0, z, s1), z, s2) * z).astype(f32)
    ps = fma(ps, r, r)
    pc = fma(fma(fma(fma(c0, z, c1), z, c2), z, f32(-0.5)), z, f32(1.0))
    odd = (q & 1) == 1
    sv, cv = np.where(odd, pc, ps), np.where(odd, ps, pc)
    return (np.where(q & 2, -sv, sv).astype(f32),
            np.where((q + 1) & 2, -cv, cv).astype(f32))


def test_long_double_emulates_a_fused_multiply_add():
    if np.finfo(np.longdouble).nmant < 63:
        pytest.skip("long double has no 64-bit significand here")
    a, b = f32(1 + 2 ** -12), f32(1 - 2 ** -12)
    assert fma(a, b, f32(-1)) == f32(-(2.0 ** -24))  # a*b rounds to 1


@pytest.mark.parametrize("fn", ["sin", "cos"])
def test_bounded_trig_within_2_ulp_over_the_env_angles(fn):
    if np.finfo(np.longdouble).nmant < 63:
        pytest.skip("long double has no 64-bit significand here")
    rng = np.random.default_rng(2)
    near = [neighbours(k * np.pi / 2, 64) for k in range(-5, 6)]
    x = np.concatenate([rng.uniform(-8, 8, 1_000_000).astype(f32), *near,
                        np.exp(rng.uniform(-100, 0, 10_000)).astype(f32),
                        np.array([0.0, 8.0, -8.0, 1e-45], dtype=f32)])
    x = np.concatenate([x, -x])
    x = x[np.abs(x) <= 8]
    s, c = bounded_sincos(x)
    got = s if fn == "sin" else c
    exact = getattr(np, fn)(x.astype(np.float64))
    rounded = exact.astype(f32)
    err = (np.abs(got.astype(np.float64) - rounded)
           / np.spacing(np.abs(rounded)).astype(np.float64))
    assert float(err.max()) <= 2.0, (float(err.max()), x[np.argmax(err)])
