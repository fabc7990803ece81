"""The numeric premise of the f32 gradient kernel's tensor-core design
(acas2d_tpu_torch/csrc/ppo_grads.cu, grad_partials_tf32x3), on the CPU.

The kernel runs its products on the TF32 tensor cores as 3xTF32: each
float32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
hi*lo + lo*hi + hi*hi is summed in float32.  Here the products are
emulated with `cvt.rna.tf32.f32` written on the float32 bits (round to
nearest, ties away from zero, to 10 explicit mantissa bits), inside a copy
of the plain version's forward and backward (`ops/ppo_grads.py:
_grads_plain`) whose five tensor-core products (layer 1 and 2 forward,
e1 = e2 W2, dW2 = e2^T h1, dW1 = e1^T x) take the emulated product.

Bound: every parameter block within GRAD_REL_TOL / 10 of its largest
entry, where GRAD_REL_TOL = 1e-4 is the card's bound of the kernel against
the plain version (chip_smoke.py, tests/test_torch_cuda.py), so the split
leaves nine tenths of it to the summation order.  1xTF32 (hi*hi alone)
must fail that bound: the test tells the two apart.
"""

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from acas2d_tpu_torch.models.actor_critic import (ActorCritic, flatten,
                                                  gaussian_log_prob,
                                                  split_flat)
from acas2d_tpu_torch.ops import ppo_grads

GRAD_REL_TOL = 1e-4
BOUND = GRAD_REL_TOL / 10
N = 4096
SIZES = [512, 64, 4096, 64, 64, 1] * 2 + [1]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: add half of the 13 dropped bits' unit to the
    magnitude bits, then clear them (ties round away from zero)."""
    bits = x.detach().contiguous().numpy().view(np.uint32)
    out = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return torch.from_numpy(out.view(np.float32))


def exact(a, b):
    return a @ b


def split3(a, b):
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def split1(a, b):
    return tf32(a) @ tf32(b)


def grads_with(mm, params, data, c, ent_coef):
    """`_grads_plain` (f32) with `mm` for the kernel's five tensor-core
    products; the head products stay float32, as on the card."""
    pi, vf, log_std = split_flat(params)
    x = data[:, :8]
    act, old_logp, adv, ret = data[:, 8], data[:, 9], data[:, 11], data[:, 12]
    cls = torch.clamp(log_std[0], -4.0, 2.0)
    var = torch.exp(2.0 * cls)

    def forward(tower):
        w1, b1, w2, b2, wh, bh = tower
        h1 = torch.tanh(mm(x, w1.T) + b1)
        h2 = torch.tanh(mm(h1, w2.T) + b2)
        return h1, h2, h2 @ wh + bh

    h1p, h2p, mean = forward(pi)
    h1v, h2v, value = forward(vf)
    diff = act - mean
    logp = -0.5 * (diff * diff / var + 2.0 * cls + c["log_2pi"])
    delta = logp - old_logp
    delta_c = torch.clamp(delta, -20.0, 20.0)
    ratio = torch.exp(delta_c)
    lo, hi = c["lo"], c["hi"]
    sel = (((ratio > lo) & (ratio < hi)) | ((adv > 0.0) & (ratio < lo))
           | ((adv < 0.0) & (ratio > hi)))
    dlogp = ((-(adv * ratio) * c["inv_n"])
             * (sel & (torch.abs(delta) < 20.0)).to(torch.float32))
    dls = (dlogp * (diff * diff / var - 1.0)).sum()

    def tower_grads(tower, h1, h2, dout):
        w1, b1, w2, b2, wh, bh = tower
        e2 = (dout[:, None] * wh[None, :]) * (1.0 - h2 * h2)
        e1 = mm(e2, w2) * (1.0 - h1 * h1)
        return [mm(e1.T, x).reshape(-1), e1.sum(0),
                mm(e2.T, h1).reshape(-1), e2.sum(0), dout @ h2,
                dout.sum().reshape(1)]

    return torch.cat(tower_grads(pi, h1p, h2p, dlogp * (diff / var))
                     + tower_grads(vf, h1v, h2v,
                                   c["dvalue_scale"] * (value - ret))
                     + [(dls - ent_coef).reshape(1)])


def _inputs(seed):
    """Seeded numpy minibatch (as tests/test_torch_ppo_grads.py) whose
    ratios straddle the clip band, for a freshly initialised policy."""
    rng = np.random.default_rng(seed)
    model = ActorCritic(generator=torch.Generator().manual_seed(seed))
    obs = torch.from_numpy(rng.normal(size=(N, 8)).astype(np.float32) * 0.3)
    with torch.no_grad():
        mean, log_std, value = model(obs)
        act = mean + torch.from_numpy(
            rng.normal(size=(N, 1)).astype(np.float32) * 0.7)
        old_logp = gaussian_log_prob(act, mean, log_std) + torch.from_numpy(
            rng.normal(size=N).astype(np.float32) * 0.3)
    adv = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    ret = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    data = torch.cat([obs, act, old_logp[:, None], value[:, None],
                      adv[:, None], ret[:, None]], 1)
    data = ppo_grads.normalize_adv_column(data)
    return flatten(model).detach(), data, ppo_grads._constants(N, 0.2, 0.5)


def _worst_block(got, want):
    return max(float((a - b).abs().max() / (b.abs().max() + 1e-12))
               for a, b in zip(got.split(SIZES), want.split(SIZES)))


@pytest.fixture(scope="module", params=[0, 1], ids=["seed0", "seed1"])
def case(request):
    params, data, c = _inputs(request.param)
    ent_coef = 0.01 * request.param
    want, _ = ppo_grads._grads_plain(params, data, c, ent_coef)
    return params, data, c, ent_coef, want


def test_tf32_rounds_to_nearest_ties_away():
    u = 2.0 ** -10                                  # tf32's ulp at 1
    x = torch.tensor([1.0, 1 + u / 2, 1 + u / 4, 1 + 1.5 * u, 1 + 0.49 * u,
                      -(1 + u / 2), -(1 + 0.49 * u)], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + u, 1.0, 1 + 2 * u, 1.0, -(1 + u), -1.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    hi = tf32(r)
    assert torch.equal(tf32(hi), hi)                # idempotent
    assert float(((r - hi).abs() / r.abs()).max()) <= 2.0 ** -11
    # hi + lo carries ~22 bits: what 3xTF32 keeps of each operand
    lo = tf32(r - hi)
    assert float(((r - hi - lo).abs() / r.abs()).max()) <= 2.0 ** -21


def test_emulation_with_float32_products_is_the_plain_version(case):
    params, data, c, ent_coef, want = case
    assert _worst_block(grads_with(exact, params, data, c, ent_coef),
                        want) < 1e-6


def test_3xtf32_products_hold_the_plain_version(case):
    params, data, c, ent_coef, want = case
    assert _worst_block(grads_with(split3, params, data, c, ent_coef),
                        want) < BOUND


def test_1xtf32_products_fail_the_same_bound(case):
    params, data, c, ent_coef, want = case
    assert _worst_block(grads_with(split1, params, data, c, ent_coef),
                        want) > BOUND
