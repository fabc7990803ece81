"""The numeric premise of the policy rollout's tensor-core design
(acas2d_tpu_torch/csrc/policy_rollout.cu), and its launch shapes, on the
CPU.

The kernel runs both towers' layer-1 and layer-2 products on the TF32
tensor cores as 3xTF32: each float32 operand x is split into
hi = tf32(x) and lo = tf32(x - hi), and hi*lo + lo*hi + hi*hi is summed in
float32; the heads stay float32.  Here those products are emulated with
the gradient kernel's test's `cvt.rna.tf32.f32` on the float32 bits
(tests/test_torch_ppo_grads_tf32x3.py), inside the plain version
(`ops/policy_rollout.py:_rollout_plain`, whose towers are
`tower_forward`), over K = 16 closed-loop steps at chip_smoke.py's
operands: solo B = 2048 and P = 8 members x B = 1024.

Rule: the CPU tests' own (tests/test_torch_policy_rollout.py), each float
field within ATOL x max(1, max |field|) of the plain version (the rewards
REWARD_ATOL, the episode sums 2K x REWARD_ATOL), integers exact.  3xTF32
must hold it; 1xTF32 (hi*hi alone, 11 bits of each operand) must fail it,
so the rule tells the two apart where chip_smoke.py's ROLLOUT_RTOL /
ROLLOUT_ATOL cannot.
"""

import pytest
import torch

from acas2d_tpu_torch import policy_ab
from acas2d_tpu_torch.ops import policy_rollout
from test_torch_ppo_grads_tf32x3 import split1, split3

K = 16
ATOL, REWARD_ATOL = 2e-6, 5e-5       # tests/test_torch_policy_rollout.py
REWARD_FIELDS = ("rewards",)
SUM_FIELDS = ("episode_return", "total_reward")
STATE_ROWS = policy_rollout.STATE_KEYS + ("pa_lat",)
SHAPES = {"solo": (1, 2048), "members": (8, 1024)}


def tower_with(mm):
    """`tower_forward` with `mm` for the two products; the head float32."""
    def tower_forward(x, tower):
        w1, b1, w2, b2, wh, bh = tower
        h1 = torch.tanh(mm(x, w1.T) + b1)
        h2 = torch.tanh(mm(h1, w2.T) + b2)
        return h1, h2, h2 @ wh + bh
    return tower_forward


def rollout(P, B):
    out = policy_ab.named(policy_rollout._rollout_plain(
        *policy_ab.operands("cpu", P, B, K)))
    out.update(zip(STATE_ROWS, out.pop("st")))
    return out


def worst(got, want):
    """{field: error / its allowance} for floats, mismatches for ints."""
    out = {}
    for k, w in want.items():
        if not torch.is_floating_point(w):
            out[k] = int((got[k] != w).sum())
            continue
        atol = (REWARD_ATOL if k in REWARD_FIELDS
                else 2 * K * REWARD_ATOL if k in SUM_FIELDS
                else ATOL * max(1.0, float(w.abs().max())))
        out[k] = float((got[k] - w).abs().max()) / atol
    return out


@pytest.fixture(scope="module", params=list(SHAPES))
def runs(request):
    P, B = SHAPES[request.param]
    want = rollout(P, B)
    mp = pytest.MonkeyPatch()
    got = {}
    try:
        for name, mm in (("3x", split3), ("1x", split1)):
            mp.setattr(policy_rollout, "tower_forward", tower_with(mm))
            got[name] = rollout(P, B)
    finally:
        mp.undo()
    assert int(want["dones"].sum()) > 0, "respawns should occur"
    return want, got


def test_3xtf32_products_hold_the_cpu_tests_rule(runs):
    want, got = runs
    w = worst(got["3x"], want)
    assert all(v <= 1 for v in w.values()), w
    assert all(w[k] == 0 for k in ("steps", "episode_steps", "outcome")), w


def test_1xtf32_products_fail_it(runs):
    """In the values: the policy head's weights start 100 times smaller
    (SB3's gain 0.01), so the actions' errors stay small."""
    want, got = runs
    w = worst(got["1x"], want)
    assert w["values"] > 1, w


@pytest.mark.parametrize("P,B,mt,w", [
    (1, 2048, 1, 1),       # the solo main path: 128 blocks of 2 warps
    (32, 1024, 2, 4),      # the population's: 256 blocks of 8 warps
    (1, 1000, 1, 1),       # rows past B in the last tile
    (3, 200, 1, 1),
    (32, 1000, 2, 4),
    (16, 1024, 2, 2),
    (1, 128, 1, 1)])
def test_launch_shape(P, B, mt, w):
    sms = 132                          # an H100 SXM's
    assert policy_rollout.launch_shape(P, B, sms) == (mt, w)
    tiles = -(-B // (16 * mt))
    assert 1 <= w <= min(policy_rollout.MAX_WARPS
                         // policy_rollout.WARPS_A_TILE[mt], tiles)
    blocks = P * -(-tiles // w)
    # every SM gets a block where there are tiles enough
    assert blocks >= min(sms, P * tiles)
