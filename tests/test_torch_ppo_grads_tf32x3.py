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

The kernel's warpgroup products (wgmma, K = 8 an instruction) are also
emulated as it chains them: the three terms of each 8-deep k-step in turn
into one accumulator; layer 2's k-steps each from zero, added in float32;
e1 = e2 W2 one chain over 64; dW2 and dW1 one chain over each 64-row tile,
tiles added in float32 per warpgroup (two, on alternate tiles of a block),
warpgroups then blocks in order.  e1's A is an accumulator, so its K runs
in kperm's order within each 8 (a thread holds columns 2q, 2q + 1 where A
wants k = q, q + 4), and the row products take a tile's rows in the order
16 w + 2 g + h of row 16 w + g + 8 h.
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


def grads_with(mm, params, data, c, ent_coef, products=None):
    """`_grads_plain` (f32) with `mm` for the kernel's five tensor-core
    products, or `products[name]` where given ("l1", "l2", "e1", "dw1",
    "dw2"); the head products stay float32, as on the card."""
    p = dict.fromkeys(("l1", "l2", "e1", "dw1", "dw2"), mm)
    p.update(products or {})
    pi, vf, log_std = split_flat(params)
    x = data[:, :8]
    act, old_logp, adv, ret = data[:, 8], data[:, 9], data[:, 11], data[:, 12]
    cls = torch.clamp(log_std[0], -4.0, 2.0)
    var = torch.exp(2.0 * cls)

    def forward(tower):
        w1, b1, w2, b2, wh, bh = tower
        h1 = torch.tanh(p["l1"](x, w1.T) + b1)
        h2 = torch.tanh(p["l2"](h1, w2.T) + b2)
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
        e1 = p["e1"](e2, w2) * (1.0 - h1 * h1)
        return [p["dw1"](e1.T, x).reshape(-1), e1.sum(0),
                p["dw2"](e2.T, h1).reshape(-1), e2.sum(0), dout @ h2,
                dout.sum().reshape(1)]

    return torch.cat(tower_grads(pi, h1p, h2p, dlogp * (diff / var))
                     + tower_grads(vf, h1v, h2v,
                                   c["dvalue_scale"] * (value - ret))
                     + [(dls - ent_coef).reshape(1)])


# position k' of each 8 of K reads input KPERM[k'] (csrc/ppo_grads.cu kperm)
KPERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
# a tile's rows in the order the kernel's row products take them
ROW_ORDER = torch.tensor([16 * w + g + 8 * h for w in range(4)
                          for g in range(8) for h in range(2)])


def terms(a, b, nsplit):
    """The tensor-core products of one k-step, in the order issued:
    hi*lo, lo*hi, hi*hi (3xTF32) or hi*hi alone (1xTF32), or the float32
    product (0)."""
    if nsplit == 0:
        return [a @ b]
    ah, bh = tf32(a), tf32(b)
    if nsplit == 1:
        return [ah @ bh]
    return [ah @ tf32(b - bh), tf32(a - ah) @ bh, ah @ bh]


def chain(a, b, nsplit, restart=False, perm=False):
    """a @ b as wgmma's 8-deep k-steps into one accumulator, or with
    `restart` each k-step from zero and added in float32; `perm` takes K
    in KPERM's order within each 8."""
    k = a.shape[1]
    order = (torch.arange(k).view(-1, 8)[:, KPERM].reshape(-1) if perm
             else torch.arange(k))
    out = torch.zeros(a.shape[0], b.shape[1])
    acc = out
    for s in range(0, k, 8):
        idx = order[s:s + 8]
        if restart:
            acc = torch.zeros_like(out)
        for t in terms(a[:, idx], b[idx], nsplit):
            acc = acc + t
        if restart:
            out = out + acc
    return out if restart else acc


def row_tiles(a, b, nsplit):
    """a @ b over rows (a: (M, N rows), b: (N rows, K)) as the kernel
    takes them: a block's rows (launch_blocks at P = 1) in 64-row tiles, a
    chain over each tile's rows in ROW_ORDER, added in float32 per
    warpgroup (tiles 0, 2, ... and 1, 3, ...), then warpgroup 0 + 1, then
    the blocks in order (the second pass)."""
    n = a.shape[1]
    rows, nblocks = ppo_grads.launch_blocks(1, n)
    total = torch.zeros(a.shape[0], b.shape[1])
    for blk in range(nblocks):
        wgs = [torch.zeros_like(total), torch.zeros_like(total)]
        r_end = min(n, (blk + 1) * rows)
        for i, r0 in enumerate(range(blk * rows, r_end, 64)):
            idx = r0 + ROW_ORDER[ROW_ORDER < r_end - r0]
            wgs[i % 2] = wgs[i % 2] + chain(a[:, idx], b[idx], nsplit)
        total = total + (wgs[0] + wgs[1])
    return total


def wgmma_products(nsplit, which):
    """`grads_with`'s products as the wgmma kernel chains them, for the
    products in `which`."""
    prods = {
        "l1": lambda a, b: chain(a, b, nsplit),
        "l2": lambda a, b: chain(a, b, nsplit, restart=True),
        "e1": lambda a, b: chain(a, b, nsplit, perm=True),
        "dw1": lambda a, b: row_tiles(a, b, nsplit),
        "dw2": lambda a, b: row_tiles(a, b, nsplit),
    }
    return {k: v for k, v in prods.items() if k in which}


# the kernel's chains one part at a time, then all of them
CHAINS = {"layer2_k_steps": ("l2",), "e1_permuted": ("e1",),
          "row_tiles": ("dw1", "dw2"),
          "kernel": ("l1", "l2", "e1", "dw1", "dw2")}


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


@pytest.mark.parametrize("product", [
    dict(restart=False, perm=False), dict(restart=True, perm=False),
    dict(restart=False, perm=True), "row_tiles"],
    ids=["chain", "restart", "perm", "row_tiles"])
def test_wgmma_chains_with_float32_products_compute_the_product(product):
    """The emulated chains, permutations and row tiles with float32
    products are the product itself (to float32 summation order), on a
    ragged row count (1000, a masked last tile)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(64, 1000)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(1000, 64)).astype(np.float32))
    if product == "row_tiles":
        got = row_tiles(a, b, 0)
    else:
        a, b = a[:, :64], b[:64]
        got = chain(a, b, 0, **product)
    want = a.double() @ b.double()
    assert float((got.double() - want).abs().max() / want.abs().max()) < 1e-6


@pytest.mark.parametrize("chains", sorted(CHAINS))
def test_3xtf32_wgmma_chains_hold_the_plain_version(case, chains):
    params, data, c, ent_coef, want = case
    got = grads_with(split3, params, data, c, ent_coef,
                     wgmma_products(3, CHAINS[chains]))
    assert _worst_block(got, want) < BOUND


@pytest.mark.parametrize("chains", sorted(CHAINS))
def test_1xtf32_wgmma_chains_fail_the_same_bound(case, chains):
    params, data, c, ent_coef, want = case
    got = grads_with(split1, params, data, c, ent_coef,
                     wgmma_products(1, CHAINS[chains]))
    assert _worst_block(got, want) > BOUND
