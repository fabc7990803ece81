"""The arithmetic of the bf16 gradient kernel's tensor-core design
(acas2d_tpu_torch/csrc/ppo_grads.cu, grad_partials_bf16mma), on the CPU.

The kernel rounds the two operands of each of its eight products to bf16,
each operand once, and sums the exact bf16 x bf16 products in float32 on
the tensor cores in its own order: layer 2's forward per 16-long k-step,
each step added to the sum in float32; the cross-row products (dW2, dW1),
the head-weight sum and the bias sums per 64-row tile, each tile added in
float32.  `grads_tiled` is a copy of the plain version
(`ops/ppo_grads.py:_grads_plain` with bf16=True) whose products and sums
are taken that way.

It must hold:
  * accuracy, chip_smoke.py's bf16 allowance against the plain bf16
    version: every block at least 1 / BF16_VS_F32 times closer to it than
    the float32 result is, or within GRAD_REL_TOL of its tower's scale;
    on the separating blocks (the sums over rows of rounded products),
    within BF16_VS_F32 of the float32 result's distance;
  * the same emulation with the rounding switched off (float32 products in
    the kernel's order) fails that separation, so the check tells the two
    apart;
  * the Pallas kernel's bf16=True in interpret mode within BF16_REL_TOL
    (tests/test_torch_ppo_grads_bf16.py) of each block's scale.

What it cannot show: the tensor cores' own float32 accumulation, which
does not round to nearest (csrc/ppo_grads.cu:add_tile), and the card's
tanhf, an ulp away from the CPU's, which can move an activation to the
neighbouring bf16 value.  Only the card checks hold the kernel to those
(chip_smoke.py, tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu.ops import pallas_update
from acas2d_tpu_torch.models.actor_critic import split_flat
from acas2d_tpu_torch.ops import ppo_grads
from acas2d_tpu_torch.utils.params_io import flat_to_tree, tree_to_flat

from test_torch_ppo_grads_tf32x3 import SIZES, _inputs

GRAD_REL_TOL = 1e-4
BF16_VS_F32 = 0.1
BF16_REL_TOL = 1e-3
TILE, KSTEP = 64, 16
NAMES = [f"{t}.{nm}" for t in ("pi", "vf")
         for nm in ("w1", "b1", "w2", "b2", "w_head", "b_head")] + ["log_std"]
SEPARATING = [f"{t}.{nm}" for t in ("pi", "vf")
              for nm in ("w1", "b1", "w2", "b2", "w_head")]


def tile_sum(parts):
    """Per-tile partial sums added in float32, tile by tile."""
    acc = None
    for p in parts:
        acc = p if acc is None else acc + p
    return acc


def grads_tiled(params, data, c, ent_coef, rounded=True):
    """`_grads_plain(bf16=True)` with the kernel's partial sums; with
    `rounded` False the same order on float32 operands."""
    r = ppo_grads.bf16_round if rounded else (lambda t: t)
    pi, vf, log_std = split_flat(params)
    x = data[:, :8]
    act, old_logp, adv, ret = data[:, 8], data[:, 9], data[:, 11], data[:, 12]
    cls = torch.clamp(log_std[0], -4.0, 2.0)
    var = torch.exp(2.0 * cls)

    def forward(tower):
        w1, b1, w2, b2, wh, bh = tower
        h1 = torch.tanh(r(x) @ r(w1).T + b1)
        z = tile_sum(r(h1)[:, k:k + KSTEP] @ r(w2)[:, k:k + KSTEP].T
                     for k in range(0, 64, KSTEP))
        h2 = torch.tanh(z + b2)
        return h1, h2, r(h2) @ r(wh) + bh

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
        rd = r(dout)
        e2 = (rd[:, None] * r(wh)[None, :]) * (1.0 - h2 * h2)
        e1 = (r(e2) @ r(w2)) * (1.0 - h1 * h1)
        rows = [slice(t, t + TILE) for t in range(0, len(x), TILE)]
        return [tile_sum(r(e1)[s].T @ r(x)[s] for s in rows).reshape(-1),
                tile_sum(e1[s].sum(0) for s in rows),
                tile_sum(r(e2)[s].T @ r(h1)[s] for s in rows).reshape(-1),
                tile_sum(e2[s].sum(0) for s in rows),
                tile_sum(rd[s] @ r(h2)[s] for s in rows),
                dout.sum().reshape(1)]

    return torch.cat(tower_grads(pi, h1p, h2p, dlogp * (diff / var))
                     + tower_grads(vf, h1v, h2v,
                                   c["dvalue_scale"] * (value - ret))
                     + [(dls - ent_coef).reshape(1)])


def block_errs(got, ref):
    """{block: (max |got - ref|, max |ref| of its tower)}; log_std is its
    own tower."""
    n_tower = sum(SIZES[:6])
    towers = (float(ref[:n_tower].abs().max()),
              float(ref[n_tower:2 * n_tower].abs().max()),
              float(ref[-1].abs()))
    return {name: (float((g - w).abs().max()), towers[i // 6])
            for i, (name, g, w) in enumerate(zip(NAMES, got.split(SIZES),
                                                 ref.split(SIZES)))}


@pytest.fixture(scope="module", params=[0, 1], ids=["seed0", "seed1"])
def case(request):
    params, data, c = _inputs(request.param)
    ent_coef = 0.01 * request.param
    plain16, _ = ppo_grads._grads_plain(params, data, c, ent_coef, bf16=True)
    plain32, _ = ppo_grads._grads_plain(params, data, c, ent_coef)
    return params, data, c, ent_coef, plain16, plain32


def test_emulated_bf16_kernel_meets_the_card_allowance(case):
    params, data, c, ent_coef, plain16, plain32 = case
    errs = block_errs(grads_tiled(params, data, c, ent_coef), plain16)
    f32 = block_errs(plain32, plain16)
    for name in NAMES:
        (err, tower), (dev, _) = errs[name], f32[name]
        assert err <= max(BF16_VS_F32 * dev, GRAD_REL_TOL * tower), name
        if name in SEPARATING:
            assert err <= BF16_VS_F32 * dev, name


def test_unrounded_emulation_fails_the_separation(case):
    params, data, c, ent_coef, plain16, plain32 = case
    errs = block_errs(grads_tiled(params, data, c, ent_coef, rounded=False),
                      plain16)
    f32 = block_errs(plain32, plain16)
    for name in SEPARATING:
        assert errs[name][0] > BF16_VS_F32 * f32[name][0], name


def test_emulated_bf16_kernel_matches_pallas_bf16(case):
    params, data, c, ent_coef, *_ = case
    kgrads, _ = pallas_update.ppo_minibatch_grads(
        jax.tree.map(jnp.asarray, flat_to_tree(params)),
        jnp.asarray(data.numpy()), clip_range=0.2, vf_coef=0.5,
        ent_coef=ent_coef, normalize_advantage=False, interpret=True,
        bf16=True)
    want = tree_to_flat(jax.tree.map(np.asarray, kgrads))
    got = grads_tiled(params, data, c, ent_coef)
    for name, g, w in zip(NAMES, got.split(SIZES), want.split(SIZES)):
        scale = float(w.abs().max()) + 1e-12
        assert float((g - w).abs().max()) / scale < BF16_REL_TOL, name
