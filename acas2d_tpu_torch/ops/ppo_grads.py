"""Fused PPO minibatch gradient: forward + hand-derived backward.

Counterpart of `acas2d_tpu/ops/pallas_update.py:60-191,290-297,345-386`.
For one packed minibatch (N, 13) =
[obs(8), action, old_logp, old_value, advantage, return] it returns the
gradient of `ppo/learner.py:ppo_loss` with respect to the flat parameter
vector, and the loss statistics.  The branch structure is the JAX kernel's:
the +-20 log-ratio clamp zeroes the gradient outside it (`delta_in`), the
clip band test is strict (`in_band`), min() selects the unclipped branch
inside the band and where clipping would have helped (`sel`), the log-std
gradient is straight-through its clamp, and the loss's `-ent_coef * entropy`
term adds `-ent_coef` to it.  SB3's per-minibatch advantage normalisation
runs before the kernel: the learner normalises every minibatch of an epoch
at once (`normalize_adv_minibatches`, a kernel of its own in the same
library), and a direct call normalises its minibatch itself
(`normalize_adv_column`).

`bf16=True` is the JAX kernel's bf16 variant (`pallas_update.py:109-127`,
`PPOConfig.fused_update_bf16`): the two operands of each of its eight
matrix products are rounded to bf16 (round to nearest even) and the
products are summed in float32.  Everything else stays float32 and
unrounded: the bias sums, the tanh derivatives and the loss.  The TPU
kernel's block-diagonal packing puts zeros off the diagonal, which stay
zero when rounded, so the per-tower arithmetic here is the same function.

`ppo_minibatch_grads_members` computes the gradients of P member policies,
each on its own minibatch, in one launch: the port's counterpart of the JAX
population's `vmap(ppo_minibatch_grads_packed)` (`pallas_update.py:389`,
`population.py:76-94`).  The packed 7-leaf tree there exists to keep the
TPU kernel's block-diagonal operands across the update loop, with the
off-diagonal gradients masked to zero; the port's flat vector already is
the kernel's operand and holds exactly the unmasked entries, so the packed
update and the fused update are the same computation here.  The solo
`ppo_minibatch_grads` is its P = 1 call.

The wrapper launches the CUDA kernel (`csrc/ppo_grads.cu`) for CUDA tensors
and runs the plain version (`_grads_plain`, the same forward and backward
in torch, member by member) for CPU tensors.  There is no fallback between
the two.  `ppo_minibatch_grads_members.launches` counts the kernel's
launches, solo or member (a captured training iteration's replays are
counted by `learner.make_train_loop`).  The kernel runs its products on
the tensor cores: without `bf16` on Hopper's warpgroup MMA (wgmma, one
warpgroup a 64-row tile) as 3xTF32 (each float32 operand split into two
TF32 parts), which keeps them close to float32 (on the card every
gradient block agrees with the plain version within 4e-5 of its largest
entry); with `bf16` as one bf16 product each (mma.sync), on operands
rounded once as the plain version rounds them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from acas2d_tpu_torch.models.actor_critic import N_PARAMS, split_flat
from acas2d_tpu_torch.ops import _cuda

LOG_2PI = math.log(2.0 * math.pi)

# packed minibatch column layout (learner.ppo_update)
_OBS, _ACT, _LOGP, _VAL, _ADV, _RET = 0, 8, 9, 10, 11, 12
N_COLS = 13
TILE_ROWS = 64        # rows per tile of the CUDA kernel's first pass
# first-pass blocks per tower, shared by all members of a launch: a solo
# launch gets 128 per tower, a 32-member launch 4 per member and tower, so
# the partials pass 2 reads stay ~5 MB at any population size
TARGET_BLOCKS = 128


def normalize_adv_column(mb_data: torch.Tensor) -> torch.Tensor:
    """SB3's per-minibatch advantage normalisation on the packed matrix's
    advantage column (pallas_update.py:290-297), over the rows of each
    (..., N, 13) minibatch: per member for a population's (P, N, 13).  The
    std is the population std (ddof 0), as `jnp.std`.  Returns a copy."""
    out = mb_data.clone()
    _normalize_plain(out)
    return out


def _normalize_plain(mbs: torch.Tensor) -> torch.Tensor:
    """`normalize_adv_column`'s torch ops in place on (..., M, 13), a
    (P, M, 13) minibatch step's slice at a time: each reduction keeps the
    shape a step gave it, since torch's CPU std of one float64 row sums in
    another order than that of several (up to 15 ulps apart).  Returns the
    (..., 2) means and stds."""
    if mbs.dim() > 3:
        return torch.stack([_normalize_plain(mb) for mb in mbs])
    adv = mbs[..., _ADV]
    mean = adv.mean(-1, keepdim=True)
    std = adv.std(-1, correction=0, keepdim=True)
    mbs[..., _ADV] = (adv - mean) / (std + 1e-8)
    return torch.cat([mean, std], -1)


def _normalize_cuda(mbs: torch.Tensor) -> torch.Tensor:
    """Launch csrc/ppo_grads.cu's advantage normalisation (two passes) on
    the contiguous (..., M, 13) float32 or float64 `mbs`, in place; returns
    the (..., 2) means and stds."""
    if mbs.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"minibatches must be float32 or float64, got "
                         f"{mbs.dtype}")
    lead, M = tuple(mbs.shape[:-2]), mbs.shape[-2]
    _cuda.require(mbs, "minibatches", mbs.dtype, lead + (M, N_COLS))
    groups = math.prod(lead)
    lib = _cuda.load("ppo_grads")
    lib.acas_adv_norm_partial_doubles.restype = ctypes.c_longlong
    lib.acas_adv_norm_partial_doubles.argtypes = [ctypes.c_int]
    fn = lib.acas_adv_norm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3)
    partial = torch.empty(lib.acas_adv_norm_partial_doubles(groups),
                          dtype=torch.float64, device=mbs.device)
    stats = torch.empty(lead + (2,), dtype=mbs.dtype, device=mbs.device)
    rc = fn(_cuda.ptr(mbs), groups, M, int(mbs.dtype == torch.float64),
            _cuda.ptr(partial), _cuda.ptr(stats), _cuda.stream_of(mbs))
    _cuda.check(rc, lib, "adv_norm launch")
    normalize_adv_minibatches.launches += 2
    return stats


def normalize_adv_minibatches(mbs: torch.Tensor) -> torch.Tensor:
    """SB3's advantage normalisation of every minibatch of an epoch at once,
    in place: the advantage column of each (M, 13) minibatch of `mbs`
    (..., M, 13), the epoch's packed (n_minibatches, P, M, 13) copy, over
    its M rows, as `normalize_adv_column` normalises one (ddof 0,
    (adv - mean) / (std + 1e-8)).  Returns the (..., 2) means and stds.

    CUDA tensors (contiguous, float32 or float64) launch csrc/ppo_grads.cu's
    two passes, whose statistics are float64 merges rounded once;
    `normalize_adv_minibatches.launches` counts the launches.  CPU tensors
    run `normalize_adv_column`'s torch ops, a minibatch step's slice at a
    time, bit for bit what each step computed itself.  There is no
    fallback between the two."""
    if mbs.dim() < 2 or mbs.shape[-1] != N_COLS or not mbs.numel():
        raise ValueError(f"minibatches must be a non-empty (..., M, "
                         f"{N_COLS}), got {tuple(mbs.shape)}")
    if mbs.is_cuda:
        return _normalize_cuda(mbs)
    return _normalize_plain(mbs)


normalize_adv_minibatches.launches = 0


def _constants(n: int, clip_range: float, vf_coef: float):
    """float32 constants folded as the JAX kernel folds them."""
    f = np.float32
    inv_n = f(1.0 / n)
    eps = f(clip_range)
    return dict(inv_n=float(inv_n), eps=float(eps),
                lo=float(f(1.0) - eps), hi=float(f(1.0) + eps),
                dvalue_scale=float(f(vf_coef) * f(2.0) * inv_n),
                log_2pi=float(f(LOG_2PI)))


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (round to nearest even) and back to float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _grads_plain(params: torch.Tensor, data: torch.Tensor, c: Dict,
                 ent_coef: float, bf16: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's forward and hand-derived backward in torch.
    Returns (grads (N_PARAMS,) in the flat layout with d log_std - ent_coef
    last, sums (4,): policy loss, value loss, kl, clip count).  `bf16`
    rounds the operands of the eight products (`r` below)."""
    r = bf16_round if bf16 else (lambda t: t)
    pi, vf, log_std = split_flat(params)
    x = data[:, _OBS:_ACT]
    act, old_logp = data[:, _ACT], data[:, _LOGP]
    adv, ret = data[:, _ADV], data[:, _RET]
    cls = torch.clamp(log_std[0], -4.0, 2.0)
    var = torch.exp(2.0 * cls)

    def forward(tower):
        w1, b1, w2, b2, wh, bh = tower
        h1 = torch.tanh(F.linear(r(x), r(w1), b1))
        h2 = torch.tanh(F.linear(r(h1), r(w2), b2))
        return h1, h2, r(h2) @ r(wh) + bh

    h1p, h2p, mean = forward(pi)
    h1v, h2v, value = forward(vf)

    diff = act - mean
    logp = -0.5 * (diff * diff / var + 2.0 * cls + c["log_2pi"])
    delta = logp - old_logp
    delta_in = torch.abs(delta) < 20.0
    delta_c = torch.clamp(delta, -20.0, 20.0)
    ratio = torch.exp(delta_c)
    lo, hi = c["lo"], c["hi"]
    in_band = (ratio > lo) & (ratio < hi)
    unclipped = adv * ratio
    clipped = adv * torch.clamp(ratio, lo, hi)
    pl_i = -torch.minimum(unclipped, clipped)
    verr = value - ret
    sums = torch.stack([
        pl_i.sum(), (verr * verr).sum(), ((ratio - 1.0) - delta_c).sum(),
        (torch.abs(ratio - 1.0) > c["eps"]).to(torch.float32).sum()])

    sel = (in_band | ((adv > 0.0) & (ratio < lo))
           | ((adv < 0.0) & (ratio > hi)))
    dlogp = (-(adv * ratio) * c["inv_n"]) * (sel & delta_in).to(torch.float32)
    dmean = dlogp * (diff / var)
    dls = (dlogp * (diff * diff / var - 1.0)).sum()
    dvalue = c["dvalue_scale"] * verr

    def tower_grads(tower, h1, h2, dout):
        w1, b1, w2, b2, wh, bh = tower
        g_wh = r(dout) @ r(h2)
        g_bh = dout.sum().reshape(1)
        e2 = (r(dout)[:, None] * r(wh)[None, :]) * (1.0 - h2 * h2)
        g_w2 = r(e2).T @ r(h1)
        g_b2 = e2.sum(0)
        e1 = (r(e2) @ r(w2)) * (1.0 - h1 * h1)
        g_w1 = r(e1).T @ r(x)
        g_b1 = e1.sum(0)
        return [g_w1.reshape(-1), g_b1, g_w2.reshape(-1), g_b2, g_wh, g_bh]

    grads = torch.cat(tower_grads(pi, h1p, h2p, dmean)
                      + tower_grads(vf, h1v, h2v, dvalue)
                      + [(dls - ent_coef).reshape(1)])
    return grads, sums


def _grads_plain_members(params: torch.Tensor, data: torch.Tensor, c: Dict,
                         ent_coef: float, bf16: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_grads_plain` member by member: params (P, N_PARAMS), data
    (P, N, 13) -> (grads (P, N_PARAMS), sums (P, 4))."""
    out = [_grads_plain(p, d, c, ent_coef, bf16)
           for p, d in zip(params, data)]
    return (torch.stack([g for g, _ in out]),
            torch.stack([s for _, s in out]))


def launch_blocks(P: int, n: int) -> Tuple[int, int]:
    """(rows per block, blocks per member and tower) of a launch: about
    2 * TARGET_BLOCKS first-pass blocks over all P members, in whole tiles."""
    tiles = -(-n // TILE_ROWS)
    per_tower = max(1, -(-TARGET_BLOCKS // P))
    rows_per_block = -(-tiles // per_tower) * TILE_ROWS
    return rows_per_block, -(-n // rows_per_block)


def _grads_cuda(params: torch.Tensor, data: torch.Tensor, c: Dict,
                ent_coef: float, bf16: bool = False,
                lib: ctypes.CDLL = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/ppo_grads.cu (both passes); same operands and outputs as
    _grads_plain_members.  `lib`: another build of the same C interface
    (`grads_ab`'s variants), else the package's."""
    P, n = data.shape[:2]
    _cuda.require(data, "minibatch", torch.float32, (P, n, N_COLS))
    _cuda.require(params, "params", torch.float32, (P, N_PARAMS))
    lib = lib or _cuda.load("ppo_grads")
    lib.acas_ppo_grads_partial_floats.restype = ctypes.c_longlong
    lib.acas_ppo_grads_partial_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    fn = lib.acas_ppo_grads
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_float] * 7 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5)
    rows_per_block, nblocks = launch_blocks(P, n)
    dev = data.device
    partial = torch.empty(lib.acas_ppo_grads_partial_floats(P, nblocks),
                          dtype=torch.float32, device=dev)
    grads = torch.empty(P, N_PARAMS, dtype=torch.float32, device=dev)
    sums = torch.empty(P, 4, dtype=torch.float32, device=dev)
    rc = fn(c["inv_n"], c["eps"], c["lo"], c["hi"], c["dvalue_scale"],
            c["log_2pi"], float(np.float32(ent_coef)), _cuda.ptr(data), P, n,
            rows_per_block, nblocks, int(bf16), _cuda.ptr(params),
            _cuda.ptr(partial),
            _cuda.ptr(grads), _cuda.ptr(sums), _cuda.stream_of(data))
    _cuda.check(rc, lib, "ppo_grads launch")
    ppo_minibatch_grads_members.launches += 1
    return grads, sums


def kernel_attrs(bf16: bool = False) -> Tuple[int, int, int, int, int]:
    """The first pass of the f32 or the bf16 variant as built on this card:
    (registers a thread, spilled bytes a thread, static shared bytes,
    dynamic shared bytes, resident blocks an SM)."""
    lib = _cuda.load("ppo_grads")
    out = (ctypes.c_int * 5)()
    lib.acas_ppo_grads_attrs.restype = ctypes.c_int
    lib.acas_ppo_grads_attrs.argtypes = [ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
    _cuda.check(lib.acas_ppo_grads_attrs(int(bf16), out), lib,
                "ppo_grads attrs")
    return tuple(out)


def _loss_aux(sums: torch.Tensor, n: int, log_std: torch.Tensor,
              ent_coef: float, vf_coef: float) -> Dict[str, torch.Tensor]:
    inv_n = 1.0 / n
    cls = torch.clamp(log_std.to(torch.float32), -4.0, 2.0)
    policy_loss = sums[..., 0] * inv_n
    value_loss = sums[..., 1] * inv_n
    entropy = float(np.float32(0.5 * (1.0 + LOG_2PI))) + cls
    return {
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy,
        "approx_kl": sums[..., 2] * inv_n,
        "clip_fraction": sums[..., 3] * inv_n,
        "loss": policy_loss + ent_coef * (-entropy) + vf_coef * value_loss,
    }


def ppo_minibatch_grads_members(params: torch.Tensor, mb_data: torch.Tensor,
                                *, clip_range: float, vf_coef: float,
                                ent_coef: float,
                                normalize_advantage: bool = True,
                                bf16: bool = False
                                ) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
    """Gradients of the clipped PPO loss for P members' minibatches in one
    launch.

    `params`: (P, N_PARAMS) flat vectors; `mb_data`: (P, N, 13), member m's
    minibatch in row m, with the RAW advantage column (normalised here per
    member when `normalize_advantage`); `bf16` rounds the products'
    operands to bf16.  Returns (grads (P, N_PARAMS) in the same layout, aux
    dict with ppo_loss's keys plus 'loss', each a (P,) tensor)."""
    P, n = mb_data.shape[:2]
    if mb_data.shape[2] != N_COLS:
        raise ValueError(f"the fused update needs obs_dim 8 / act_dim 1 "
                         f"(packed width 13, got {mb_data.shape[2]})")
    data = mb_data.to(torch.float32)
    if normalize_advantage:
        data = normalize_adv_column(data)
    data = data.contiguous()
    params = params.contiguous()
    c = _constants(n, clip_range, vf_coef)
    fn = _grads_cuda if data.is_cuda else _grads_plain_members
    grads, sums = fn(params, data, c, ent_coef, bf16)
    aux = _loss_aux(sums, n, params[:, -1], ent_coef, vf_coef)
    return grads, aux


def ppo_minibatch_grads(params: torch.Tensor, mb_data: torch.Tensor, *,
                        clip_range: float, vf_coef: float, ent_coef: float,
                        normalize_advantage: bool = True, bf16: bool = False
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Gradient of the clipped PPO loss for one packed minibatch: the P = 1
    call of `ppo_minibatch_grads_members`.

    `params`: the (N_PARAMS,) flat parameter vector; `mb_data`: (N, 13)
    with the RAW advantage column (normalised here when
    `normalize_advantage`).  Returns (grads (N_PARAMS,) in the same layout,
    aux dict with ppo_loss's keys plus 'loss', as 0-dim tensors)."""
    if mb_data.dim() != 2 or mb_data.shape[1] != N_COLS:
        raise ValueError(f"the fused update needs obs_dim 8 / act_dim 1 "
                         f"(packed (N, 13), got {tuple(mb_data.shape)})")
    grads, aux = ppo_minibatch_grads_members(
        params[None], mb_data[None], clip_range=clip_range, vf_coef=vf_coef,
        ent_coef=ent_coef, normalize_advantage=normalize_advantage, bf16=bf16)
    return grads[0], {k: v[0] for k, v in aux.items()}


ppo_minibatch_grads_members.launches = 0
