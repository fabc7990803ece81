"""Fused env-only rollout: T autoreset steps per launch, random or zero actions.

Counterpart of `acas2d_tpu/ops/pallas_step.py:205-417` (`fused_rollout`),
the kernel behind the env-steps/s headline (`bench.py`).  Each env runs T
steps of the environment under a uniform action drawn from the
counter-based hash RNG (salt 0; or a forced zero action), with the masked
respawn on salts 1-3, and returns its final state and five per-env sums:
reward, episodes ended, goals, collisions and, with `with_obs`, a checksum
of the eight observation features of every post-step (post-respawn) state.
The RNG streams are the Pallas kernel's, so the port and the TPU kernel
draw the same actions and respawns for the same seed and state.

The wrapper launches the CUDA kernel (`csrc/env_rollout.cu`) for CUDA
tensors and runs the plain version (`_env_rollout_plain`, the same
per-step arithmetic in torch over the batch) for CPU tensors.  There is no
fallback between the two.  `fused_rollout.launches` counts the kernel's
launches.  `agreement` is the rule by which the kernel's outputs are held
to the plain version's (by `chip_smoke.py` and the card-only tests).
`kernel_attrs` and `sass_census` read what the card's compiler made of the
kernel: registers, local memory, blocks an SM, and its instructions by
kind, in all and in the body of its loop over the T steps.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from acas2d_tpu_torch.config import DEFAULT_PARAMS, EnvParams
from acas2d_tpu_torch.ops import _cuda
from acas2d_tpu_torch.ops import step_math as sm
from acas2d_tpu_torch.ops.policy_rollout import _RolloutConsts

STATE_KEYS = ("px", "py", "psi", "tx", "ty", "tv", "tpsi", "steps",
              "total_reward")
STAT_KEYS = ("reward_sum", "episodes", "goals", "collisions", "obs_sum")
INT_KEYS = ("steps", "episodes", "goals", "collisions")
SUM_KEYS = ("total_reward", "reward_sum", "obs_sum")
REWARD_KEYS = ("total_reward", "reward_sum")

# Agreement of the kernel with the plain version after T steps (`agreement`).
# The kernel contracts `x + v * c * dt` into one fused multiply-add where
# torch rounds twice, and its sinf/cosf may differ from the CPU's by an
# ulp: a position moves by up to an ulp a step, with the same sign every
# step for straight-flying traffic.  So state fields are held to
# ULPS_PER_STEP ulps of their largest magnitude a step.  A step's reward
# and obs features carry the sines' ulp (SUM_ATOL_PER_STEP) plus the drift
# of the positions, which grows with the step t (SUM_DRIFT * t): the sums
# are held to T * SUM_ATOL_PER_STEP + T^2 * SUM_DRIFT.  An ulp can flip a
# float32 threshold: the collision or goal distance (an episode ends a step
# apart; that env then draws other respawns and its later state differs
# entirely), the floor of the goal bearing's wrap at 0/360 degrees (that
# step's feature moves by 1, so obs_sum differs by an integer), or the sign
# of the closing speed, where the reward switches between its two shapes
# (that step's reward moves by at most 1, the heading term times the
# difference of two terms in [0, 1], so reward_sum differs by at most 1
# while the state and the obs, which hold the closing speed itself, do
# not move).  At most MAX_FLIPPED of the envs may flip.  The floats of an
# env that flips a threshold of the first two kinds are left out; one
# whose reward branch flipped is left out of the reward sums only, its
# total_reward held to within 1 + their tolerance.  The heading may differ
# by 360 only where it lies within its tolerance of 0/360.
ULPS_PER_STEP, SUM_ATOL_PER_STEP, SUM_DRIFT = 2, 5e-5, 5e-7
MAX_FLIPPED = 1e-3


def flat_state(states) -> Dict[str, torch.Tensor]:
    """The nine (B,) arrays `fused_rollout` takes, from an engine state
    (`envs.core.EnvState`, one traffic aircraft)."""
    return dict(px=states.px, py=states.py, psi=states.ppsi,
                tx=states.tx[:, 0], ty=states.ty[:, 0], tv=states.tv[:, 0],
                tpsi=states.tpsi[:, 0], steps=states.steps,
                total_reward=states.total_reward)


def field_tol(key: str, want: torch.Tensor, T: int) -> float:
    """The tolerance of output `key` (plain-version values `want`) after T
    steps."""
    if key in SUM_KEYS:
        return T * SUM_ATOL_PER_STEP + T * T * SUM_DRIFT
    top = max(float(want.abs().max()), 1e-30)
    return T * ULPS_PER_STEP * 2.0 ** (math.floor(math.log2(top)) - 23)


def agreement(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              T: int):
    """Hold the kernel's outputs `got` (state and stats in one dict, any
    device) against the plain version's `want` by the rule above.  Returns
    (flipped env indices, {float key: (max abs err, tol)} over the other
    envs, [what breaks the rule])."""
    got = {k: v.to(want[k].device) for k, v in got.items()}
    flipped = torch.zeros_like(want["steps"], dtype=torch.bool)
    failed = []
    for k, w in want.items():
        if got[k].shape != w.shape or got[k].dtype != w.dtype:
            failed.append(f"{k}: {got[k].shape} {got[k].dtype}")
        elif not torch.is_floating_point(w):
            flipped |= got[k] != w
    if failed:
        return flipped.nonzero()[:, 0], {}, failed
    tol_obs = field_tol("obs_sum", want["obs_sum"], T)
    d_obs = (got["obs_sum"] - want["obs_sum"]).abs()
    flipped |= (d_obs > tol_obs) & ((d_obs - d_obs.round()).abs() <= tol_obs)
    # a closing-speed flip moves only the rewards: the env's state and
    # obs_sum stay held, and its total_reward to the same 1 + tol
    tol_r = field_tol("reward_sum", want["reward_sum"], T)
    d_r = (got["reward_sum"] - want["reward_sum"]).abs()
    branch = (d_r > tol_r) & (d_r <= 1.0 + tol_r) & ~flipped
    d_tot = (got["total_reward"] - want["total_reward"]).abs()
    if bool((d_tot[branch] > 1.0 + tol_r).any()):
        failed.append("total_reward of a reward flip")
    n_flipped = int((flipped | branch).sum())
    if n_flipped > MAX_FLIPPED * flipped.numel():
        failed.append(f"{n_flipped} envs flipped")
    errs = {}
    for k, w in want.items():
        if not torch.is_floating_point(w):
            continue
        keep = ~(flipped | branch) if k in REWARD_KEYS else ~flipped
        g, w = got[k][keep], w[keep]
        d = (g - w).abs()
        tol = field_tol(k, w, T)
        if k == "psi":
            near_wrap = torch.minimum(w, 360.0 - w) <= tol
            d = torch.where(near_wrap, torch.minimum(d, 360.0 - d), d)
        errs[k] = (float(d.max()) if d.numel() else 0.0, tol)
        if errs[k][0] > tol:
            failed.append(k)
    return (flipped | branch).nonzero()[:, 0], errs, failed


def _env_rollout_plain(c: Dict[str, float], max_steps: int,
                       state: Dict[str, torch.Tensor], seed: int, T: int,
                       zero_actions: bool, with_obs: bool):
    """The kernel's arithmetic in torch over the batch (pallas_step.py:
    233-347): (state dict, stats dict) of (B,) tensors."""
    px, py, psi, tx, ty, tv, tpsi = (state[k] for k in STATE_KEYS[:7])
    steps, tot = state["steps"], state["total_reward"]
    B = px.shape[0]
    base = sm.rng_base(seed, torch.arange(B, device=px.device))
    v, dt = c["v"], c["dt"]
    tr = tpsi * sm.DEG2RAD
    tcos, tsin = torch.cos(tr), torch.sin(tr)
    rs = torch.zeros_like(px)
    os_ = torch.zeros_like(px)
    ec = torch.zeros_like(steps)
    gc = torch.zeros_like(steps)
    cc = torch.zeros_like(steps)
    for i in range(T):
        if zero_actions:
            a_lat = torch.zeros_like(px)
        else:
            a_lat = (sm._u01_hash(base, i, 0) * 2.0 - 1.0) * c["acc"]
        # integrate player + traffic (aircraft.py:16-26)
        psi = sm._mod360(psi + a_lat / v)
        pr = psi * sm.DEG2RAD
        cp, sp = torch.cos(pr), torch.sin(pr)
        px = px + v * cp * dt
        py = py + v * sp * dt
        tx = tx + tv * tcos * dt
        ty = ty + tv * tsin * dt
        steps = steps + 1

        d_goal, h_goal_rad, d_dev, d_sep, d_cpa, v_closing = sm.env_geometry(
            px, py, cp, sp, psi, tx, ty, tv, tcos, tsin, a_lat, c)
        r_step = sm.shaped_step_reward(
            psi, h_goal_rad * sm.f32(1.0 / sm.DEG2RAD), d_goal, d_dev, d_cpa,
            v_closing, c)
        collided = d_sep < c["coll_dist"]
        at_goal = d_goal < c["goal_radius"]
        in_time = steps <= max_steps
        tdf = 1.0 - steps.to(torch.float32) * c["inv_max_steps"]
        reward = (r_step * tdf
                  + torch.where(collided, c["reward_collision"], 0.0)
                  + torch.where(at_goal, c["reward_goal"], 0.0))
        tot = tot + reward
        rs = rs + reward

        # termination: timeout > collision > goal (game.py:294-314)
        done = ~in_time | collided | at_goal
        ec = ec + done.to(torch.int32)
        gc = gc + (at_goal & ~collided & in_time).to(torch.int32)
        cc = cc + (collided & in_time).to(torch.int32)

        # masked respawn; observe() leaves steps == 1 (game.py:197)
        fpx, fpy, fpsi, ftx, fty, ftv, ftpsi = sm.respawn(
            sm._u01_hash(base, i, 1), sm._u01_hash(base, i, 2),
            sm._u01_hash(base, i, 3), c)
        ftr = ftpsi * sm.DEG2RAD
        px = torch.where(done, fpx, px)
        py = torch.where(done, fpy, py)
        psi = torch.where(done, fpsi, psi)
        tx = torch.where(done, ftx, tx)
        ty = torch.where(done, fty, ty)
        tv = torch.where(done, ftv, tv)
        tpsi = torch.where(done, ftpsi, tpsi)
        tcos = torch.where(done, torch.cos(ftr), tcos)
        tsin = torch.where(done, torch.sin(ftr), tsin)
        steps = torch.where(done, 1, steps).to(torch.int32)
        tot = torch.where(done, 0.0, tot)

        if with_obs:
            # the post-respawn observation; the lookahead holds the live a_lat
            a_live = torch.where(done, 0.0, a_lat)
            pr2 = psi * sm.DEG2RAD
            geo = sm.env_geometry(px, py, torch.cos(pr2), torch.sin(pr2), psi,
                                  tx, ty, tv, tcos, tsin, a_live, c)
            # added one feature at a time, in the kernel's order
            for f in sm.build_obs(steps, psi, *geo, c).unbind(-1):
                os_ = os_ + f
    final = dict(zip(STATE_KEYS, (px, py, psi, tx, ty, tv, tpsi, steps, tot)))
    stats = dict(zip(STAT_KEYS, (rs, ec, gc, cc, os_)))
    return final, stats


def _env_rollout_cuda(c: Dict[str, float], max_steps: int,
                      state: Dict[str, torch.Tensor], seed: int, T: int,
                      zero_actions: bool, with_obs: bool,
                      lib: Optional[ctypes.CDLL] = None):
    """Launch csrc/env_rollout.cu; same operands and outputs as
    _env_rollout_plain.  `lib`: another build of the same C interface
    (`env_ab`'s variants and sources), else the package's."""
    B = state["px"].shape[0]
    for k in STATE_KEYS:
        _cuda.require(state[k], k, torch.int32 if k == "steps"
                      else torch.float32, (B,))
    lib = lib or _cuda.load("env_rollout")
    fn = lib.acas_env_rollout
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.POINTER(_RolloutConsts)] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3)
    dev = state["px"].device
    outs = [torch.empty(B, dtype=torch.int32 if k in INT_KEYS
                        else torch.float32, device=dev)
            for k in STATE_KEYS + STAT_KEYS]
    ins = (ctypes.c_void_p * len(STATE_KEYS))(
        *(state[k].data_ptr() for k in STATE_KEYS))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
    consts = _RolloutConsts(**c, max_steps=max_steps)
    # the kernel takes the seed's int32 bit pattern
    seed32 = ((int(seed) + (1 << 31)) % (1 << 32)) - (1 << 31)
    rc = fn(ctypes.byref(consts), B, T, seed32, int(zero_actions),
            int(with_obs), ctypes.cast(ins, ctypes.c_void_p),
            ctypes.cast(out_ptrs, ctypes.c_void_p),
            _cuda.stream_of(state["px"]))
    _cuda.check(rc, lib, "env_rollout launch")
    fused_rollout.launches += 1
    n = len(STATE_KEYS)
    return dict(zip(STATE_KEYS, outs[:n])), dict(zip(STAT_KEYS, outs[n:]))


def fused_rollout(state: Dict[str, torch.Tensor], seed: int, T: int,
                  params: EnvParams = DEFAULT_PARAMS,
                  zero_actions: bool = False, with_obs: bool = False
                  ) -> Tuple[Dict[str, torch.Tensor],
                             Dict[str, torch.Tensor]]:
    """Run T autoreset steps with in-kernel random (or zero) actions.

    `state`: the nine flat (B,) arrays px, py, psi, tx, ty, tv, tpsi (one
    traffic aircraft), steps (int32) and total_reward; B a multiple of
    1024, as the Pallas kernel requires (pallas_step.py:383).  Returns
    (final state, the same keys; stats: reward_sum, episodes, goals,
    collisions, obs_sum), each (B,).  `obs_sum` checksums the full
    post-step observation of every step when `with_obs`, and is 0
    otherwise.
    """
    c = sm.kernel_constants(params)
    B = state["px"].shape[0]
    if B % sm.LANES:
        raise ValueError(f"batch {B} must be a multiple of {sm.LANES}")
    st = {k: state[k].to(torch.int32 if k == "steps" else torch.float32)
          .reshape(B).contiguous() for k in STATE_KEYS}
    fn = _env_rollout_cuda if st["px"].is_cuda else _env_rollout_plain
    return fn(c, params.max_steps, st, seed, T, zero_actions, with_obs)


fused_rollout.launches = 0


# ------------------------------------------------- what the compiler made

# (zero_actions, with_obs) -> the instantiation's mark in its mangled name
INSTANTIATIONS = {(z, o): f"env_rollout_kernelILb{int(z)}ELb{int(o)}E"
                  for z in (False, True) for o in (False, True)}
# SASS opcodes counted by `census` (modifiers dropped): the float32 pipe,
# the special-function unit, the IEEE divide's range check, the integer
# pipe, branches and calls, local memory
SASS_KINDS = ("FFMA", "FMUL", "FADD", "MUFU", "FCHK", "IMAD", "LOP3", "SHF",
              "BRA", "CALL", "LDL", "STL")


def kernel_attrs(zero_actions: bool, with_obs: bool,
                 lib: Optional[ctypes.CDLL] = None) -> Tuple[int, int, int]:
    """One instantiation as built for this card: (registers a thread,
    local memory bytes a thread, resident blocks of 128 threads an SM)."""
    lib = lib or _cuda.load("env_rollout")
    out = (ctypes.c_int * 3)()
    lib.acas_env_rollout_attrs.restype = ctypes.c_int
    lib.acas_env_rollout_attrs.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int)]
    _cuda.check(lib.acas_env_rollout_attrs(int(zero_actions), int(with_obs),
                                           out), lib, "env_rollout attrs")
    return tuple(out)


def loop_body(instrs: List[_cuda.Instr]) -> List[_cuda.Instr]:
    """The instructions of the T-step loop: from the target of the
    backward branch that spans the most addresses before the kernel's last
    EXIT (code after it is reached only by calls and branches from the
    body) to that branch."""
    last_exit = max((a for a, op, _ in instrs if op.startswith("EXIT")),
                    default=math.inf)
    spans = [(a - t, t, a) for a, _, t in instrs
             if t is not None and t < a < last_exit]
    if not spans:
        return []
    _, lo, hi = max(spans)
    return [ins for ins in instrs if lo <= ins[0] <= hi]


def census(instrs: List[_cuda.Instr]) -> Dict[str, int]:
    """Instructions by SASS_KINDS, and "all"."""
    out = dict.fromkeys(SASS_KINDS, 0)
    for _, op, _ in instrs:
        kind = op.split(".")[0]
        if kind in out:
            out[kind] += 1
    out["all"] = len(instrs)
    return out


def sass_census(lib_file: Optional[Path] = None
                ) -> Dict[Tuple[bool, bool], Dict[str, Dict[str, int]]]:
    """`cuobjdump -sass` of a build of csrc/env_rollout.cu (the
    package's, else `lib_file`): for each instantiation (zero_actions,
    with_obs), the census of the whole kernel ("kernel") and of its loop's
    body ("loop")."""
    listing = _cuda.sass_listing(lib_file or _cuda.lib_path("env_rollout"))
    out = {}
    for key, mark in INSTANTIATIONS.items():
        instrs = next(v for k, v in listing.items() if mark in k)
        out[key] = {"kernel": census(instrs),
                    "loop": census(loop_body(instrs))}
    return out
