"""Fused policy-in-kernel PPO rollout: K autoreset steps per launch.

Counterpart of `acas2d_tpu/ops/pallas_policy.py:67-266,375-430`.  Each step
runs the actor-critic forward, a Box-Muller sample on the counter-based hash
RNG, the log-prob of the raw sample, the clipped action, the whole autoreset
env step (integration, geometry with the bug_compat quirks, shaped reward,
outcome codes, masked respawn) and the next observation.  The RNG streams
are the Pallas kernel's, so for the same seed, weights and state the port
and the TPU kernel draw the same samples.

`fused_policy_rollout_members` rolls P member policies, each on its own
B envs, in one launch (counterpart of `pallas_policy.py:433-501`): the envs
are one member-major index space of P * B envs, and member m's envs use
member m's weights.  The solo `fused_policy_rollout` is its P = 1 call.

The wrapper launches the CUDA kernel (`csrc/policy_rollout.cu`) for CUDA
tensors and runs the plain version (`_rollout_plain`, the same per-step
arithmetic in torch over the batch) for CPU tensors.  There is no fallback
between the two.  `fused_policy_rollout_members.launches` counts the
kernel's launches, solo or member (the replays of a captured training
iteration are counted by the loop that replays them,
`learner.make_train_loop`).  The kernel's launch shape (env rows a warp,
tiles a block) comes from `launch_shape`; it changes no output bit.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from acas2d_tpu_torch.config import DEFAULT_PARAMS, EnvParams
from acas2d_tpu_torch.models.actor_critic import (N_PARAMS, split_flat,
                                                  tower_forward)
from acas2d_tpu_torch.ops import _cuda
from acas2d_tpu_torch.ops import step_math as sm

STATE_KEYS = ("px", "py", "psi", "tx", "ty", "tv", "tpsi", "total_reward")
BUFFER_F32 = ("actions", "log_probs", "values", "rewards", "dones",
              "episode_return")
BUFFER_I32 = ("episode_steps", "outcome")


class _RolloutConsts(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_float) for n in sm.CONST_NAMES]
                + [("max_steps", ctypes.c_int)])


def _rollout_plain(c: Dict[str, float], max_steps: int, st: torch.Tensor,
                   steps: torch.Tensor, obs: torch.Tensor,
                   params: torch.Tensor, seed: int, step_offset: int, K: int):
    """The kernel's arithmetic in torch over the batch.  Same operands and
    outputs as the kernel, for P members of B envs (PB = P * B, member
    major): params (P, N_PARAMS), st (8, PB), steps (PB,) int32,
    obs (PB, 8) -> (st_out (9, PB), steps_out, obs_out, obs_buf (K, PB, 8),
    fbuf (6, K, PB), ibuf (2, K, PB)).  Each member's MLP runs on its own
    envs with its own weights."""
    P, PB = params.shape[0], st.shape[1]
    B = PB // P
    dev = st.device
    towers = [split_flat(p) for p in params]
    ls = torch.clamp(params[:, -1], -4.0, 2.0).repeat_interleave(B)
    sigma = torch.exp(ls)
    logp_const = -ls - c["half_log_2pi"]
    base = sm.rng_base(seed, torch.arange(PB, device=dev))

    def policy(x):
        """(mean, value), each (PB,): member m's towers on its envs."""
        xs = x.reshape(P, B, 8)
        mean = [tower_forward(xm, pi)[2] for xm, (pi, _, _) in zip(xs, towers)]
        value = [tower_forward(xm, vf)[2] for xm, (_, vf, _) in zip(xs, towers)]
        return torch.cat(mean), torch.cat(value)

    v, dt = c["v"], c["dt"]

    px, py, psi, tx, ty, tv, tpsi, tot = st.unbind(0)
    tcos = torch.cos(tpsi * sm.DEG2RAD)
    tsin = torch.sin(tpsi * sm.DEG2RAD)
    obs_buf = torch.empty(K, PB, 8, dtype=torch.float32, device=dev)
    fbuf = torch.empty(6, K, PB, dtype=torch.float32, device=dev)
    ibuf = torch.empty(2, K, PB, dtype=torch.int32, device=dev)
    a_live = torch.zeros_like(px)
    for i in range(K):
        step_id = step_offset + i
        # policy forward + gaussian sample (SB3 collect_rollouts)
        mean, value = policy(obs)
        u1 = sm._u01_hash(base, step_id, 4)
        u2 = sm._u01_hash(base, step_id, 5)
        z = (torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - u1, min=sm.f32(1e-12))))
             * torch.cos(sm.TWO_PI * u2))
        action = mean + sigma * z                     # raw sample
        dz = (action - mean) / sigma
        logp = logp_const - 0.5 * dz * dz
        a_lat = torch.clamp(action, -1.0, 1.0) * c["acc"]
        obs_buf[i] = obs
        fbuf[0, i], fbuf[1, i], fbuf[2, i] = action, logp, value

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
        timeout = steps > max_steps
        tdf = 1.0 - steps.to(torch.float32) * c["inv_max_steps"]
        reward = (r_step * tdf
                  + torch.where(collided, c["reward_collision"], 0.0)
                  + torch.where(at_goal, c["reward_goal"], 0.0))
        tot = tot + reward
        done = timeout | collided | at_goal
        outcome = torch.where(timeout, 3, torch.where(
            collided, 2, torch.where(at_goal, 1, 0))).to(torch.int32)
        fbuf[3, i], fbuf[4, i] = reward, done.to(torch.float32)
        fbuf[5, i] = torch.where(done, tot, 0.0)
        ibuf[0, i] = torch.where(done, steps, 0)
        ibuf[1, i] = outcome

        # masked respawn (reset_from semantics); observe() leaves steps == 1
        fpx, fpy, fpsi, ftx, fty, ftv, ftpsi = sm.respawn(
            sm._u01_hash(base, step_id, 1), sm._u01_hash(base, step_id, 2),
            sm._u01_hash(base, step_id, 3), c)
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

        # next observation; the closing-speed lookahead holds the live a_lat
        a_live = torch.where(done, 0.0, a_lat)
        pr = psi * sm.DEG2RAD
        cp, sp = torch.cos(pr), torch.sin(pr)
        geo = sm.env_geometry(px, py, cp, sp, psi, tx, ty, tv, tcos, tsin,
                              a_live, c)
        obs = sm.build_obs(steps, psi, *geo, c)

    st_out = torch.stack([px, py, psi, tx, ty, tv, tpsi, tot, a_live])
    return st_out, steps, obs, obs_buf, fbuf, ibuf


# csrc/policy_rollout.cu: a tile is 16 * MT envs of one member (MT m16 row
# tiles, 1 or 2) on WARPS_A_TILE[MT] warps, a block W tiles of at most
# MAX_WARPS warps in all; its split weights take the same shared memory at
# any W, which holds an SM to 2 blocks
WARPS_A_TILE = {1: 4, 2: 2}
MAX_WARPS = 16


def launch_shape(P: int, B: int, sms: int) -> Tuple[int, int]:
    """(MT, W) for P members of B envs on a card of `sms` SMs.  Tiles of
    32 rows (MT = 2, a warp a tower) share each weight load between 32
    rows, once there are rows enough to give every SM two such tiles
    (P * ceil(B / 32) >= 2 * sms); else tiles of 16 (MT = 1, two warps a
    tower), which spread the rows over four times the warps and the SMs.
    W is the largest power of two that keeps a block within MAX_WARPS and
    a member's tiles and still leaves a block for every SM
    (P * ceil(tiles / W) >= sms): at B = 2048, P = 1, (1, 1), 128 blocks of
    4 warps; at P = 32, B = 1024, (2, 4), 256 blocks of 8 warps, 2 an SM."""
    mt = 2 if P * -(-B // 32) >= 2 * sms else 1
    tiles = -(-B // (16 * mt))
    w = 1
    while (2 * w <= min(MAX_WARPS // WARPS_A_TILE[mt], tiles)
           and P * -(-tiles // (2 * w)) >= sms):
        w *= 2
    return mt, w


def seed_int32(seed) -> int:
    """The int32 bit pattern of a seed, which the kernel hashes."""
    return ((int(seed) + (1 << 31)) % (1 << 32)) - (1 << 31)


@functools.lru_cache(maxsize=8)
def _seed_on(seed32: int, device: torch.device) -> torch.Tensor:
    """A (1,) int32 tensor on `device` holding a seed: an int seed's
    device copy, made once, so that repeated launches from an int (the
    A/B tools' and the checks') copy nothing to the card and do not
    synchronise with it.  Nothing writes it."""
    return torch.tensor([seed32], dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def reads_seed(lib: ctypes.CDLL) -> bool:
    """Whether a build's entry point reads the seed from device memory (an
    earlier source's takes it as a value)."""
    return hasattr(lib, "acas_policy_rollout_reads_seed")


def _rollout_cuda(c: Dict[str, float], max_steps: int, st: torch.Tensor,
                  steps: torch.Tensor, obs: torch.Tensor,
                  params: torch.Tensor, seed, step_offset: int, K: int,
                  lib: Optional[ctypes.CDLL] = None,
                  shape: Optional[Tuple[int, ...]] = None):
    """Launch csrc/policy_rollout.cu; same operands/outputs as
    _rollout_plain.  `seed`: an int, or a (1,) int32 tensor on the card
    holding its bit pattern, which the kernel reads when it runs (a CUDA
    graph's replays read what was written there last).  `lib`: another
    build of a source with the same C interface (the A/B tool's), whose
    entry point may take the seed as a value (`reads_seed`); `shape`: the
    launch-shape arguments of its entry point, (MT, W), by default
    `launch_shape` on this card's SMs (an entry point without them takes
    ())."""
    P, PB = params.shape[0], st.shape[1]
    _cuda.require(params, "params", torch.float32, (P, N_PARAMS))
    _cuda.require(st, "state", torch.float32, (8, PB))
    if PB % P:
        raise ValueError(f"{PB} envs do not split over {P} members")
    _cuda.require(steps, "steps", torch.int32, (PB,))
    _cuda.require(obs, "obs", torch.float32, (PB, 8))
    lib = lib or _cuda.load("policy_rollout")
    if shape is None:
        shape = launch_shape(P, PB // P, _sms(st.device))
    if not reads_seed(lib):
        seed_arg = ctypes.c_int(seed_int32(seed))
    elif torch.is_tensor(seed):
        _cuda.require(seed, "seed", torch.int32, (1,))
        seed_arg = _cuda.ptr(seed)
    else:
        seed_arg = _cuda.ptr(_seed_on(seed_int32(seed), st.device))
    fn = lib.acas_policy_rollout
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.POINTER(_RolloutConsts)] + [ctypes.c_int] * 3
                   + [type(seed_arg)] + [ctypes.c_int] * (1 + len(shape))
                   + [ctypes.c_void_p] * 11)
    dev = st.device
    st_out = torch.empty(9, PB, dtype=torch.float32, device=dev)
    steps_out = torch.empty(PB, dtype=torch.int32, device=dev)
    obs_out = torch.empty(PB, 8, dtype=torch.float32, device=dev)
    obs_buf = torch.empty(K, PB, 8, dtype=torch.float32, device=dev)
    fbuf = torch.empty(6, K, PB, dtype=torch.float32, device=dev)
    ibuf = torch.empty(2, K, PB, dtype=torch.int32, device=dev)
    consts = _RolloutConsts(**c, max_steps=max_steps)
    rc = fn(ctypes.byref(consts), P, PB // P, K, seed_arg, int(step_offset),
            *shape, _cuda.ptr(params), _cuda.ptr(st), _cuda.ptr(steps),
            _cuda.ptr(obs), _cuda.ptr(st_out), _cuda.ptr(steps_out),
            _cuda.ptr(obs_out), _cuda.ptr(obs_buf), _cuda.ptr(fbuf),
            _cuda.ptr(ibuf), _cuda.stream_of(st))
    _cuda.check(rc, lib, "policy_rollout launch")
    fused_policy_rollout_members.launches += 1
    return st_out, steps_out, obs_out, obs_buf, fbuf, ibuf


def kernel_attrs(mt: int, w: int, lib: Optional[ctypes.CDLL] = None
                 ) -> Tuple[int, int, int, int]:
    """The kernel at launch shape (mt, w) as built for this card:
    (registers a thread, local memory bytes a thread, dynamic shared memory
    bytes a block, resident blocks an SM)."""
    lib = lib or _cuda.load("policy_rollout")
    out = (ctypes.c_int * 4)()
    lib.acas_policy_rollout_attrs.restype = ctypes.c_int
    lib.acas_policy_rollout_attrs.argtypes = [ctypes.c_int, ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_int)]
    _cuda.check(lib.acas_policy_rollout_attrs(mt, w, out), lib,
                "policy_rollout attrs")
    return tuple(out)


# SASS opcodes counted by `sass_census` (modifiers dropped): tensor-core
# products, the float32 pipe, shared memory, the special-function unit,
# shuffles, barriers, local memory
SASS_KINDS = ("HMMA", "FFMA", "FADD", "FMUL", "LDS", "STS", "MUFU", "SHFL",
              "BAR", "LDL", "STL")


def sass_census(lib_file: Optional[Path] = None
                ) -> Dict[int, Dict[str, int]]:
    """`cuobjdump -sass` of a build of csrc/policy_rollout.cu (the
    package's, else `lib_file`): for the kernel of each MT (0 for a kernel
    that is no template of MT), its instructions by SASS_KINDS, "all", and
    each HMMA opcode with its modifiers (e.g. `HMMA.1688.F32.TF32`)."""
    out = {}
    listing = _cuda.sass_listing(lib_file or _cuda.lib_path("policy_rollout"))
    for name, instrs in listing.items():
        if "policy_rollout_kernel" not in name:
            continue
        mt = re.search(r"policy_rollout_kernelILi(\d+)E", name)
        c = dict.fromkeys(SASS_KINDS, 0)
        for _, op, _ in instrs:
            kind = op.split(".")[0]
            if kind in c:
                c[kind] += 1
            if kind == "HMMA":
                c[op] = c.get(op, 0) + 1
        c["all"] = len(instrs)
        out[int(mt.group(1)) if mt else 0] = c
    return out


def fused_policy_rollout_members(state: Dict[str, torch.Tensor],
                                 obs: torch.Tensor, params: torch.Tensor,
                                 seed, step_offset: int, K: int,
                                 env_params: EnvParams = DEFAULT_PARAMS
                                 ) -> Tuple[Dict[str, torch.Tensor],
                                            Dict[str, torch.Tensor]]:
    """Run K fused policy+env autoreset steps for P member policies, each on
    its own B envs, in one launch.

    `state`: (P, B) float32 tensors px, py, psi, tx, ty, tv, tpsi,
    total_reward and int32 steps (one traffic aircraft); `obs` (P, B, 8);
    `params`: (P, N_PARAMS) flat vectors, member m's in row m.  Returns
    (final state with (P, B) leaves, 'obs' (P, B, 8) and 'pa_lat' — the
    last applied lateral acceleration, 0 for envs respawned on their final
    step —, buffers with time-major (K, P, B) leaves and obs (K, P, B, 8)).
    The JAX wrapper returns its buffers member-major, (P, K, B); the port
    keeps the kernel's layout, which is the learner's.  `seed`: an int, or
    a (1,) int32 tensor on the state's device holding its bit pattern
    (the kernel reads it from device memory, so a CUDA graph's replays
    take a new seed; the plain version reads its value).  `step_offset`
    advances the per-step RNG counter across chunked launches.
    """
    P, B = state["px"].shape
    c = sm.kernel_constants(env_params)
    st = torch.stack([state[k].to(torch.float32).reshape(P * B)
                      for k in STATE_KEYS])
    steps = state["steps"].to(torch.int32).reshape(P * B).contiguous()
    obs = obs.to(torch.float32).reshape(P * B, 8).contiguous()
    params = params.contiguous()
    if st.is_cuda:
        fn = _rollout_cuda
    else:
        fn = _rollout_plain
        seed = int(seed.reshape(-1)[0]) if torch.is_tensor(seed) else seed
    st_out, steps_out, obs_out, obs_buf, fbuf, ibuf = fn(
        c, env_params.max_steps, st, steps, obs, params, seed, step_offset, K)
    st_out = st_out.view(9, P, B)
    final = dict(zip(STATE_KEYS, st_out[:8]))
    final.update(steps=steps_out.view(P, B), obs=obs_out.view(P, B, 8),
                 pa_lat=st_out[8])
    buffers = dict(zip(BUFFER_F32, fbuf.view(6, K, P, B)))
    buffers.update(zip(BUFFER_I32, ibuf.view(2, K, P, B)))
    buffers["obs"] = obs_buf.view(K, P, B, 8)
    return final, buffers


def fused_policy_rollout(state: Dict[str, torch.Tensor], obs: torch.Tensor,
                         params: torch.Tensor, seed, step_offset: int,
                         K: int, env_params: EnvParams = DEFAULT_PARAMS
                         ) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """Run K fused policy+env autoreset steps of one policy: the P = 1 call
    of `fused_policy_rollout_members`.

    `state`: (B,) float32 tensors px, py, psi, tx, ty, tv, tpsi,
    total_reward and int32 steps (one traffic aircraft); `obs` (B, 8);
    `params`: the (N_PARAMS,) flat vector of `models.actor_critic`.
    Returns (final state with (B,) leaves, 'obs' (B, 8) and 'pa_lat',
    buffers with (K, B) leaves and obs (K, B, 8)).
    """
    final, buffers = fused_policy_rollout_members(
        {k: v[None] for k, v in state.items()}, obs[None], params[None],
        seed, step_offset, K, env_params)
    return ({k: v[0] for k, v in final.items()},
            {k: v[:, 0] for k, v in buffers.items()})


fused_policy_rollout_members.launches = 0
