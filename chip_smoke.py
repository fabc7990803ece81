"""Chip smoke test of the PyTorch/CUDA port (acas2d_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. build the CUDA kernels from acas2d_tpu_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all at once; the registers, spills, shared memory
     and blocks an SM of the gradient kernel's two variants, and their
     instructions from `cuobjdump -sass`, which must include tensor-core
     HMMAs of their type (TF32 for f32, BF16 for bf16); the registers,
     local memory and blocks an SM of the env rollout's four
     instantiations, and their instructions by kind, in all and in the
     T-step loop's body; the policy rollout's registers, stack frame,
     spills (which must be 0), dynamic shared memory and blocks an SM at
     the main paths' launch shapes, and its instructions by kind, whose
     products must be TF32 HMMAs and no other;
  2. the rollout kernel against its plain PyTorch version, same seed,
     weights and state: the public wrapper on tensors on the card against
     the same call on copies on the CPU.  Solo (B = 2048 envs, K = 16) and
     member grid (P = 32 members x B = 1024 envs, K = 16, the population
     pipeline's launch); beside the tolerance, the bound on the values' and
     actions' errors that a build with 1xTF32 products fails;
  3. the PPO-gradient kernel against its plain version the same way, solo
     (N = 65,536 rows) and member-batched (P = 32 x N = 32,768), with the
     `tpu` preset's loss settings and again with ent_coef 0.01; then two
     launches on the same operands, which must agree bit for bit;
  4. the solo main path: `acas2d_tpu_torch.train` on the fused paths
     (`--fused-rollout --fused-update`, SOLO_ARGV) at the full `tpu` preset
     shape (2048 x 128, minibatch 65,536, 10 epochs) for 3 iterations, one
     eager iteration a call (--iters-per-call 1), with the launch counters
     read around it (8 rollout and 40 gradient launches per iteration) and
     every metric finite; then one more iteration of the learner's step cut
     into rollout / GAE / update by its phase hook;
  5. the population main path: the shipped pipeline's command
     (scripts/population_pipeline.sh) for 3 iterations, one a call
     (--iters-per-call 1; --population 32
     --n-envs 1024 --minibatch-size 32768 --anneal-lr --fused-rollout
     --fused-update-packed --eval-episodes 32), with the re-eval cut from
     512 to 64 episodes and one polish round of one iteration at
     --polish-pop 16; the launch counters read around it (8 rollout and 40
     gradient launches per iteration, whatever P is), every metric finite,
     the selected policy through the port's exact eval (finite, no score
     gate); then one more population iteration cut into rollout / GAE /
     update;
  6. exact evaluation (float64 env) of artifacts/ppo_tpu_e_polished_best.npz,
     100 episodes (the greedy loop as replayed CUDA graphs), held to its
     committed record, with its episode CSV (`--out`, the telemetry
     rollout of the same spawns): 100 goals whose mean Total Reward is the
     summary's;
  7. the env-only rollout kernel against its plain version (B = 32,768 envs
     flown part-way so that collisions, goals and timeouts occur, T = 256,
     random actions without and with the observation checksum, and zero
     actions); its zero-action run against the port's general engine
     (B = 1024, T = 64); and a 5-sigma comparison of outcome rates with the
     engine under random actions (B = 65,536, T = 2048);
  8. the env-stepping headline of `python -m acas2d_tpu_torch.bench` at
     its full size (B = 262,144, T = 256): its two measures, without and
     with obs, each with the launch counters read around it (one warm-up
     plus 8 x 3 launches), and its JSON line; then the bench's `--train`
     mode;
  9. the gradient kernel's bf16 variant against its plain version, solo
     (N = 65,536) and member-batched (P = 32 x N = 32,768), its deviation
     from the f32 kernel, and the precision probe, whose answer must agree
     with that deviation; then bf16 training, one iteration a call, solo
     (SOLO_ARGV with `--fused-update-bf16`, 3 iterations) and one
     population iteration, with
     the launch counters read around each, and one more bf16 population
     iteration cut into rollout / GAE / update;
 10. kernel and plain-version times from CUDA events, each kernel's bound,
     the card's name and power limit.  The env rollout is first held
     against its plain version at the headline shape, on the state each
     of the bench's measures left, then timed in chained launches from
     there: the kernel alone, and the wall per launch as the bench
     launches, whose difference is the card's idle share; beside it, the
     time the launch would take at the card's full issue rate (4
     instructions a clock an SM) if every instruction of its loop body,
     the rare paths included, issued every step: an upper bound of that
     time from the static count, not a measured share;
 11. the pipeline's in-training eval (32 members x 32 episodes) and the
     solo preset's (10 episodes) through the eager greedy loop and through
     its 64-step chunks replayed as CUDA graphs (`learner.GreedyEval`):
     returns, lengths and outcomes bit-identical, both timed;
 12. a whole solo run, `train` with SOLO_ARGV at its default budget (32
     iterations, at the default 4 a call: replays of a captured iteration;
     evals of 10 episodes every 4, a checkpoint every call), with the
     launch counters read around it, its kept checkpoints, best/ and
     summary.json checked, its wall time and the evals' part of it; then
     `eval --run DIR --best --exact --episodes 100` (finite; no score gate:
     one seed of a 32-iteration run);
 13. exact resume of runs of K > 1 iterations a call: 6 solo iterations,
     3 a call, straight against 3 and a --resume to 6; the population
     command (P = 32, the default 8 a call) for 16 iterations against the
     same command stopped by a Ctrl-C in the middle of its second call and
     resumed; params, Adam moments and env state bit-identical;
 14. the shipped pipeline (`python -m acas2d_tpu_torch.pipeline`) at a cut
     budget: phase 5's stage 1 and two polish rounds, each one call of the
     default 8 iterations, a gate no policy reaches and two attempts; the
     launch counters read around it, its 6 candidate dirs (each stage 1
     among them), the merge record of each polish stage, the `_final`
     record against the committed artifact's keys, and its strict eval's
     CSV against the exact eval of the kept policy, episode for episode;
 15. K iterations a call as replays of one iteration captured as a CUDA
     graph (`learner.make_train_loop`, `population.make_population_loop`)
     against as many eager steps from the same state and generators: the
     solo `tpu` preset (K = 4), the pipeline's P = 32 (K = 8) and solo
     bf16 (K = 4), two calls each (the first builds the graph from its
     first iteration): params, Adam moments, env state, obs, metrics and
     generators bit-identical, the launch counters at K x (8 + 40) a call;
     eager against replayed ms an iteration, in turns; the peak memory of
     each; and the card's busy share (the union of the kernels' intervals
     over the window) of a `train --profile` trace of calls 2-4, solo and
     at P = 32;
 16. the paths `train.py` runs by default (JAX's) and the mixed ones: the
     solo `tpu` preset on the step-by-step rollout with the autograd
     update, on the fused rollout with the autograd update, and on the
     step-by-step rollout with the fused update, 3 iterations each
     through `train.run`, one a call, the launch counters read around
     each (0, 8 rollout and 40 gradient launches an iteration); phase
     15's check of each of the three (2 calls of K = 4 replays against 8
     eager steps, bit for bit, eager and replayed ms in turns); the
     step-by-step rollout with the bf16 update for 3 iterations; the
     pipeline's shape (P = 32) on the three pairs, 2 iterations each,
     with their launch counters; one eager
     iteration of the reference configuration of record (1 env x 2048
     steps, minibatch 64), cut into its phases; and one unfused `tpu`
     iteration in float64 on the card against the CPU;
 17. the multi-process paths (`acas2d_tpu_torch/parallel/`) on the card:
     (a) `train` with SOLO_ARGV, 8 iterations at 4 a call, under
     `python -m torch.distributed.run --nproc-per-node 1` (a group of one
     over NCCL, whose collectives the replayed graph holds) and alone, one
     intra-op thread each: final checkpoints and every row's metrics bit
     for bit, 8 rollout and 40 gradient launches an iteration in each
     (their summaries); (b) two ranks sharing cuda:0 over gloo
     (`parallel/dryrun.py` through `parallel/launch.py`): the xla,
     fused_rollout and fused_update variants of JAX's dryrun_multichip at
     the solo `tpu` shape (1024 envs a rank), 2 iterations each, and the
     pipeline's fused P = 32 (16 members a rank), one iteration; the
     unfused variants against one process within SHARDED_TOL, each rank's
     first fused rollout chunk bit for bit against one launch of the
     kernel on its rows at seed + 7919 r, every rank's launches; (c)
     `bench --scaling` under a launch of one;
 18. the host-side surface on the card, which launches no kernel: (a) the
     env checker on the core (200 steps) and on `LegacyACAS2DEnv` (100
     steps); (b) the reference's recorded actions
     (artifacts/gym_main_actions.npy) through `LegacyACAS2DEnv` in float64
     against the port's scalar `OracleEnv` from the same spawn (px within
     1e-9, each reward within 1e-12, done, outcome and steps exact), and
     the median ms a gym step; (c) `python -m acas2d_tpu_torch.baseline
     --episodes 100` on the card against the same command on the CPU
     (outcomes and steps equal, paths within 1e-9 px, returns within
     1e-8), the count of bit-identical paths and the card run's wall;
 19. the last modules of the JAX package and the sub-minute command's
     shape: (a) the member rollout at P = 8 x B = 1024, K = 16 (launch
     shape (MT, W) = (1, 2): 16-row tiles, two a block) and the member
     gradients at P = 8 x N = 32,768 against their plain versions with
     phase 2's and phase 3's tolerances; (b) the flagship's params into a
     zip under SB3's layer names, through `compat.sb3_import`, as an npz
     through `eval --params-npz --exact --episodes 100`: phase 6's mean
     (1252.7158637595496) bit for bit, 100/100 goals; (c) `python -m
     acas2d_tpu_torch.sub_minute` with scripts/sub_minute.sh's command cut
     to 3 iterations, a 64-episode re-eval and a one-iteration polish, one
     eager iteration a call: 8 rollout and 40 gradient launches an
     iteration, `training_wall_s` beside the merge record, the strict
     CSV's mean the summary's; (d) `parity_sweep` cut to 512 steps a run
     (ref_s8, env8_s8, exact_eval_ref_s12; no kernel launch), then
     `export_parity_artifacts` (the exported best params the best
     checkpoint's) and `export_population_artifacts` of (c)'s run (its
     strict record the strict eval's), into a temporary directory; (e)
     `bench --train --fused off`: the `xla` row alone, no kernel launch.
`python3 chip_smoke.py --cards W` (W >= 2 cards of one host) builds the
kernels and runs phase 17 across the cards instead: the dryrun on W ranks
over NCCL (2048 / W envs and 32 / W members a rank) held as in (b); the
solo `tpu` preset and the pipeline's P = 32 trained 16 iterations on W
cards and on one, ms an iteration of each; and `bench --scaling` up to W.
Every training run writes its run directory into a temporary directory.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import csv
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zipfile

import numpy as np
import torch

from acas2d_tpu_torch import policy_ab
from acas2d_tpu_torch.config import DEFAULT_PARAMS, OUTCOME_NAMES
from acas2d_tpu_torch.envs import vector
from acas2d_tpu_torch.models.actor_critic import (ActorCritic, N_PARAMS,
                                                  OBS_DIM, HIDDEN, flatten,
                                                  gaussian_log_prob)
from acas2d_tpu_torch.ops import (_cuda, env_rollout, policy_rollout,
                                  ppo_grads, precision_probe)
from acas2d_tpu_torch.ops import step_math as sm
from acas2d_tpu_torch.ppo.config import tpu_default
from acas2d_tpu_torch.types import EnvState

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit):
# memory, float32 on the CUDA cores (an FMA counted as 2), bf16, TF32 and
# float64 on the tensor cores.  The special-function units (IEEE sine, cosine,
# square root and division counted as one op each) and the 32-bit integer
# units give 16 and 64 results per clock per SM against the float32
# units' 128 (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0), so their peaks are 16/256 and 64/256
# of the float32 flop rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_OPS_PER_S = {"f32": PEAK_F32_FLOP_PER_S, "bf16": 989e12, "tf32": 495e12,
                  "f64": 67e12,
                  "sfu": PEAK_F32_FLOP_PER_S * 16 / 256,
                  "int": PEAK_F32_FLOP_PER_S * 64 / 256}
K = 16                           # rollout steps per launch (fused_chunk)
SOLO_B, SOLO_N = 2048, 65536     # solo main path: envs, minibatch rows
POP, POP_B, POP_N = 32, 1024, 32768   # population: members, envs, rows
ITERS = 3
POLISH_POP = 16
# JAX's default iterations a call on an accelerator (train.py:183-192),
# eval_every / batch at most 16: 4 solo, 8 at the pipeline's shape
SOLO_K = min(16, tpu_default().eval_every_steps // (SOLO_B * 128))
POP_K = min(16, tpu_default().eval_every_steps // (POP_B * 128))
# the solo `tpu` preset on the fused paths, which train.py runs only when
# asked (its defaults are JAX's: the step-by-step rollout and autograd)
SOLO_ARGV = ["--preset", "tpu", "--fused-rollout", "--fused-update"]
POP_ARGV = ["--preset", "tpu", "--anneal-lr", "--population", str(POP),
            "--fused-rollout", "--fused-update-packed",
            "--n-envs", str(POP_B), "--minibatch-size", str(POP_N),
            "--total-steps", str(ITERS * POP_B * 128),
            "--eval-episodes", "32", "--reval-episodes", "64",
            "--polish-steps", str(POP_B * 128),
            "--polish-pop", str(POLISH_POP), "--polish-rounds", "1"]
FLAGSHIP = "artifacts/ppo_tpu_e_polished_best.npz"
FLAGSHIP_RECORD = {"mean_reward": 1252.72, "std_reward": 72.04, "goals": 100}
# Tolerances, kernel on the card vs plain version on the CPU:
#  rollout: the kernel sums each 64-wide dot in its own order and contracts
#  multiply-adds (nvcc default), the plain version uses the CPU's BLAS and
#  libm; over 16 closed-loop steps float32 positions (~1e3 px) drift by a
#  few ulps.
ROLLOUT_RTOL, ROLLOUT_ATOL = 1e-4, 1e-3
#  rollout products: the kernel multiplies on the TF32 tensor cores as
#  3xTF32, which the tolerance above cannot tell from 1xTF32 (11 bits of
#  each operand); `policy_ab.separation_bounds()` can, from the parent
#  kernel's own errors on the card (the reason is stated there).
#  gradients: 32,768- or 65,536-row float32 sums in another order; error
#  relative to each parameter block's largest gradient.
GRAD_REL_TOL = 1e-4
#  the earlier f32 kernel, on the CUDA cores, held every block within this
#  of its plain version (PERF.md); printed beside the 3xTF32 kernel's errors
CUDA_CORE_GRAD_REL_ERR = 2.0e-5
#  flagship eval: the float32 policy's matmuls sum in another order on the
#  card than on the CPU where the record was made; the record has 2 decimals.
EVAL_TOL = 0.05
#  an episode CSV's Total Reward against the greedy eval's return of the
#  same episode: the same float64 rewards, summed pairwise (numpy) in the
#  CSV and one by one in the greedy loop; a wrong reward or a step too many
#  is off by 1e-3 or more.
CSV_SUM_TOL = 1e-6
#  env-only rollout: `env_rollout.agreement` states the rule (an ulp a step
#  of FMA drift, sums growing with T, at most 0.1% of envs flipping a
#  float32 threshold).
ENV_B, ENV_T = 32768, 256              # kernel vs plain version
ZERO_B, ZERO_T = 1024, 64              # zero actions vs the engine
STAT_B, STAT_T = 65536, 2048           # outcome rates vs the engine
HEADLINE_B, HEADLINE_T = 262144, 256   # bench.py's headline shape
SEED = 7                               # the bench's seed
CHAIN = 24                             # timed launches continuing the bench
#  bf16 gradients vs their plain version: both round the same operands, but
#  a tanh output the card computes an ulp away from the CPU can round to the
#  neighbouring bf16 value (2^-8 relative).  A block that is one sum with
#  cancellation (a head bias) then errs by far more than its own small
#  value suggests, and the pi tower's blocks are ~1e-5 at these weights, so
#  no one relative or absolute bound fits every block.  Accuracy: each
#  block of the bf16 kernel must be at least 1 / BF16_VS_F32 times closer
#  to the plain bf16 version than the f32 kernel is, or within the f32
#  kernel's own GRAD_REL_TOL of its tower's largest gradient (summation
#  order).  Separation: on the SEPARATING blocks, summed over members, the
#  bf16 kernel must be 1 / BF16_VS_F32 times closer to the plain bf16
#  version than the f32 kernel is, so an unrounded result fails there
#  (it would sit at 1.0).  Those are the blocks whose every entry is a
#  sum over the rows of rounded products; the head biases and log_std are
#  one number each, which the rounding moves by less than their float32
#  summation order does, and are held to accuracy only.
#  Deviation from the f32 kernel: more than 0, and at most the JAX unit
#  test's 3e-2 x scale + 5e-6 (tests/test_pallas_update.py:159; the cap of
#  pallas_tpu_check.py:232 with the floor that test adds for near-zero
#  sums), where the scale of a block is the largest |gradient| of the JAX
#  gradient leaf it is: for a population, the (P, ...) leaf of the packed
#  members (vmap of ppo_minibatch_grads_packed), so over all members.
BF16_VS_F32, BF16_DEV_MAX, BF16_DEV_FLOOR = 0.1, 3e-2, 5e-6
SEPARATING = [f"{t}.{nm}" for t in ("pi", "vf")
              for nm in ("w1", "b1", "w2", "b2", "w_head")]


def check(cond, msg: str = "check failed") -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_time_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ops(n_bytes: float, ops):
    """The least time (ms) of a call that moves n_bytes and does `ops`
    ({unit: count}), and what binds it: the larger of the bytes' time and
    the busiest unit's time, each at its peak rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(n / PEAK_OPS_PER_S[unit] * 1e3 for unit, n in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 1

# the gradient kernel's first passes (function names in the SASS) and
# whether each is the bf16 variant, whose HMMAs must be BF16 (else TF32)
GRAD_KERNELS = (("grad_partials_tf32x3", False),
                ("grad_partials_bf16mma", True))


def phase_build():
    t0 = time.perf_counter()
    built = _cuda.build()
    for name in _cuda.SOURCES:
        _cuda.load(name)
    print(f"[build] {time.perf_counter() - t0:.1f} s, built "
          f"{sorted(built) or 'nothing (cached)'}")
    for name, info in built.items():
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}")
    for kernel, bf16 in GRAD_KERNELS:
        regs, local, static, dynamic, per_sm = ppo_grads.kernel_attrs(bf16)
        print(f"[build] ppo_grads {'bf16' if bf16 else 'f32'} first pass "
              f"({kernel}): {regs} registers, {local} bytes spilled a "
              f"thread, {static + dynamic} bytes of shared memory a block, "
              f"{per_sm} blocks ({per_sm * 8} warps) an SM")
    sass_census()
    env_census()
    rollout_census()


def sass_census():
    """`cuobjdump -sass` of the gradient library: each first pass's
    instructions by kind.  Its products must be tensor-core HMMAs of its
    operand type, TF32 (f32) or BF16 (bf16), and of no other."""
    ops = _cuda.sass_ops("ppo_grads", [name for name, _ in GRAD_KERNELS])
    kinds = ("LDS", "LDSM", "STS", "MUFU", "BAR", "FFMA", "FADD", "FMUL",
             "SHFL")
    for name, bf16 in GRAD_KERNELS:
        got = ops[name]
        hmma = {k: v for k, v in got.items() if k.startswith("HMMA")}
        by_kind = {k: sum(v for o, v in got.items() if o.split(".")[0] == k)
                   for k in kinds}
        print(f"[build] SASS of {name} (cuobjdump -sass): "
              f"{sum(got.values())} instructions; {hmma}; "
              + ", ".join(f"{k} {v}" for k, v in by_kind.items()))
        want = ".BF16" if bf16 else ".TF32"
        check(hmma and all(want in k for k in hmma),
              f"{name} runs no {want[1:]} HMMA, or another kind")


def env_census():
    """The env rollout's four instantiations as built: registers, local
    memory (stack frame and spills), blocks an SM, and their SASS by kind
    (`env_rollout.sass_census`), the whole kernel and its loop's body."""
    census = env_rollout.sass_census()
    for (zero, obs), c in census.items():
        regs, local, per_sm = env_rollout.kernel_attrs(zero, obs)
        tag = f"{'zero' if zero else 'random'} {'obs' if obs else 'no obs'}"
        print(f"[build] env_rollout {tag}: {regs} registers, {local} bytes "
              f"of local memory a thread, {per_sm} blocks of 128 an SM")
        for part in ("kernel", "loop"):
            print(f"[build] env_rollout {tag} SASS, {part}: "
                  + ", ".join(f"{k} {v}" for k, v in c[part].items()))


def rollout_census():
    """The policy rollout as built, at the launch shape (MT, W) of each
    main path: registers, local memory, dynamic shared memory and blocks an
    SM; per MT its stack frame and spills (ptxas), which must be none, and
    its SASS by kind, whose products must be TF32 HMMAs and no other."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    frames = _cuda.ptxas_frames(_cuda.build_log("policy_rollout"))
    census = policy_rollout.sass_census()
    for tag, (P, B) in policy_ab.SHAPES.items():
        mt, w = policy_rollout.launch_shape(P, B, sms)
        regs, local, smem, per_sm = policy_rollout.kernel_attrs(mt, w)
        tiles = -(-B // (16 * mt))
        warps = policy_rollout.WARPS_A_TILE[mt] * w
        print(f"[build] policy_rollout {tag} (P={P}, B={B}): MT={mt}, W={w}, "
              f"{P * -(-tiles // w)} blocks of {warps} warps on {sms} SMs; "
              f"{regs} registers, {local} bytes of local memory a thread, "
              f"{smem} bytes of dynamic shared memory a block, {per_sm} "
              f"blocks an SM")
    for mt, got in sorted(census.items()):
        frame = next(v for k, v in frames.items()
                     if f"policy_rollout_kernelILi{mt}E" in k)
        hmma = {k: v for k, v in got.items() if k.startswith("HMMA.")}
        print(f"[build] policy_rollout MT={mt}: stack frame {frame[0]} "
              f"bytes, spill stores {frame[1]}, spill loads {frame[2]}; "
              f"SASS (cuobjdump -sass): {got['all']} instructions; {hmma}; "
              + ", ".join(f"{k} {got[k]}" for k in policy_rollout.SASS_KINDS))
        check(frame[1] == frame[2] == 0, f"policy_rollout MT={mt} spills")
        check(hmma and all(".TF32" in k for k in hmma),
              f"policy_rollout MT={mt} runs no TF32 HMMA, or another kind")


# ------------------------------------------------------------------ phase 2


def compare(tag, got, want, rtol, atol):
    """Hold the kernel path's outputs (dict of CUDA tensors) against the
    plain version's (dict of CPU tensors): integers exactly, floats to
    atol + rtol * |want|.  Returns the largest float error."""
    max_err = 0.0
    for name in sorted(want):
        g, w = got[name].cpu(), want[name]
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{tag} {name}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if not torch.is_floating_point(w):
            bad = int((g != w).sum())
            print(f"[{tag}] {name}: {bad} mismatches of {g.numel()}")
            check(bad == 0, f"{tag} {name} differs from the plain version")
            continue
        err = (g - w).abs()
        max_err = max(max_err, float(err.max()))
        ok = bool((err <= atol + rtol * w.abs()).all())
        print(f"[{tag}] {name}: max abs err {float(err.max()):.3e}")
        check(ok, f"{tag} {name} outside rtol {rtol} atol {atol}")
    return max_err


def on_cpu(tensors):
    return {k: v.cpu() for k, v in tensors.items()}


def phase_rollout(dev, P, B):
    """The public wrapper on CUDA tensors (the kernel) against the same call
    on copies on the CPU (the plain version): the solo wrapper at P = 1,
    the member wrapper otherwise.  This also checks the wrappers' state
    stacking, casts and the split of their outputs."""
    args = policy_ab.operands(dev, P, B)
    _, _, st, steps, obs, params, seed, offset, k = args
    state = {key: v.view(P, B) for key, v in
             zip(policy_rollout.STATE_KEYS, st.unbind(0))}
    state["steps"] = steps.view(P, B)
    obs = obs.view(P, B, 8)
    if P == 1:
        def call(state, obs, params):
            return policy_rollout.fused_policy_rollout(
                {key: v[0] for key, v in state.items()}, obs[0], params[0],
                seed, offset, k)
    else:
        def call(state, obs, params):
            return policy_rollout.fused_policy_rollout_members(
                state, obs, params, seed, offset, k)
    tag = "rollout" if P == 1 else "member rollout"
    got = call(state, obs, params)
    want = call(on_cpu(state), obs.cpu(), params.cpu())
    torch.cuda.synchronize()
    max_err = 0.0
    for part, g, w in zip(("final", "buffers"), got, want):
        max_err = max(max_err, compare(f"{tag} {part}", g, w,
                                       ROLLOUT_RTOL, ROLLOUT_ATOL))
    dones = int(want[1]["dones"].gt(0).sum())
    print(f"[{tag}] P={P} B={B} K={k}: {dones} episode ends in the launch")
    check(dones > 0, "the comparison should exercise respawns")
    bounds = policy_ab.separation_bounds()
    for name, (m, a, ok) in policy_ab.separating(got[1], want[1]).items():
        pm, pa = policy_ab.PARENT_ERR[name]
        print(f"[{tag}] {name}: largest error {m:.3e}, mean {a:.3e}; bounds "
              f"{bounds[name][0]:.3e}, {bounds[name][1]:.3e} (the parent "
              f"kernel's {pm:.3e}, {pa:.3e}; a 1xTF32 build fails them)")
        check(ok, f"{tag} {name}: errors above the 3xTF32 bounds")
    return args, max_err, dones


# ------------------------------------------------------------------ phase 3

def grads_inputs(dev, P, n):
    """P minibatches of n rows (RAW advantages) whose ratios straddle the
    clip band, and the members' params, on `dev`."""
    gen = torch.Generator().manual_seed(2)
    params, mbs = [], []
    for _ in range(P):
        model = ActorCritic(generator=gen)
        obs = torch.randn(n, OBS_DIM, generator=gen) * 0.3
        with torch.no_grad():
            mean, log_std, value = model(obs)
            act = mean + torch.randn(n, 1, generator=gen) * 0.7
            old_logp = (gaussian_log_prob(act, mean, log_std)
                        + torch.randn(n, generator=gen) * 0.3)
        adv = torch.randn(n, generator=gen) * 3.0 + 0.5
        ret = torch.randn(n, generator=gen)
        mbs.append(torch.cat([obs, act, old_logp[:, None], value[:, None],
                              adv[:, None], ret[:, None]], 1))
        params.append(flatten(model))
    return torch.stack(params).to(dev), torch.stack(mbs).to(dev).contiguous()


def phase_grads(dev, P, n):
    """The public wrapper on CUDA tensors (the kernel) against the same call
    on the CPU (the plain version), with the `tpu` preset's loss settings
    and once more with a non-zero ent_coef, whose sign enters the log-std
    gradient: the solo wrapper at P = 1, the member wrapper otherwise.
    Returns the kernel's own operands at the main-path setting (advantages
    normalised as the wrapper does) for the timings."""
    cfg = tpu_default()
    params, mb = grads_inputs(dev, P, n)
    tower = (HIDDEN * OBS_DIM, HIDDEN, HIDDEN * HIDDEN, HIDDEN, HIDDEN, 1)
    sizes = list(tower) * 2 + [1]
    names = [f"{t}.{nm}" for t in ("pi", "vf")
             for nm in ("w1", "b1", "w2", "b2", "w_head", "b_head")] + [
                 "log_std"]
    if P == 1:
        def call(params, mb, **kw):
            g, aux = ppo_grads.ppo_minibatch_grads(params[0], mb[0], **kw)
            return g[None], {key: v[None] for key, v in aux.items()}
    else:
        call = ppo_grads.ppo_minibatch_grads_members
    tag = "grads" if P == 1 else "member grads"
    max_err = 0.0
    for ent_coef in (cfg.ent_coef, 0.01):
        kw = dict(clip_range=cfg.clip_range, vf_coef=cfg.vf_coef,
                  ent_coef=ent_coef,
                  normalize_advantage=cfg.normalize_advantage)
        g, aux = call(params, mb, **kw)
        w, waux = call(params.cpu(), mb.cpu(), **kw)
        torch.cuda.synchronize()
        g = g.cpu()
        max_err = max(max_err, float((g - w).abs().max()))
        worst = {}
        for m in range(P):
            for name, gb, wb in zip(names, g[m].split(sizes),
                                    w[m].split(sizes)):
                rel = float((gb - wb).abs().max() / (wb.abs().max() + 1e-12))
                worst[name] = max(worst.get(name, 0.0), rel)
        for name, rel in worst.items():
            print(f"[{tag}] ent_coef {ent_coef}: {name} rel err {rel:.3e} "
                  f"(worst of {P} member(s); the CUDA-core kernel: at most "
                  f"{CUDA_CORE_GRAD_REL_ERR:.1e})")
            check(rel < GRAD_REL_TOL, f"gradient {name} rel err {rel}")
        for key in sorted(waux):
            a, b = aux[key].cpu().double(), waux[key].double()
            rel = float(((a - b).abs() / (b.abs() + 1e-6)).max())
            print(f"[{tag}] ent_coef {ent_coef}: {key} rel err {rel:.3e}")
            check(rel < GRAD_REL_TOL, f"aux {key} differs")
    clip_frac = float(waux["clip_fraction"].mean())
    print(f"[{tag}] P={P} N={n}: clip fraction {clip_frac:.3f}")
    check(0.05 < clip_frac < 0.95, "both clip regimes should be exercised")
    data = ppo_grads.normalize_adv_column(mb).contiguous()
    consts = ppo_grads._constants(n, cfg.clip_range, cfg.vf_coef)
    args = (params, data, consts, cfg.ent_coef)
    (g1, s1), (g2, s2) = (ppo_grads._grads_cuda(*args) for _ in range(2))
    same = torch.equal(g1, g2) and torch.equal(s1, s2)
    print(f"[{tag}] two launches on the same operands bit-identical: {same}")
    check(same, "the gradient kernel does not repeat bit for bit")
    return args, max_err


# ------------------------------------------------------------------ phase 4

COUNTED = {"policy_rollout": policy_rollout.fused_policy_rollout_members,
           "ppo_grads": ppo_grads.ppo_minibatch_grads_members,
           "env_rollout": env_rollout.fused_rollout,
           "precision_probe": precision_probe.precision_probe}


def reset_counts():
    for fn in COUNTED.values():
        fn.launches = 0


def read_counts():
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in COUNTED.items()}


def expected(**launches):
    """A full launch record: the given counts, every other kernel 0."""
    return {name: launches.get(name, 0) for name in COUNTED}


def check_finite(rows):
    for row in rows:
        bad = [k for k, v in row.items()
               if not all(math.isfinite(x) for x in np.ravel(v))]
        check(not bad, f"non-finite metrics {bad}")


def phase_main_path():
    from acas2d_tpu_torch import train
    with tempfile.TemporaryDirectory() as out:
        argv = SOLO_ARGV + ["--total-steps", str(ITERS * SOLO_B * 128),
                "--iters-per-call", "1", "--out-dir", out]
        reset_counts()
        rows = train.run(train.parse_args(argv))
        launches = read_counts()
    print(f"[main] launches over {ITERS} iterations: {launches}")
    check(launches == expected(policy_rollout=8 * ITERS,
                               ppo_grads=40 * ITERS))
    check_finite(rows)
    steady = [r["steps_per_s"] for r in rows[1:]]
    it_s = [r["seconds"] for r in rows[1:]]
    print(f"[main] env-steps/s after the first iteration: {steady} "
          f"(iteration seconds {it_s}; first {rows[0]['seconds']:.3f} s)")
    return launches, float(np.mean(it_s))


def breakdown(make_step, state):
    """One more iteration cut at its three phases by the step's phase hook,
    which synchronises and reads the host clock as each phase ends (after
    a warm-up iteration): rollout (8 launches), GAE, update (40 gradient
    launches + Adam)."""
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    step = make_step(mark)
    for _ in range(2):                 # the second pass is the one reported
        marks.clear()
        mark("start")
        state, _ = step(state)
    return {name: (t - t_prev) * 1e3
            for (_, t_prev), (name, t) in zip(marks, marks[1:])}


def phase_breakdown():
    from acas2d_tpu_torch import train
    from acas2d_tpu_torch.ppo import learner
    cfg = train.build_config(train.parse_args(SOLO_ARGV))
    ms = breakdown(
        lambda mark: learner.make_train_step(cfg, DEFAULT_PARAMS, "cuda",
                                             on_phase=mark),
        learner.init_train_state(cfg, DEFAULT_PARAMS, "cuda"))
    print(f"[breakdown] solo iteration phases (ms): {json.dumps(ms)}")
    return ms


# ------------------------------------------------------------------ phase 5

def phase_population():
    """The pipeline's population command, cut to 3 iterations, a 64-episode
    re-eval and one 1-iteration polish round at 16 members."""
    from acas2d_tpu_torch import eval as eval_driver
    from acas2d_tpu_torch import train
    with tempfile.TemporaryDirectory() as out:
        argv = POP_ARGV + ["--iters-per-call", "1", "--out-dir", out,
                           "--run-name", "pop"]
        reset_counts()
        t0 = time.perf_counter()
        rows = train.run(train.parse_args(argv))
        wall = time.perf_counter() - t0
        launches = read_counts()
        iters = ITERS + 1                          # + the polish iteration
        print(f"[population] launches over {iters} iterations "
              f"({ITERS} at P={POP}, 1 at P={POLISH_POP}): {launches}")
        check(len(rows) == iters, f"{len(rows)} rows")
        check(launches == expected(policy_rollout=8 * iters,
                                   ppo_grads=40 * iters))
        check_finite(rows)
        for r in rows:
            evals = (f", eval_return_max {r['eval_return_max']:.2f}"
                     if "eval_return_max" in r else "")
            print(f"[population] iteration {r['iteration']}: "
                  f"{r['seconds'] * 1e3:.2f} ms, {r['steps_per_s']:.0f} "
                  f"env-steps/s (all members), ep_return_mean "
                  f"{r['ep_return_mean']:.2f}{evals}")
        print(f"[population] whole run (training, evals, re-evals, "
              f"selection, polish) {wall:.2f} s")
        with open(f"{out}/pop_polish/population.json") as f:
            sel = json.load(f)
        print(f"[population] polish selection: member "
              f"{sel['selected_member']}, reval {sel['selected_reval']:.2f}, "
              f"score {sel['selected_score']:.2f}")
        res = eval_driver.run(eval_driver.parse_args(
            ["--params-npz", f"{out}/pop_polish/selected_best.npz",
             "--exact", "--episodes", "100", "--out",
             f"{out}/eval_100.csv"]))
        print(f"[population] exact eval of the selected policy: "
              f"{json.dumps(res)}")
        check(math.isfinite(res["mean_reward"]) and res["episodes"] == 100)
    it_s = [r["seconds"] for r in rows[1:ITERS]]
    return launches, float(np.mean(it_s))


def phase_population_breakdown():
    """One population iteration cut into its phases."""
    from acas2d_tpu_torch import train
    from acas2d_tpu_torch.ppo import population
    cfg = train.build_config(train.parse_args(POP_ARGV))
    state = population.init_population(cfg, DEFAULT_PARAMS, POP, "cuda")
    ms = breakdown(
        lambda mark: population.make_population_step(
            cfg, DEFAULT_PARAMS, "cuda", on_phase=mark), state)
    print(f"[breakdown] population iteration phases (ms): {json.dumps(ms)}")
    return ms


# ------------------------------------------------------------------ phase 6

def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def phase_eval():
    """The flagship's exact eval with its episode CSV (`--out`): the
    summary held to the record, the CSV's 100 rows all goals, and the mean
    of their Total Reward the summary's mean (the summary is taken from
    the same records)."""
    from acas2d_tpu_torch import eval as eval_driver
    with tempfile.TemporaryDirectory() as out:
        path = os.path.join(out, "eval_100.csv")
        res, ms = synced_ms(lambda: eval_driver.run(eval_driver.parse_args(
            ["--params-npz", FLAGSHIP, "--exact", "--episodes", "100",
             "--out", path])))
        rows = read_csv(path)
    print(f"[eval] {json.dumps(res)} ({ms / 1e3:.2f} s with the CSV)")
    rec = FLAGSHIP_RECORD
    check(res["goals"] == rec["goals"])
    check(abs(res["mean_reward"] - rec["mean_reward"]) < EVAL_TOL)
    check(abs(res["std_reward_ddof1"] - rec["std_reward"]) < EVAL_TOL)
    csv_mean = float(np.mean([float(r["Total Reward"]) for r in rows]))
    print(f"[eval] CSV: {len(rows)} rows, outcomes "
          f"{sorted(set(r['Outcome'] for r in rows))}, mean Total Reward "
          f"{csv_mean!r} against the summary's {res['mean_reward']!r}")
    check(len(rows) == 100 and all(r["Outcome"] == "Goal" for r in rows),
          "the flagship's CSV is not 100 goals")
    check(csv_mean == res["mean_reward"],
          "the CSV's returns are not the summary's")
    return res


# ------------------------------------------------------------ phases 11-13

def synced_ms(fn):
    """(fn(), host ms around it, from a synchronised start to a
    synchronised end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_greedy_graphs():
    """Two in-training evals of initial policies through the eager greedy
    loop and through `learner.GreedyEval` (its 64-step chunks captured as
    CUDA graphs, then replayed): the pipeline's, 32 members x 32 episodes,
    and the solo `tpu` preset's, 10 episodes.  Equal returns, lengths and
    outcomes, bit for bit, and the times of both, the capture's first call
    apart."""
    from acas2d_tpu_torch import train
    from acas2d_tpu_torch.ppo import learner, population
    cfg = train.build_config(train.parse_args(POP_ARGV))
    members = population.init_population(cfg, DEFAULT_PARAMS, POP,
                                         "cuda").params
    solo_cfg = train.build_config(train.parse_args(SOLO_ARGV))
    cases = (("population", members, True, POP * cfg.eval_episodes),
             ("solo", members[0], False, solo_cfg.eval_episodes))
    for name, params, is_members, n in cases:
        es, obs = vector.reset_batch(n, DEFAULT_PARAMS,
                                     torch.Generator().manual_seed(0),
                                     torch.float32, "cuda")
        greedy = learner.GreedyEval(members=is_members, device="cuda")
        eager, eager_ms = synced_ms(lambda: learner.greedy_rollout(
            lambda o: greedy.policy_mean(params, o), es, obs,
            DEFAULT_PARAMS))
        first, first_ms = synced_ms(
            lambda: greedy(params, es, obs, DEFAULT_PARAMS))
        graph, graph_ms = synced_ms(
            lambda: greedy(params, es, obs, DEFAULT_PARAMS))
        for got in (first, graph):
            for k, v in eager.items():
                check(got[k].dtype == v.dtype and torch.equal(got[k], v),
                      f"graph and eager {name} evals differ in {k}")
        print(f"[graphs] one {name} eval ({n} episodes, lengths mean "
              f"{float(eager['length'].float().mean()):.1f}, max "
              f"{int(eager['length'].max())} steps): eager {eager_ms:.1f} "
              f"ms, graphs {graph_ms:.1f} ms ({eager_ms / graph_ms:.2f}x; "
              f"the first call, with the capture, {first_ms:.1f} ms); "
              f"returns, lengths and outcomes bit-identical")


WHOLE_ITERS = 32          # the tpu preset's budget, 8,388,608 env-steps


def phase_solo_run():
    """`train` with SOLO_ARGV at its default budget (32 iterations of 2048 x
    128, SOLO_K a call: replays of a captured iteration; evals of 10
    episodes every 4 iterations), a checkpoint every call, with the launch
    counters read around it; then its best checkpoint through `eval --run
    --best --exact --episodes 100`."""
    from acas2d_tpu_torch import eval as eval_driver
    from acas2d_tpu_torch import train
    batch = SOLO_B * 128
    with tempfile.TemporaryDirectory() as out:
        argv = SOLO_ARGV + ["--checkpoint-every", str(batch),
                "--out-dir", out, "--run-name", "solo"]
        reset_counts()
        rows, wall_ms = synced_ms(lambda: train.run(train.parse_args(argv)))
        launches = read_counts()
        print(f"[solo run] launches over {WHOLE_ITERS} iterations: "
              f"{launches}")
        check(len(rows) == WHOLE_ITERS, f"{len(rows)} rows")
        check(launches == expected(policy_rollout=8 * WHOLE_ITERS,
                                   ppo_grads=40 * WHOLE_ITERS))
        check_finite(rows)
        run_dir = os.path.join(out, "solo")
        ckpt_dir = os.path.join(run_dir, "checkpoints")
        kept = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
        check(kept == [batch * i for i in range(
            WHOLE_ITERS - 4 * SOLO_K, WHOLE_ITERS + 1, SOLO_K)],
              f"kept checkpoints {kept}")
        with open(os.path.join(ckpt_dir, "best", "best_value.json")) as f:
            best = json.load(f)
        check(os.path.exists(os.path.join(ckpt_dir, "best", "state.pt")))
        with open(os.path.join(run_dir, "summary.json")) as f:
            summary = json.load(f)
        check(summary["global_step"] == WHOLE_ITERS * batch
              and summary["device"] == "cuda"
              and summary["iters_per_call"] == SOLO_K)
        evals = [r for r in rows if "eval_seconds" in r]
        eval_s = sum(r["eval_seconds"] for r in evals)
        train_s = sum(r["seconds"] for r in rows)
        print(f"[solo run] wall {wall_ms / 1e3:.2f} s: {len(evals)} evals "
              f"{eval_s:.2f} s ({100 * eval_s / (wall_ms / 1e3):.1f}%), "
              f"iterations {train_s:.2f} s; eval returns "
              f"{[round(r['eval_return_mean'], 2) for r in evals]}; best "
              f"{best['value']:.2f} at step {best['step']}; summary "
              f"{json.dumps({k: summary[k] for k in ('total_wall_s', 'init_s', 'avg_steps_per_s', 'steady_steps_per_s', 'first_call_s', 'iters_per_call', 'phases', 'phases_other_s')})}")
        res = eval_driver.run(eval_driver.parse_args(
            ["--run", run_dir, "--best", "--exact", "--episodes", "100"]))
        print(f"[solo run] exact eval of the best checkpoint: mean "
              f"{res['mean_reward']:.4f}, std (ddof 1) "
              f"{res['std_reward_ddof1']:.4f}, goals {res['goals']}/100, "
              f"collisions {res['collisions']}, timeouts {res['timeouts']}")
        check(math.isfinite(res["mean_reward"]) and res["episodes"] == 100)
    return wall_ms / 1e3, eval_s


def interrupted_replays(real, after):
    """A stand-in for `learner._IterationGraph.replay` that raises
    KeyboardInterrupt once `after` replays are done, as a Ctrl-C between
    two replays of a call would."""
    done = [0]

    def replay(self, inputs):
        out = real(self, inputs)
        done[0] += 1
        if done[0] == after:
            raise KeyboardInterrupt
        return out
    return replay


def phase_resume():
    """Exact resume of runs of K > 1 iterations a call on the card.  Solo
    `tpu` preset, 3 a call: 6 iterations straight against a 3-iteration
    run and a --resume to 6.  The population command (P = 32, --anneal-lr,
    no re-eval, no polish) at its default POP_K a call: 2 calls straight
    against the same command stopped by a Ctrl-C after the third replay of
    its second call (its learning-rate schedule is sized by the budget, so
    the budget stays) and a --resume, which saves and resumes from the end
    of the first call.  The final params, Adam moments and env state must
    be bit-identical."""
    from acas2d_tpu_torch import train
    from acas2d_tpu_torch.ppo import learner
    cases = (("solo", SOLO_ARGV + ["--iters-per-call", "3"],
              SOLO_B * 128, 6, 3),
             ("population", POP_ARGV + ["--reval-episodes", "0",
                                        "--polish-steps", "0"],
              POP_B * 128, 2 * POP_K, None))
    real_replay = learner._IterationGraph.replay
    with tempfile.TemporaryDirectory() as out:
        for name, argv, batch, total, half in cases:
            def go(where, its, *extra):
                train.run(train.parse_args(
                    argv + ["--checkpoint-every", str(batch), "--run-name",
                            name, "--out-dir", os.path.join(out, where),
                            "--total-steps", str(its * batch), *extra]))
                return os.path.join(out, where, name, "checkpoints",
                                    str(its * batch), "state.pt")
            want = torch.load(go("straight", total), weights_only=True)
            if half is not None:
                go("split", half)
                how = f"{half} iterations and a --resume"
            else:
                # the first call replays POP_K - 1 iterations after its
                # eager first one; stop the second after 3 of its own
                learner._IterationGraph.replay = interrupted_replays(
                    real_replay, POP_K - 1 + 3)
                try:
                    go("split", total)
                finally:
                    learner._IterationGraph.replay = real_replay
                how = (f"a run stopped by a Ctrl-C in its second call of "
                       f"{POP_K} (after iteration {POP_K + 3}) and resumed")
            got = torch.load(go("split", total, "--resume"),
                             weights_only=True)
            leaves = {"params": (got["params"], want["params"]),
                      "adam.mu": (got["adam"]["mu"], want["adam"]["mu"]),
                      "adam.nu": (got["adam"]["nu"], want["adam"]["nu"]),
                      "obs": (got["obs"], want["obs"])}
            leaves.update({f"env.{k}": (got["env_state"][k], v)
                           for k, v in want["env_state"].items()})
            differ = [k for k, (a, b) in leaves.items()
                      if not torch.equal(a, b)]
            check(not differ and got["adam"]["count"] == want["adam"]["count"]
                  and got["iteration"] == want["iteration"] == total,
                  f"{name} resume differs from the straight run in {differ}")
            print(f"[resume] {name}: {how} to {total} equal {total} "
                  f"straight, bit for bit ({len(leaves)} tensors)")


PIPE_SEED = 3101
# 2 attempts of stage 1 and two polish stages, each one call of POP_K
PIPE_ITERS = 2 * 3 * POP_K
PIPE_ARGV = (POP_ARGV[:POP_ARGV.index("--total-steps")]
             + ["--total-steps", str(POP_K * POP_B * 128)]
             + POP_ARGV[POP_ARGV.index("--total-steps") + 2:
                        POP_ARGV.index("--polish-steps")]
             + ["--polish-steps", str(POP_K * POP_B * 128),
                "--polish-pop", str(POLISH_POP), "--polish-rounds", "2",
                "--checkpoint-every", str(POP_K * POP_B * 128)])
PIPE_ARTIFACT = "artifacts/population/pipe5_s2101_population.json"


def phase_pipeline(dev):
    """The shipped pipeline, `acas2d_tpu_torch.pipeline.run_pipeline`, at a
    cut budget into a temporary directory: stage 1 of the population
    command at P = 32 x 1024 envs for one call of its default POP_K
    iterations (replays of a captured iteration; its eval fires after
    it), the re-eval cut to 64 episodes, two polish rounds of one call
    each at P = 16; a gate no policy reaches and two attempts, so the
    escalation and the best-across-attempts pick both run.  The launch
    counters are read around it (8 + 40 an iteration); 6 candidate dirs,
    each stage 1 among them; the merge record in each polish stage; the
    `_final` record with every key of the committed pipeline artifact; and
    the strict eval's CSV, 100 rows equal to the exact eval's episodes of
    the kept policy (outcome, and return to CSV_SUM_TOL)."""
    from acas2d_tpu_torch import pipeline
    from acas2d_tpu_torch.oracle import MersenneSpawner
    from acas2d_tpu_torch.ppo import learner
    from acas2d_tpu_torch.utils.params_io import load_flat_params
    saved = {k: os.environ.get(k) for k in ("GATE", "MAX_ATTEMPTS")}
    os.environ.update(GATE="1e9", MAX_ATTEMPTS="2")
    with tempfile.TemporaryDirectory() as out:
        reset_counts()
        try:
            rec, ms = synced_ms(lambda: pipeline.run_pipeline(
                PIPE_SEED, "smoke", PIPE_ARGV, out, device=dev.type))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        launches = read_counts()
        print(f"[pipeline] launches over {PIPE_ITERS} iterations (2 "
              f"attempts: {POP_K} at P={POP}, 2 x {POP_K} polish at "
              f"P={POLISH_POP}): {launches}; wall {ms / 1e3:.2f} s")
        check(launches == expected(policy_rollout=8 * PIPE_ITERS,
                                   ppo_grads=40 * PIPE_ITERS))
        names = [f"smoke_s{PIPE_SEED}", f"smoke_s{PIPE_SEED}_esc1"]
        check(rec["attempts"] == 2 and rec["dirs"] == [
            os.path.join(out, n + p) for n in names
            for p in ("", "_polish", "_polish_polish")],
            f"attempts {rec['attempts']}, dirs {rec['dirs']}")
        records = {}
        for d in rec["dirs"]:
            with open(os.path.join(d, "population.json")) as f:
                records[d] = json.load(f)
            merged = {"stage1", "pipeline"} <= set(records[d])
            check(merged == d.endswith("_polish"),
                  f"{d}: merge keys {merged}")
        with open(os.path.join(rec["final"], "population.json")) as f:
            final = json.load(f)
        with open(PIPE_ARTIFACT) as f:
            missing = set(json.load(f)) - set(final)
        check(not missing and final["attempts"] == 2
              and final["best_of_chain"] == rec["best_dir"],
              f"final record: missing {missing}")
        print(f"[pipeline] kept {os.path.basename(rec['best_dir'])} "
              f"(score {rec['best_score']:.2f}); polish labels "
              f"{records[rec['dirs'][1]]['pipeline']}")
        rows = read_csv(os.path.join(rec["final"], "eval_100_exact.csv"))
        params, _ = load_flat_params(os.path.join(rec["final"],
                                                  "selected_best.npz"))
        ep = learner.exact_episodes(
            params.to(dev), DEFAULT_PARAMS,
            MersenneSpawner(DEFAULT_PARAMS, skip_episodes=2), 100,
            torch.float64, dev)
        outcome = ep["outcome"].cpu().numpy()
        ret = ep["return"].cpu().numpy()
        check(len(rows) == 100, f"{len(rows)} CSV rows")
        for b, r in enumerate(rows):
            check(r["Outcome"] == OUTCOME_NAMES.get(int(outcome[b]))
                  and abs(float(r["Total Reward"]) - float(ret[b]))
                  < CSV_SUM_TOL,
                  f"CSV episode {b + 1}: {r['Outcome']} "
                  f"{r['Total Reward']} against {int(outcome[b])} "
                  f"{float(ret[b])!r}")
        print(f"[pipeline] strict eval CSV of the kept policy: 100 rows "
              f"equal to the exact eval's; mean "
              f"{float(np.mean(ret)):.4f}, goals {int((outcome == 1).sum())}"
              f"/100; training wall {final['training_wall_s']} s")


# ----------------------------------------------------------------- phase 15

def leaves_differ(a, b):
    """The names of the tensors one iteration hands the next that differ
    between two states, and whether their generators do."""
    from acas2d_tpu_torch.ppo import learner
    names = (["params", "adam.mu", "adam.nu"]
             + [f"env.{f}" for f in EnvState.__dataclass_fields__] + ["obs"])
    out = [n for n, x, y in zip(names, learner._state_leaves(a),
                                learner._state_leaves(b))
           if not torch.equal(x, y)]
    if any(not torch.equal(g.get_state(), h.get_state())
           for g, h in zip(a.generators, b.generators)):
        out.append("generators")
    return out


def replay_case(name, argv, pop):
    """(config, K, init(), eager step, loop of K a call) of one of phase
    15's or 16's configurations, K `train.py`'s default on the card."""
    from acas2d_tpu_torch import train
    from acas2d_tpu_torch.ppo import learner, population
    cfg = train.build_config(train.parse_args(argv))
    K = train.resolve_iters_per_call(None, "tpu", torch.device("cuda"), cfg)
    if pop:
        return (cfg, K, lambda: population.init_population(
                    cfg, DEFAULT_PARAMS, pop, "cuda"),
                population.make_population_step(cfg, DEFAULT_PARAMS, "cuda"),
                population.make_population_loop(cfg, DEFAULT_PARAMS, K,
                                                "cuda"))
    return (cfg, K,
            lambda: learner.init_train_state(cfg, DEFAULT_PARAMS, "cuda"),
            learner.make_train_step(cfg, DEFAULT_PARAMS, "cuda"),
            learner.make_train_loop(cfg, DEFAULT_PARAMS, K, "cuda"))


REPLAY_CASES = (("solo", SOLO_ARGV, 0),
                ("members", POP_ARGV, POP),
                ("solo bf16", SOLO_ARGV + ["--fused-update-bf16"], 0))


def phase_replayed_loop(cases=REPLAY_CASES):
    """K iterations a call, replays of a captured iteration, against K
    eager steps from the same state and generators: two calls against
    2K steps, bit for bit (the tensors an iteration hands the next, the
    Adam count, every metric, the generators), the launch counters read
    around each call (8 rollout launches an iteration on the fused
    rollout and 40 gradient launches on the fused update, none on the
    unfused paths); each path's peak memory; then the two in turns
    (eager, replayed, replayed, eager, twice), each timed from a synced
    start to its synced end, in ms an iteration."""
    out = {}
    for name, argv, pop in cases:
        cfg, K, init, step, loop = replay_case(name, argv, pop)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        a, rows = init(), []
        for _ in range(2 * K):
            a, m = step(a)
            rows.append(m)
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        b, calls = init(), []
        for _ in range(2):
            reset_counts()
            b, m = loop(b)
            launches = read_counts()
            check(launches == expected(
                policy_rollout=8 * K * cfg.fused_rollout,
                ppo_grads=40 * K * cfg.fused_update),
                  f"{name}: a call of {K} launched {launches}")
            calls.append(m)
        replay_peak = torch.cuda.max_memory_allocated()
        differ = leaves_differ(a, b)
        differ += [k for k in rows[0] if not torch.equal(
            torch.stack([r[k] for r in rows]),
            torch.cat([c[k] for c in calls]))]
        check(not differ and a.iteration == b.iteration == 2 * K
              and a.opt_state.count == b.opt_state.count,
              f"{name}: replayed and eager differ in {differ}")
        ms = {"eager": [], "replayed": []}

        def eager(state):
            for _ in range(K):
                state, _ = step(state)
            return state
        for _ in range(2):
            for kind in ("eager", "replayed", "replayed", "eager"):
                if kind == "eager":
                    a, t = synced_ms(lambda: eager(a))
                else:
                    (b, _), t = synced_ms(lambda: loop(b))
                ms[kind].append(t / K)
        out[name] = (K, ms, eager_peak - base, replay_peak - base)
        print(f"[replay] {name}: 2 calls of K={K} equal {2 * K} eager "
              f"steps bit for bit (params, Adam moments and count, env "
              f"state, obs, {len(rows[0])} metrics, generators); launches "
              f"a call {launches}; ms an iteration, eager "
              f"{[round(x, 2) for x in ms['eager']]}, replayed "
              f"{[round(x, 2) for x in ms['replayed']]} (median "
              f"{np.median(ms['eager']):.2f} / "
              f"{np.median(ms['replayed']):.2f}); peak memory "
              f"(max_memory_allocated, above the {base / 2**30:.3f} GiB "
              f"held before) eager {(eager_peak - base) / 2**30:.3f} GiB, "
              f"replayed {(replay_peak - base) / 2**30:.3f} GiB")
    return out


def phase_trace():
    """`train --profile` (its trace of calls 2-4), solo at SOLO_K a call
    (16 iterations) and the pipeline's population at POP_K (32 iterations,
    no re-eval): the card's busy share of the traced window, the union of
    its kernels' intervals over the span of the trace's events, which
    holds only those calls (the one eval fires after the first)."""
    from acas2d_tpu_torch import train
    from acas2d_tpu_torch.utils import profiling
    cases = (("solo", SOLO_ARGV, SOLO_K, SOLO_B * 128),
             ("members", POP_ARGV + ["--reval-episodes", "0",
                                     "--polish-steps", "0"],
              POP_K, POP_B * 128))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv, K, batch in cases:
            rows = train.run(train.parse_args(
                argv + ["--iters-per-call", str(K), "--eval-every",
                        str(10 ** 12), "--total-steps", str(4 * K * batch),
                        "--profile", "--out-dir", tmp, "--run-name", name]))
            check(len(rows) == 4 * K, f"{len(rows)} rows")
            path = os.path.join(tmp, name, "trace", profiling.TRACE_FILE)
            share, kernels, window = profiling.kernel_busy_share(path)
            calls = [sum(r["seconds"] for r in rows[i * K:(i + 1) * K])
                     for i in range(4)]
            print(f"[trace] {name}, K={K}: calls 2-4 traced "
                  f"({os.path.getsize(path) / 2**20:.1f} MiB), {kernels} "
                  f"kernels over a {window / 1e3:.2f} ms window: the card "
                  f"busy {share:.1%} of it; call ms {[round(c * 1e3, 2) for c in calls]}")
            by_name = sorted(profiling.kernel_times(path).items(),
                             key=lambda kv: -kv[1][0])
            n_it = 3 * K
            for kname, (us, n) in by_name[:8]:
                print(f"[trace] {name}: {us / 1e3 / n_it:.3f} ms and "
                      f"{n / n_it:.1f} launches an iteration: {kname[:90]}")
            rest = sum(us for _, (us, _) in by_name[8:])
            print(f"[trace] {name}: {rest / 1e3 / n_it:.3f} ms an iteration "
                  f"in {len(by_name) - 8} other kernels")
            out[name] = (share, kernels)
    return out


# ----------------------------------------------------------------- phase 16

# the solo `tpu` preset on the three other (rollout, update) pairs
UNFUSED_CASES = (("unfused", ["--preset", "tpu"], 0),
                 ("fused rollout + autograd", ["--preset", "tpu",
                                               "--fused-rollout"], 0),
                 ("unfused rollout + fused update", ["--preset", "tpu",
                                                     "--fused-update"], 0))
#  float64 on the card against the CPU, one unfused `tpu` iteration on the
#  same state and draws: the draws' bits are the same on both (integer
#  hashes), the float64 arithmetic sums in other orders and the card's libm
#  differs by an ulp, so the rollouts agree to ~1e-13 unless an env crosses
#  a threshold (an episode end) on one device only, which moves the
#  gradient by ~1/262,144 of one sample's: params within 1e-7 (Adam steps
#  of ~3e-4), metrics within rtol 1e-5.
F64_PARAM_ATOL, F64_METRIC_RTOL = 1e-7, 1e-5


def phase_unfused_main_paths():
    """The three pairs, and the step-by-step rollout with the bf16 update,
    through `train.run` at the full `tpu` preset, 3 iterations, one eager
    iteration a call, the launch counters read around each: 8 rollout
    launches an iteration on the fused rollout, 40 gradient launches on
    the fused update, none on the unfused paths."""
    from acas2d_tpu_torch import train
    out = {}
    for name, argv, _ in UNFUSED_CASES + (
            ("unfused rollout + bf16 update",
             ["--preset", "tpu", "--fused-update-bf16"], 0),):
        cfg = train.build_config(train.parse_args(argv))
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts()
            rows = train.run(train.parse_args(argv + [
                "--total-steps", str(ITERS * SOLO_B * 128),
                "--iters-per-call", "1", "--out-dir", tmp]))
            launches = read_counts()
        check(launches == expected(
            policy_rollout=8 * ITERS * cfg.fused_rollout,
            ppo_grads=40 * ITERS * cfg.fused_update),
            f"{name}: {launches}")
        check_finite(rows)
        print(f"[unfused] {name}: launches over {ITERS} iterations "
              f"{launches}; iteration seconds "
              f"{[round(r['seconds'], 4) for r in rows]}; ep_return_mean "
              f"{[round(r['ep_return_mean'], 3) for r in rows]}")
        out[name] = launches
    return out


def phase_unfused_population():
    """The pipeline's shape (P = 32 x 1024 envs, minibatch 32,768) on the
    three pairs: 2 iterations each through `train.run`, one a call, an
    eval of 32 x 32 episodes after the first, the launch counters read
    around each (as in phase_unfused_main_paths)."""
    from acas2d_tpu_torch import train
    for name, flags, _ in UNFUSED_CASES:
        argv = flags + ["--anneal-lr", "--population", str(POP),
                        "--n-envs", str(POP_B), "--minibatch-size",
                        str(POP_N), "--total-steps", str(2 * POP_B * 128),
                        "--eval-episodes", "32", "--reval-episodes", "0",
                        "--iters-per-call", "1"]
        cfg = train.build_config(train.parse_args(argv))
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts()
            rows = train.run(train.parse_args(argv + ["--out-dir", tmp]))
            launches = read_counts()
        check(launches == expected(policy_rollout=16 * cfg.fused_rollout,
                                   ppo_grads=80 * cfg.fused_update),
              f"P={POP} {name}: {launches}")
        check(len(rows) == 2, f"{len(rows)} rows")
        check_finite(rows)
        print(f"[unfused] P={POP} {name}: launches over 2 iterations "
              f"{launches}; iteration seconds "
              f"{[round(r['seconds'], 4) for r in rows]} (the first with "
              f"the warm-up), env-steps/s (all members) "
              f"{[round(r['steps_per_s']) for r in rows]}")


def phase_reference():
    """One eager iteration of the reference configuration of record (1 env
    x 2048 steps, minibatch 64, 10 epochs: 320 autograd minibatch steps),
    cut into rollout / GAE / update after a warm-up iteration."""
    from acas2d_tpu_torch import train
    from acas2d_tpu_torch.ppo import learner
    cfg = train.build_config(train.parse_args(["--preset", "reference"]))
    reset_counts()
    ms = breakdown(
        lambda mark: learner.make_train_step(cfg, DEFAULT_PARAMS, "cuda",
                                             on_phase=mark),
        learner.init_train_state(cfg, DEFAULT_PARAMS, "cuda"))
    launches = read_counts()
    check(launches == expected(), f"{launches}")
    print(f"[reference] one eager iteration {sum(ms.values()):.1f} ms "
          f"(phases {json.dumps({k: round(v, 2) for k, v in ms.items()})}); "
          f"launches {launches}")
    return ms


def phase_float64():
    """One unfused `tpu` iteration in float64 on the card against the same
    iteration on the CPU (same state, generator and so the same draws),
    within F64_PARAM_ATOL and F64_METRIC_RTOL; both times."""
    from acas2d_tpu_torch import train
    from acas2d_tpu_torch.ppo import learner
    argv = ["--preset", "tpu", "--dtype", "float64"]
    cfg = train.build_config(train.parse_args(argv))
    f64 = train.dtype_of(train.parse_args(argv))
    cpu = learner.init_train_state(cfg, DEFAULT_PARAMS, "cpu", dtype=f64)
    gen = torch.Generator()
    gen.set_state(cpu.generator.get_state())
    card = cpu.replace(
        params=cpu.params.cuda(), opt_state=learner.AdamState(
            mu=cpu.opt_state.mu.cuda(), nu=cpu.opt_state.nu.cuda()),
        env_state=EnvState(**{k: v.cuda() for k, v in
                              vars(cpu.env_state).items()}),
        obs=cpu.obs.cuda(), generator=gen)
    t0 = time.perf_counter()
    new_cpu, m_cpu = learner.make_train_step(cfg, DEFAULT_PARAMS, "cpu",
                                             dtype=f64)(cpu)
    cpu_s = time.perf_counter() - t0
    step = learner.make_train_step(cfg, DEFAULT_PARAMS, "cuda", dtype=f64)
    (new_card, m_card), card_ms = synced_ms(lambda: step(card))
    check(new_card.params.dtype == f64)
    err = float((new_card.params.cpu() - new_cpu.params).abs().max())
    moved = float((new_cpu.params - cpu.params).abs().max())
    rel = {k: abs(float(m_card[k]) - float(m_cpu[k]))
           / max(abs(float(m_cpu[k])), 1e-30) for k in m_cpu}
    worst = max(rel, key=rel.get)
    print(f"[float64] one unfused tpu iteration, card against CPU: params "
          f"max abs err {err:.3e} (they moved {moved:.3e}; tolerance "
          f"{F64_PARAM_ATOL}), worst metric {worst} rel err "
          f"{rel[worst]:.3e} (tolerance {F64_METRIC_RTOL}); episodes "
          f"{float(m_card['episodes'])} / {float(m_cpu['episodes'])}; "
          f"card {card_ms:.1f} ms (its first iteration), CPU {cpu_s:.2f} s")
    check(err <= F64_PARAM_ATOL and rel[worst] <= F64_METRIC_RTOL,
          "float64 on the card disagrees with the CPU")
    return err


# ----------------------------------------------------------------- phase 17

W1_ITERS, W1_K = 8, 4
# the stated float32 tolerance of two ranks against one process on the
# unfused paths: JAX's own for its sharded step (tests/test_sharding.py:
# 81-87) and, with the fused update, for its sharded fused update (:115-121)
SHARDED_TOL = {"xla": (1e-5, 1e-4), "fused_update": (2e-5, 2e-3)}
DRYRUN_TIMEOUT_S = 300


def run_train(argv, W):
    """`python -m acas2d_tpu_torch.train argv` (with `--out-dir` and
    `--run-name`) under `torch.distributed.run --nproc-per-node W`, or
    without the launcher for W = 0, one intra-op thread a process (as the
    launcher's): its rows, its summary and the median ms an iteration of
    its calls after the first (a row's `seconds` is its call's over K)."""
    pre = (["-m", "torch.distributed.run", "--nproc-per-node", str(W)]
           if W else [])
    res = subprocess.run(
        [sys.executable] + pre + ["-m", "acas2d_tpu_torch.train"] + argv,
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    check(res.returncode == 0, f"train on {W} ranks exited "
          f"{res.returncode}: {res.stderr[-3000:]}")
    run_dir = os.path.join(argv[argv.index("--out-dir") + 1],
                           argv[argv.index("--run-name") + 1])
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    rows = [json.loads(x) for x in res.stdout.splitlines()
            if x.startswith("{")]
    K = summary["iters_per_call"]
    return rows, summary, float(np.median([1e3 * r["seconds"]
                                           for r in rows[K:]]))


def checkpoints_differ(a, b):
    """The keys of two checkpoint dicts that differ."""
    out = []
    for k in ("params", "obs"):
        if not torch.equal(a[k], b[k]):
            out.append(k)
    for k in ("mu", "nu", "count"):
        x, y = a["adam"][k], b["adam"][k]
        if not (torch.equal(x, y) if torch.is_tensor(x) else x == y):
            out.append(f"adam.{k}")
    out += [f"env.{k}" for k, v in a["env_state"].items()
            if not torch.equal(v, b["env_state"][k])]
    if any(not torch.equal(g, h) for g, h in zip(a["generators"],
                                                 b["generators"])):
        out.append("generators")
    if a["iteration"] != b["iteration"]:
        out.append("iteration")
    return out


def phase_world_of_one():
    """(a) `train` with SOLO_ARGV, W1_ITERS iterations at W1_K a call, under
    `torch.distributed.run --nproc-per-node 1` (a group of one over NCCL:
    the batch gathered and every gradient all-reduced inside the replayed
    graph) and without the launcher: the final checkpoints and every row's
    metrics bit for bit, the launches of each run (its summary) 8 rollout
    and 40 gradient launches an iteration."""
    batch = SOLO_B * 128
    runs = {}
    with tempfile.TemporaryDirectory() as out:
        for launcher in (True, False):
            name = "nccl" if launcher else "plain"
            argv = SOLO_ARGV + [
                "--iters-per-call", str(W1_K), "--total-steps",
                str(W1_ITERS * batch), "--checkpoint-every",
                str(W1_ITERS * batch), "--out-dir", out, "--run-name", name]
            rows, summary, ms = run_train(argv, 1 if launcher else 0)
            ckpt = torch.load(os.path.join(out, name, "checkpoints",
                                           str(W1_ITERS * batch), "state.pt"),
                              weights_only=True)
            runs[name] = (rows, summary, ckpt, ms)
            check(len(rows) == W1_ITERS, f"{name}: {len(rows)} rows")
            check(summary["launches"] == {"policy_rollout": 8 * W1_ITERS,
                                          "ppo_grads": 40 * W1_ITERS},
                  f"{name}: launches {summary['launches']}")
            check(summary["iters_per_call"] == W1_K)
        check(runs["nccl"][1]["process_group"] == "nccl"
              and runs["nccl"][1]["n_devices"] == 1
              and runs["plain"][1]["process_group"] is None)
        differ = checkpoints_differ(runs["nccl"][2], runs["plain"][2])
        timing = ("seconds", "steps_per_s", "eval_seconds")
        differ += [f"row {i} {k}" for i, (x, y) in enumerate(
            zip(runs["nccl"][0], runs["plain"][0])) for k in x
            if k not in timing and x[k] != y.get(k)]
        check(not differ, f"a world of 1 over NCCL differs from the plain "
              f"driver in {differ}")
    print(f"[world of 1] torch.distributed.run --nproc-per-node 1 (NCCL) "
          f"and the plain driver, {W1_ITERS} iterations at {W1_K} a call "
          f"(replayed graphs): final checkpoints and "
          f"{len(runs['nccl'][0])} rows of metrics bit for bit; launches "
          f"{runs['nccl'][1]['launches']} each; ms an iteration of the "
          f"calls after the first {runs['nccl'][3]:.2f} / "
          f"{runs['plain'][3]:.2f}")


DRYRUN_VARIANTS = (("xla", 2), ("fused_rollout", 2), ("fused_update", 2),
                   ("population_fused", 1))


def dryrun_argv(out, W):
    """`parallel/dryrun.py`'s arguments: the solo `tpu` preset's 2048 envs
    split over W ranks (SOLO_B / W a rank), 2 iterations; the pipeline's
    P = 32 members (P / W a rank), one iteration."""
    return ["-m", "acas2d_tpu_torch.parallel.dryrun", "--out", out,
            "--variants", ",".join(v for v, _ in DRYRUN_VARIANTS),
            "--envs-per-rank", str(SOLO_B // W), "--minibatch", str(SOLO_N),
            "--chunk", str(K), "--pop", str(POP), "--pop-envs", str(POP_B),
            "--pop-minibatch", str(POP_N), "--iters", "2", "--pop-iters",
            "1"]


def dryrun_cfg(variant, W):
    from acas2d_tpu_torch.parallel import dryrun
    return dryrun.variant_config(variant, W, SOLO_B // W, 128, SOLO_N, 10,
                                 K, POP, POP_B, POP_N)


def dryrun_chunk_check(variant, out, W):
    """Each rank's first rollout chunk of `variant` against one launch of
    the kernel on that rank's rows at the seed its first generator gives
    + 7919 rank, bit for bit."""
    from acas2d_tpu_torch.parallel import dryrun, mesh as mesh_lib
    from acas2d_tpu_torch.ppo import learner
    cfg, P = dryrun_cfg(variant, W)
    state = dryrun.init_state(cfg, P, "cuda")
    gens = []
    for g in state.generators:
        gens.append(torch.Generator())
        gens[-1].set_state(g.get_state())
    probe = (state.replace(generators=gens) if P
             else state.replace(generator=gens[0]))
    seeds = learner.iteration_inputs(cfg, probe, 1, "cpu", seed_gens=(
        tuple(range(0, P, P // W)) if P else (0,)))[0][0]
    n = (P or SOLO_B) // W
    for r in range(W):
        seed = int(seeds[r if P else 0]) + 7919 * r
        seed = ((seed + 2 ** 31) % 2 ** 32) - 2 ** 31
        got = torch.load(os.path.join(out, f"{variant}_chunk{r}.pt"))
        check(got["seed"] == seed, f"{variant} rank {r}: seed {got['seed']}"
              f" vs {seed}")
        rows = slice(r * n, (r + 1) * n)

        def mine(x):
            """Rank r's rows, with a leading member axis."""
            return x[rows] if P else x[rows][None]
        es = mesh_lib.map_tensors(state.env_state, mine)
        flat = dict(px=es.px, py=es.py, psi=es.ppsi, tx=es.tx[..., 0],
                    ty=es.ty[..., 0], tv=es.tv[..., 0], tpsi=es.tpsi[..., 0],
                    steps=es.steps, total_reward=es.total_reward)
        _, buf = policy_rollout.fused_policy_rollout_members(
            flat, mine(state.obs), state.params[rows] if P
            else state.params[None], seed, 0, K, DEFAULT_PARAMS)
        want = {"obs": buf["obs"], "actions": buf["actions"][..., None],
                "log_probs": buf["log_probs"], "values": buf["values"],
                "rewards": buf["rewards"], "dones": buf["dones"] > 0}
        differ = [k for k, v in want.items()
                  if not torch.equal(got[k].cuda().reshape(v.shape), v)]
        check(not differ, f"{variant} rank {r}: its first chunk differs "
              f"from the kernel at seed + 7919 r in {differ}")


def check_dryrun(out, W, tag):
    """The dryrun's variants of W ranks (`dryrun_argv`) against one
    process: the unfused ones within SHARDED_TOL, each rank's first fused
    rollout chunk bit for bit against the kernel at seed + 7919 r, every
    rank's launches (8 rollout and 40 gradient launches an iteration on
    the fused paths)."""
    from acas2d_tpu_torch.parallel import dryrun
    for variant, iters in DRYRUN_VARIANTS:
        got = torch.load(os.path.join(out, f"{variant}.pt"),
                         weights_only=False)
        check(got["sharded"] and got["world"] == W)
        fr, fu, members = dryrun.VARIANTS[variant]
        want = torch.tensor([[8 * iters * fr, 40 * iters * fu]] * W)
        check(torch.equal(got["launches"], want),
              f"{variant}: launches by rank {got['launches'].tolist()}")
        check_finite([{k: v.cpu().numpy() for k, v in m.items()}
                      for m in got["metrics"]])
        print(f"[{tag}] {variant}: launches by rank (rollout, gradient) "
              f"{got['launches'].tolist()}")
        if variant in SHARDED_TOL:
            atol, rtol = SHARDED_TOL[variant]
            cfg, P = dryrun_cfg(variant, W)
            state = dryrun.init_state(cfg, P, "cuda")
            step = dryrun.make_step(cfg, P, "cuda")
            for _ in range(iters):
                state, m = step(state)
            two, errs = got["state"], {}
            for name, x, y in (("params", two["params"], state.params),
                               ("adam.mu", two["adam"]["mu"],
                                state.opt_state.mu),
                               ("adam.nu", two["adam"]["nu"],
                                state.opt_state.nu)):
                errs[name] = float((x.cuda() - y).abs().max())
                check(torch.allclose(x.cuda(), y, atol=atol, rtol=rtol),
                      f"{variant}: {name} of {W} ranks vs one process: "
                      f"max err {errs[name]:.3g}")
            for k, v in m.items():
                check(math.isclose(float(got["metrics"][-1][k]), float(v),
                                   rel_tol=max(rtol, 1e-3),
                                   abs_tol=10 * atol),
                      f"{variant}: metric {k} "
                      f"{float(got['metrics'][-1][k])} vs {float(v)}")
            print(f"[{tag}] {variant}: {W} ranks against one process "
                  f"after {iters} iterations, max abs err {errs} "
                  f"(tolerance atol {atol}, rtol {rtol})")
        else:
            dryrun_chunk_check(variant, out, W)
            print(f"[{tag}] {variant}: each rank's first chunk equals one "
                  f"launch of the kernel on its rows at seed + 7919 r, bit "
                  f"for bit")


def phase_two_ranks_one_card():
    """(b) `parallel/dryrun.py` on two ranks sharing cuda:0 over gloo (NCCL
    refuses two ranks on one device): the xla, fused_rollout and
    fused_update variants of JAX's dryrun_multichip at the solo `tpu`
    shape (1024 envs a rank), 2 eager iterations each, and the pipeline's
    fused population, P = 32 (16 a rank), one iteration, held by
    `check_dryrun`."""
    from acas2d_tpu_torch.parallel import launch
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        launch.check_ranks(launch.run_ranks(dryrun_argv(out, 2) + [
            "--device", "cuda:0", "--backend", "gloo"], 2, DRYRUN_TIMEOUT_S))
        wall = time.perf_counter() - t0
        check_dryrun(out, 2, "two ranks")
    print(f"[two ranks] wall of the two-rank run {wall:.1f} s")


def run_scaling(W, envs_per_device=4096):
    """`bench --scaling` under `torch.distributed.run --nproc-per-node W`:
    its points n = 1, 2, 4, ..., W and the summary."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(W), "-m", "acas2d_tpu_torch.bench", "--scaling",
         "--envs-per-device", str(envs_per_device), "--bench-steps", "64"],
        capture_output=True, text=True, timeout=900)
    check(out.returncode == 0, f"bench --scaling exited {out.returncode}: "
          f"{out.stderr[-3000:]}")
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    points, summary = lines[:-1], lines[-1]
    check(points and points[-1]["n_devices"] == W
          and all(p["rollout_steps_per_s"] > 0 and p["train_steps_per_s"] > 0
                  for p in points)
          and summary["target"] == 0.8, f"bench --scaling printed {lines}")
    for x in lines:
        print(f"[scaling] {json.dumps(x)}")
    return lines


def phase_scaling():
    """(c) `bench --scaling` at W = 1 (`run_scaling`)."""
    run_scaling(1)


def phase_multi_process():
    """Phase 17: the multi-process paths on the one card."""
    phase_world_of_one()
    phase_two_ranks_one_card()
    phase_scaling()


# ----------------------------------------------------------------- phase 18

GYM_ACTIONS = "artifacts/gym_main_actions.npy"
REPLAY_PX_TOL = 1e-9          # tests/test_drivers.py:195-237's tolerances
REPLAY_REWARD_TOL = 1e-12
BASELINE_EPISODES = 100
BASELINE_PX_TOL = 1e-9        # tests/test_drivers.py:24-41's tolerances
BASELINE_REWARD_TOL = 1e-8


def env_checks(device) -> str:
    """(a) The env checker on the core (200 steps) and on the legacy gym
    env (100 steps) on `device`; returns which Box the spaces are."""
    from acas2d_tpu_torch.envs import gym_compat
    from acas2d_tpu_torch.utils.env_check import (check_functional_env,
                                                  check_gym_env)
    check_functional_env(DEFAULT_PARAMS, 200, device=device)
    check_gym_env(gym_compat.LegacyACAS2DEnv(device=device), 100)
    return ("gymnasium.spaces.Box" if gym_compat._HAS_GYMNASIUM
            else "_PlainBox (gymnasium is not installed)")


def gym_replay(device):
    """(b) The reference's recorded actions (`GYM_ACTIONS`, padded with
    their last value) through `LegacyACAS2DEnv` in float64 on `device`
    against the port's scalar `OracleEnv`, from the same spawn (the
    stream's third: two resets burn the reference's two spawns): each
    step's reward within REPLAY_REWARD_TOL, px and py within
    REPLAY_PX_TOL, done, outcome and step count exact.  Returns (steps,
    median ms a gym step on the host clock, largest px error, largest
    reward error)."""
    from acas2d_tpu_torch.envs.gym_compat import LegacyACAS2DEnv
    from acas2d_tpu_torch.oracle import MersenneSpawner, OracleEnv
    P = DEFAULT_PARAMS
    seq = np.load(GYM_ACTIONS)
    acts = np.full(P.max_steps, seq[-1])
    acts[:len(seq)] = seq[:P.max_steps]
    env = LegacyACAS2DEnv(P, device=device, dtype=torch.float64)
    for _ in range(3):
        env.reset()
    oracle_env = OracleEnv(P, spawner=MersenneSpawner(P, skip_episodes=2))
    oracle_env.reset()
    step_ms, px_err, r_err = [], 0.0, 0.0
    for a in acts:
        t0 = time.perf_counter()
        _, r, done, info = env.step(np.array([a]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        _, r_o, done_o, _ = oracle_env.step(np.array([a]))
        st, so = env._backend.state, oracle_env.state
        px_err = max(px_err, abs(float(st.px[0]) - so.px),
                     abs(float(st.py[0]) - so.py))
        r_err = max(r_err, abs(r - r_o))
        check(done == done_o and info == {}, "gym replay: done differs")
        if done:
            break
    check(done, "gym replay: the episode did not end")
    check(env.outcome == oracle_env.state.outcome
          and int(env._backend.state.steps[0]) == oracle_env.state.steps,
          "gym replay: outcome or step count differs")
    check(px_err <= REPLAY_PX_TOL and r_err <= REPLAY_REWARD_TOL,
          f"gym replay: px error {px_err:.3e}, reward error {r_err:.3e}")
    return len(step_ms), float(np.median(step_ms)), px_err, r_err


def baseline_runs(devices, episodes=BASELINE_EPISODES):
    """(c) `python -m acas2d_tpu_torch.baseline --episodes N` (the zero
    policy, float64) on each device in turn: {device: (its CSV's rows,
    wall seconds)}.  Its per-episode lines are kept off stdout."""
    import contextlib
    import io

    from acas2d_tpu_torch import baseline
    from acas2d_tpu_torch.utils.episode_csv import read_csv as read_rows
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in devices:
            out = os.path.join(tmp, f"{dev}.csv")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = baseline.main(["--episodes", str(episodes), "--out",
                                    out, "--device", dev])
            check(rc == 0, f"baseline on {dev} exited {rc}")
            runs[dev] = (read_rows(out), time.perf_counter() - t0)
    return runs


def compare_baselines(got, want):
    """Two baseline CSVs' rows: outcomes and time steps equal, paths and
    traffic paths within BASELINE_PX_TOL, total rewards within
    BASELINE_REWARD_TOL.  Returns (episodes whose path is bit-identical,
    largest px error, largest reward error)."""
    check(len(got) == len(want), "baselines: episode counts differ")
    same, px_err, r_err = 0, 0.0, 0.0
    for g, w in zip(got, want):
        check(g["Outcome"] == w["Outcome"]
              and g["Time Steps"] == w["Time Steps"],
              f"baselines: episode {g['Episode']} outcome or steps differ")
        for key in ("Path", "Traffic Paths"):
            a, b = np.asarray(g[key]), np.asarray(w[key])
            check(a.shape == b.shape, f"baselines: {key} shapes differ")
            px_err = max(px_err, float(np.abs(a - b).max(initial=0.0)))
        r_err = max(r_err, abs(g["Total Reward"] - w["Total Reward"]))
        same += g["Path"] == w["Path"]
    check(px_err <= BASELINE_PX_TOL and r_err <= BASELINE_REWARD_TOL,
          f"baselines: px error {px_err:.3e}, reward error {r_err:.3e}")
    return same, px_err, r_err


def phase_host_surface():
    """Phase 18: the host-side surface on the card (the env checker, the
    gym env, the baseline driver), which launches no kernel."""
    reset_counts()
    boxes = env_checks("cuda")
    print(f"[host] check_functional_env (200 steps) and check_gym_env("
          f"LegacyACAS2DEnv, 100 steps) passed on the card; spaces: {boxes}")
    steps, step_ms, px_err, r_err = gym_replay("cuda")
    print(f"[host] {GYM_ACTIONS} through LegacyACAS2DEnv (float64, card) "
          f"against OracleEnv: {steps} steps, px error {px_err:.3e}, reward "
          f"error {r_err:.3e}; median {step_ms:.4f} ms a gym step")
    runs = baseline_runs(["cuda", "cpu"])
    same, px_err, r_err = compare_baselines(runs["cuda"][0], runs["cpu"][0])
    print(f"[host] baseline --episodes {BASELINE_EPISODES} (zero policy, "
          f"float64): card {runs['cuda'][1]:.3f} s, CPU {runs['cpu'][1]:.3f} "
          f"s; outcomes and steps equal, px error {px_err:.3e}, reward error "
          f"{r_err:.3e}; {same}/{BASELINE_EPISODES} paths bit-identical "
          f"between card and CPU")
    launches = read_counts()
    check(launches == expected(), f"the host surface launched {launches}")
    try:
        import matplotlib  # noqa: F401
        drawing = "installed"
    except ImportError:
        drawing = "not installed"
    print(f"[host] no kernel launched.  Not run here: rendering, analysis "
          f"and manual play, which draw with matplotlib ({drawing} on this "
          f"machine); the CPU tests cover them")


# ----------------------------------------------------------------- phase 19

# the sub-minute command's members and the seed of its record; the cut's
# stage-1 iterations
SUB_P, SUB_SEED, SUB_ITERS = 8, 3001, 3
FLAGSHIP_EXACT = 1252.7158637595496       # phase 6's mean on the card
# the port's module -> SB3 MlpPolicy's layer: the flagship goes into a zip
# under SB3's names by this table, the inverse of the import's own
PORT_TO_SB3 = {"pi_tower.dense_0": "mlp_extractor.policy_net.0",
               "pi_tower.dense_1": "mlp_extractor.policy_net.2",
               "vf_tower.dense_0": "mlp_extractor.value_net.0",
               "vf_tower.dense_1": "mlp_extractor.value_net.2",
               "action_head": "action_net",
               "value_head": "value_net"}
# the parity sweep cut to a few hundred steps a run
SWEEP_CUT = ("--n-steps", "256", "--total-steps", "512", "--eval-every",
             "256", "--eval-episodes", "4", "--checkpoint-every", "256")
SWEEP_SEEDS = {"ref": (8,), "env8": (8,), "exact_eval_ref": (12,)}


def with_values(argv, **values):
    """argv with the value after each flag replaced (`total_steps=N`
    replaces the value of --total-steps)."""
    argv = list(argv)
    for name, v in values.items():
        argv[argv.index("--" + name.replace("_", "-")) + 1] = str(v)
    return argv


def sb3_round_trip(eval_res):
    """(b): the flagship's params into a zip under SB3's names, through
    `compat.sb3_import`, written as an npz and scored by the exact eval,
    which must be phase 6's, bit for bit."""
    from acas2d_tpu_torch import eval as eval_driver
    from acas2d_tpu_torch.compat import sb3_import
    from acas2d_tpu_torch.utils.params_io import (from_jax_params,
                                                  load_params_npz,
                                                  save_params_npz)
    sd = from_jax_params(load_params_npz(FLAGSHIP))
    sb3 = {"log_std": sd["log_std"]}
    for port, name in PORT_TO_SB3.items():
        for leaf in ("weight", "bias"):
            sb3[f"{name}.{leaf}"] = sd[f"{port}.{leaf}"]
    with tempfile.TemporaryDirectory() as out:
        buf = io.BytesIO()
        torch.save(sb3, buf)
        path = os.path.join(out, "flagship_sb3.zip")
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("policy.pth", buf.getvalue())
        got, tree = sb3_import.load_sb3_policy(path)
        same = set(got) == set(sd) and all(torch.equal(got[k], sd[k])
                                           for k in sd)
        npz = os.path.join(out, "flagship_sb3.npz")
        save_params_npz(npz, tree)
        res = eval_driver.run(eval_driver.parse_args(
            ["--params-npz", npz, "--exact", "--episodes", "100", "--out",
             os.path.join(out, "eval_100.csv")]))
    print(f"[sb3] flagship -> SB3 zip -> compat.sb3_import -> npz: state "
          f"dict bit-identical {same}; exact eval mean {res['mean_reward']!r}"
          f", {res['goals']}/100 goals (phase 6: {eval_res['mean_reward']!r})")
    check(same, "the SB3 import changed the flagship's params")
    check(res["mean_reward"] == eval_res["mean_reward"] == FLAGSHIP_EXACT
          and res["goals"] == 100,
          "the imported flagship does not score as phase 6")


def sub_minute_cut(dev, out):
    """(c): `sub_minute` with scripts/sub_minute.sh's command cut to
    SUB_ITERS iterations, a 64-episode re-eval and a one-iteration polish,
    one eager iteration a call; the launch counters read around it (the
    strict eval launches none), `training_wall_s` beside the merge record,
    and the strict CSV's mean the summary's.  Returns its launches and the
    strict eval's summary."""
    from acas2d_tpu_torch import sub_minute
    batch = POP_B * 128
    argv = with_values(sub_minute.SUB_MINUTE_ARGV,
                       total_steps=SUB_ITERS * batch,
                       checkpoint_every=SUB_ITERS * batch, reval_episodes=64,
                       polish_steps=batch) + ["--iters-per-call", "1"]
    reset_counts()
    rec = sub_minute.run_sub_minute(SUB_SEED, "smoke", argv, out,
                                    device=dev.type)
    launches = read_counts()
    iters = SUB_ITERS + 1
    print(f"[sub_minute] launches over {iters} iterations ({SUB_ITERS} at "
          f"P={SUB_P}, 1 polish at P={SUB_P}): {launches}; training wall "
          f"{rec['training_wall_s']:.2f} s")
    check(launches == expected(policy_rollout=8 * iters,
                               ppo_grads=40 * iters))
    with open(os.path.join(rec["polish"], "population.json")) as f:
        pop = json.load(f)
    check({"training_wall_s", "stage1", "pipeline"} <= set(pop)
          and pop["population"] == SUB_P,
          f"population.json keys {sorted(pop)}")
    rows = read_csv(os.path.join(rec["polish"], "eval_100_exact.csv"))
    csv_mean = float(np.mean([float(r["Total Reward"]) for r in rows]))
    strict = rec["strict"]
    print(f"[sub_minute] training_wall_s {pop['training_wall_s']}; strict "
          f"eval {strict['mean_reward']:.4f}, {strict['goals']}/100 goals; "
          f"CSV mean {csv_mean!r}")
    check(len(rows) == 100 and csv_mean == strict["mean_reward"],
          "the strict CSV's returns are not the summary's")
    return launches, strict


def sweep_and_exports(dev, out, strict):
    """(d): the parity sweep cut to SWEEP_CUT (a reference-config seed, an
    8-env seed and the --exact-eval run; no kernel: the reference config
    runs the unfused paths), then both exporters: the sweep's curves,
    summary and best params, and (c)'s run as a population record."""
    from acas2d_tpu_torch import (export_parity_artifacts,
                                  export_population_artifacts, parity_sweep)
    from acas2d_tpu_torch.utils.checkpoint import CheckpointManager
    from acas2d_tpu_torch.utils.params_io import load_flat_params
    sweep = tuple((p, tuple(flags) + SWEEP_CUT, seeds)
                  for p, flags, seeds in parity_sweep.SWEEP)
    sweep_dir, exp = os.path.join(out, "parity"), os.path.join(out, "exp")
    reset_counts()
    dirs, ms = synced_ms(lambda: parity_sweep.run_sweep(
        sweep_dir, SWEEP_SEEDS, sweep, device=dev.type))
    launches = read_counts()
    names = [os.path.basename(d) for d in dirs]
    print(f"[sweep] {names} in {ms / 1e3:.2f} s; launches {launches}")
    check(names == ["ref_s8", "env8_s8", "exact_eval_ref_s12"]
          and launches == expected(), f"{names}, {launches}")
    check(export_parity_artifacts.main([sweep_dir, *names, "--out-dir",
                                        exp]) == 0)
    with open(os.path.join(exp, "parity_sweep_summary.json")) as f:
        summary = json.load(f)
    print(f"[sweep] summary {json.dumps(summary)}")
    check(sorted(summary) == sorted(names) and all(
        math.isfinite(v["final_eval_return"]) for v in summary.values()))
    for name in ("ref_s8", "env8_s8"):
        params, _ = load_flat_params(os.path.join(exp,
                                                  f"ppo_{name}_best.npz"))
        best = CheckpointManager(os.path.join(
            sweep_dir, name, "checkpoints")).restore_raw(best=True)
        check(torch.equal(params, best["params"].float().cpu()),
              f"{name}: exported params are not the best checkpoint's")
    check(export_population_artifacts.main(
        ["--run-prefix", "smoke", "--seeds", str(SUB_SEED), "--stage",
         "polish", "--runs-dir", out, "--out-dir", exp]) == 0)
    with open(os.path.join(exp, f"smoke_s{SUB_SEED}_strict.json")) as f:
        rec = json.load(f)
    print(f"[export] strict record {json.dumps(rec)}")
    check(rec["mean_reward"] == round(strict["mean_reward"], 2)
          and rec["goals"] == strict["goals"] and rec["episodes"] == 100,
          "the strict record is not the strict eval's")


def phase_last_modules(dev, eval_res):
    """Phase 19: the P = 8 kernels against their plain versions, the SB3
    round trip, `sub_minute` and the parity sweep at cut budgets, both
    exporters, and `bench --train --fused off`.  Returns the P = 8 kernel
    rows' operands and errors, and their launches in `sub_minute`."""
    from acas2d_tpu_torch import bench
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape = policy_rollout.launch_shape(SUB_P, POP_B, sms)
    print(f"[p8] member rollout launch shape at P={SUB_P} B={POP_B} on "
          f"{sms} SMs: (MT, W) = {shape}")
    check(shape == (1, 2), f"launch shape {shape}")
    roll = phase_rollout(dev, SUB_P, POP_B)
    grads = phase_grads(dev, SUB_P, POP_N)
    sb3_round_trip(eval_res)
    with tempfile.TemporaryDirectory() as out:
        launches, strict = sub_minute_cut(dev, out)
        sweep_and_exports(dev, out, strict)
    reset_counts()
    res = bench.run(bench.parse_args(["--train", "--fused", "off"]))
    launches_off = read_counts()
    print(json.dumps(res))
    print(f"[bench] --train --fused off: paths {sorted(res['paths'])}; "
          f"launches {launches_off}")
    check(set(res["paths"]) == {"xla"} and "best_case_4096" not in res
          and launches_off == expected())
    return roll, grads, launches


# ----------------------------------------------------- phase 17, W cards

CARDS_ITERS = 16


def phase_across_cards(W):
    """Phase 17 on W cards (`python3 chip_smoke.py --cards W`): the dryrun
    on W ranks over NCCL (`check_dryrun`); the solo `tpu` preset
    (SOLO_ARGV, 2048 envs split over the cards) and the pipeline's P = 32
    (its members split) trained CARDS_ITERS iterations at JAX's default K
    on W ranks and alone, ms an iteration each (strong scaling: the same
    run on more cards), their launches; and `bench --scaling` up to W."""
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", str(W)] + dryrun_argv(out, W),
            capture_output=True, text=True,
            timeout=DRYRUN_TIMEOUT_S)
        check(res.returncode == 0, f"dryrun on {W} cards exited "
              f"{res.returncode}: {res.stderr[-3000:]}")
        check_dryrun(out, W, f"{W} cards")
    print(f"[{W} cards] dryrun wall {time.perf_counter() - t0:.1f} s")
    batch = SOLO_B * 128
    cases = (("solo", SOLO_ARGV + ["--total-steps",
                                   str(CARDS_ITERS * batch)]),
             ("P = 32", POP_ARGV[:POP_ARGV.index("--total-steps")]
              + ["--total-steps", str(CARDS_ITERS * POP_B * 128),
                 "--eval-episodes", "32", "--reval-episodes", "64"]))
    for name, argv in cases:
        got = {}
        for w in (W, 0):
            with tempfile.TemporaryDirectory() as out:
                rows, summary, ms = run_train(
                    argv + ["--out-dir", out, "--run-name", "r"], w)
            check(len(rows) == CARDS_ITERS, f"{name}: {len(rows)} rows")
            check_finite(rows)
            check(summary["launches"] == {
                "policy_rollout": 8 * CARDS_ITERS,
                "ppo_grads": 40 * CARDS_ITERS},
                  f"{name} on {w or 1} cards: launches {summary['launches']}")
            check(summary["n_devices"] == (w or 1))
            got[w] = ms
        print(f"[{W} cards] {name}: ms an iteration (calls after the "
              f"first, K = {summary['iters_per_call']}) on {W} cards "
              f"{got[W]:.2f}, on one {got[0]:.2f}: {got[0] / got[W]:.3f}x; "
              f"launches a rank {8 * CARDS_ITERS} / {40 * CARDS_ITERS}")
    run_scaling(W)


# ------------------------------------------------------------------ phase 7

def env_state(dev, B, seed=5):
    """B fresh spawns on `dev` flown part-way by the env-only kernel (the
    first half 320 steps, when random-action collisions begin; the second
    576, when goals do), every third step counter then moved to 940-1000
    so that timeouts occur too: the nine flat (B,) state arrays."""
    gen = torch.Generator().manual_seed(seed)
    es, _ = vector.reset_batch(B, DEFAULT_PARAMS, gen, torch.float32, dev)
    st = env_rollout.flat_state(es)
    half = B // 2
    parts = [env_rollout.fused_rollout({k: v[sl] for k, v in st.items()},
                                       seed, n)[0]
             for sl, n in ((slice(0, half), 320), (slice(half, B), 576))]
    st = {k: torch.cat([p[k] for p in parts]) for k in env_rollout.STATE_KEYS}
    late = torch.randint(940, DEFAULT_PARAMS.max_steps + 1, (B,),
                         generator=gen, dtype=torch.int32).to(dev)
    st["steps"][::3] = late[::3]
    return st


def compare_env(tag, got, want, T):
    """The env rollout kernel's outputs against the plain version's by
    `env_rollout.agreement`: prints the flipped envs and every field, then
    checks.  Returns the largest float error."""
    flipped, errs, failed = env_rollout.agreement(got, want, T)
    g = {k: got[k].to(want[k].device) for k in ("steps", "episodes",
                                                 "obs_sum")}
    print(f"[{tag}] {len(flipped)} of {want['steps'].numel()} envs flipped "
          f"a threshold" + "".join(
              f"; env {e}: steps {int(g['steps'][e])} vs "
              f"{int(want['steps'][e])}, episodes {int(g['episodes'][e])} "
              f"vs {int(want['episodes'][e])}, obs_sum "
              f"{float(g['obs_sum'][e]):.4f} vs {float(want['obs_sum'][e]):.4f}"
              for e in flipped[:3].tolist()))
    for k, (err, tol) in errs.items():
        print(f"[{tag}] {k}: max abs err {err:.3e} (tol {tol:.3e})")
    check(not failed, f"{tag}: {failed} differ from the plain version")
    return max(err for err, _ in errs.values())


def phase_env_rollout(dev):
    """The public wrapper on CUDA tensors (the kernel) against the same call
    on copies on the CPU (the plain version), in the three modes."""
    st = env_state(dev, ENV_B)
    max_err = 0.0
    for mode in (dict(), dict(with_obs=True),
                 dict(zero_actions=True, with_obs=True)):
        tag = "env rollout " + ("zero" if mode.get("zero_actions")
                                else "random") + (
                                    " obs" if mode.get("with_obs") else "")
        gs, gstats = env_rollout.fused_rollout(st, 11, ENV_T, **mode)
        ws, wstats = env_rollout.fused_rollout(on_cpu(st), 11, ENV_T, **mode)
        torch.cuda.synchronize()
        max_err = max(max_err, compare_env(tag, {**gs, **gstats},
                                           {**ws, **wstats}, ENV_T))
        ends = {k: int(wstats[k].sum()) for k in
                ("episodes", "goals", "collisions")}
        print(f"[{tag}] B={ENV_B} T={ENV_T}: episode ends {ends}")
        check(ends["goals"] > 0 and ends["collisions"] > 0
              and ends["episodes"] > ends["goals"] + ends["collisions"],
              "every kind of episode end should occur")
        if not mode.get("with_obs"):
            check(float(gstats["obs_sum"].abs().max()) == 0.0,
                  "obs_sum must be 0 without obs")
    return max_err


def engine_run(dev, B, T, seed, zero_actions):
    """The port's general engine (`vector.step_autoreset_batch`, eager) from
    a seeded reset: (initial state, final state, summed rewards, episode
    ends, goals, collisions)."""
    s0, _ = vector.reset_batch(B, DEFAULT_PARAMS,
                               torch.Generator().manual_seed(seed),
                               torch.float32, dev)
    act_gen = torch.Generator(device=dev).manual_seed(seed + 12)
    spawn_gen = torch.Generator(device=dev).manual_seed(seed + 13)
    s = s0
    rsum = torch.zeros(B, device=dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    for _ in range(T):
        a = (torch.zeros(B, device=dev) if zero_actions else
             torch.rand(B, generator=act_gen, device=dev) * 2.0 - 1.0)
        s, out = vector.step_autoreset_batch(s, a, DEFAULT_PARAMS, spawn_gen)
        rsum = rsum + out.reward
        counts += torch.stack([out.done.sum(),
                               ((out.outcome == 1) & out.done).sum(),
                               ((out.outcome == 2) & out.done).sum()])
    return s0, s, rsum, [int(c) for c in counts.cpu()]


def phase_env_engine(dev):
    """Kernel vs the port's general engine on the card
    (pallas_tpu_check.py:53-134): zero actions for 64 steps from fresh
    spawns (no episode ends), then outcome rates under random actions."""
    s0, s, rsum, _ = engine_run(dev, ZERO_B, ZERO_T, 42, zero_actions=True)
    st, stats = env_rollout.fused_rollout(env_rollout.flat_state(s0), 7,
                                          ZERO_T, zero_actions=True)
    check(torch.equal(st["steps"], s.steps), "zero-action step counters")
    for name, a, b in (("px", s.px, st["px"]), ("py", s.py, st["py"]),
                       ("psi", s.ppsi, st["psi"]),
                       ("tx", s.tx[:, 0], st["tx"]),
                       ("ty", s.ty[:, 0], st["ty"])):
        err = float((a - b).abs().max())
        print(f"[env parity] zero actions, {name}: max abs err {err:.3e}")
        check(err <= 2e-2, f"zero-action {name} err {err}")
    r_err = float((rsum - stats["reward_sum"]).abs().max())
    r_tol = 2e-3 + 2e-3 * float(rsum.abs().max())
    print(f"[env parity] zero actions, reward_sum: max abs err {r_err:.3e} "
          f"(tol {r_tol:.3e})")
    check(r_err <= r_tol, "zero-action reward sums")

    B, T = STAT_B, STAT_T
    s0, _, _, (ep_x, goal_x, coll_x) = engine_run(dev, B, T, 5, False)
    _, pstats = env_rollout.fused_rollout(env_rollout.flat_state(s0), 11, T)
    ep_p, goal_p, coll_p = (int(pstats[k].sum()) for k in
                            ("episodes", "goals", "collisions"))
    print(f"[env statistics] B={B} T={T}: kernel episodes {ep_p}, goals "
          f"{goal_p}, collisions {coll_p}; engine {ep_x}, {goal_x}, {coll_x}")
    for key, a, b in (("goal_rate", goal_p / ep_p, goal_x / ep_x),
                      ("collision_rate", coll_p / ep_p, coll_x / ep_x)):
        pbar = (a + b) / 2
        sigma = math.sqrt(max(pbar * (1 - pbar), 1e-9)
                          * (1 / ep_p + 1 / ep_x))
        print(f"[env statistics] {key}: kernel {a:.5f} engine {b:.5f} "
              f"(5 sigma {5 * sigma:.5f})")
        check(abs(a - b) <= 5 * sigma + 1e-4, f"{key} outside 5 sigma")
    check(abs(ep_p - ep_x) <= 0.02 * max(ep_p, ep_x),
          "episode counts differ by more than 2%")


# ------------------------------------------------------------------ phase 8

def phase_bench():
    """The headline of `python -m acas2d_tpu_torch.bench` at its full size:
    its two measures (`bench.measure_fused` without and with obs, as
    `bench.headline_main` calls them), each with the launch counters read
    around it, and its JSON line; then its --train mode, with the counters
    around it.  Returns {row: (launches, the state the measure's last
    launch left, with_obs)}."""
    from acas2d_tpu_torch import bench
    per_measure = 1 + 8 * 3              # warm-up + iters x repeats
    out, rates = {}, {}
    for name, with_obs in (("env_rollout", False), ("env_rollout_obs", True)):
        reset_counts()
        rates[name], st = bench.measure_fused(with_obs=with_obs,
                                              device="cuda",
                                              return_state=True)
        launches = read_counts()
        print(f"[bench] launches over the headline's measure "
              f"with_obs={with_obs}: {launches}")
        check(launches == expected(env_rollout=per_measure),
              f"{launches}, expected {per_measure} env_rollout launches")
        out[name] = (launches["env_rollout"], st, with_obs)
    print(json.dumps(bench.headline_record(
        rates["env_rollout"], rates["env_rollout_obs"], torch.device("cuda"))))
    reset_counts()
    bench.main(["--train"])
    launches = read_counts()
    # 5 calls a variant: its iterations on the fused rollout and update
    its = {label: 5 * loop_k for label, _, _, _, loop_k
           in bench.TRAIN_VARIANTS}
    rollout_its = sum(its[label] for label, fr, _, _, _
                      in bench.TRAIN_VARIANTS if fr) + 5 * 32  # + 4096 envs
    update_its = sum(its[label] for label, _, fu, _, _
                     in bench.TRAIN_VARIANTS if fu)
    print(f"[bench] launches over --train ({len(its)} variants and "
          f"best_case_4096, 5 calls each: {rollout_its} iterations on the "
          f"fused rollout, {update_its} on the fused update): {launches}")
    check(launches == expected(policy_rollout=8 * rollout_its,
                               ppo_grads=40 * update_its))
    return out


# ------------------------------------------------------------------ phase 9

BLOCK_NAMES = [f"{t}.{nm}" for t in ("pi", "vf")
               for nm in ("w1", "b1", "w2", "b2", "w_head", "b_head")] + [
                   "log_std"]
BLOCK_SIZES = [HIDDEN * OBS_DIM, HIDDEN, HIDDEN * HIDDEN, HIDDEN, HIDDEN,
               1] * 2 + [1]


def block_errs(g, ref):
    """{block: [(max |g - ref|, max |ref| of the block, max |ref| of its
    tower) of each member]}; log_std is its own tower."""
    out = {name: [] for name in BLOCK_NAMES}
    n_tower = sum(BLOCK_SIZES[:6])
    for gm, rm in zip(g, ref):
        towers = (float(rm[:n_tower].abs().max()),
                  float(rm[n_tower:2 * n_tower].abs().max()),
                  float(rm[-1].abs()))
        for i, (name, gb, rb) in enumerate(zip(
                BLOCK_NAMES, gm.split(BLOCK_SIZES), rm.split(BLOCK_SIZES))):
            out[name].append((float((gb - rb).abs().max()),
                              float(rb.abs().max()), towers[i // 6]))
    return out


def phase_bf16_grads(dev, P, n):
    """The public wrapper with bf16=True on the card against the same call
    on the CPU, and against the f32 kernel on the same inputs.  Returns
    (the kernel's operands, the max abs error, whether the bf16 grads equal
    the f32 ones bit for bit)."""
    cfg = tpu_default()
    params, mb = grads_inputs(dev, P, n)
    kw = dict(clip_range=cfg.clip_range, vf_coef=cfg.vf_coef,
              ent_coef=cfg.ent_coef, normalize_advantage=True)
    g, aux = ppo_grads.ppo_minibatch_grads_members(params, mb, bf16=True,
                                                   **kw)
    g32, _ = ppo_grads.ppo_minibatch_grads_members(params, mb, **kw)
    w, waux = ppo_grads.ppo_minibatch_grads_members(params.cpu(), mb.cpu(),
                                                    bf16=True, **kw)
    torch.cuda.synchronize()
    g, g32 = g.cpu(), g32.cpu()
    tag = "bf16 grads" if P == 1 else "bf16 member grads"
    errs, f32_errs = block_errs(g, w), block_errs(g32, w)
    for name in BLOCK_NAMES:
        # accuracy: the member with the largest error for its allowance
        share, err, dev, tower = max(
            (e / max(BF16_VS_F32 * d, GRAD_REL_TOL * t), e, d, t)
            for (e, _, t), (d, _, _) in zip(errs[name], f32_errs[name]))
        line = (f"[{tag}] {name}: bf16 kernel vs plain {err:.3e}, f32 "
                f"kernel vs plain bf16 {dev:.3e}, tower scale {tower:.3e} "
                f"({share:.2f} of the allowance)")
        sep = None
        if name in SEPARATING:
            sep = (sum(e for e, _, _ in errs[name])
                   / max(sum(d for d, _, _ in f32_errs[name]), 1e-30))
            line += f"; separation {sep:.3e} (at most {BF16_VS_F32})"
        print(line)
        check(share <= 1.0, f"bf16 gradient {name} err {err}")
        check(sep is None or sep <= BF16_VS_F32,
              f"bf16 gradient {name} is not closer to the plain bf16 "
              f"version than the f32 kernel is")
    for key in sorted(waux):
        a, b = aux[key].cpu().double(), waux[key].double()
        rel = float(((a - b).abs() / (b.abs() + 1e-6)).max())
        print(f"[{tag}] {key} rel err {rel:.3e}")
        check(rel < GRAD_REL_TOL, f"bf16 aux {key} differs")
    devs = []
    for name, per_member in block_errs(g, g32).items():
        d = max(e for e, _, _ in per_member)
        scale = max(sc for _, sc, _ in per_member)      # the leaf's scale
        devs.append((d / (BF16_DEV_MAX * scale + BF16_DEV_FLOOR),
                     d / scale, name))
    share, rel, name = max(devs)
    print(f"[{tag}] P={P} N={n}: deviation from the f32 kernel, worst block "
          f"{name} at {rel:.3e} of its scale ({share:.2f} of the cap "
          f"3e-2 x scale + 5e-6); worst weight block at "
          f"{max(r for _, r, nm in devs if '.w' in nm):.3e}")
    check(share <= 1.0, "bf16 deviates from f32 beyond 3e-2 x scale + 5e-6")
    check(max(rel for _, rel, _ in devs) > 0.0, "bf16 equals f32")
    data = ppo_grads.normalize_adv_column(mb).contiguous()
    consts = ppo_grads._constants(n, cfg.clip_range, cfg.vf_coef)
    return ((params, data, consts, cfg.ent_coef, True),
            float((g - w).abs().max()), bool(torch.equal(g, g32)))


def phase_probe(bf16_equals_f32: bool):
    """The probe kernel against its plain version, on its JAX input and on
    random operands; then its answer, with the launch counter around it,
    which must explain whether the bf16 grads equal the f32 ones
    (pallas_tpu_check.py:264-269).  Returns (operands for the timing, max
    abs error, launches of the answer)."""
    a, b = precision_probe.probe_inputs("cuda")
    gen = torch.Generator().manual_seed(3)
    x, y = (torch.randn(128, 128, generator=gen) for _ in range(2))
    err = 0.0
    for u, v in ((a, b), (x.cuda(), y.cuda())):
        got = precision_probe.precision_probe(u, v)
        want = precision_probe.precision_probe(u.cpu(), v.cpu())
        err = max(err, max(float((g.cpu() - w).abs().max())
                           for g, w in zip(got, want)))
    print(f"[probe] kernel vs plain: max abs err {err:.3e}")
    check(err <= 1e-4, "probe kernel differs from its plain version")
    o_def, o_bf, o_hi = (o[0, 0].item() for o in
                         precision_probe.precision_probe(a, b))
    reset_counts()
    quantizes = precision_probe.quantizes_operands("cuda")
    launches = read_counts()
    check(launches == expected(precision_probe=1))
    print(f"[probe] quantizes={quantizes}: o_def {o_def!r}, o_bf {o_bf!r}, "
          f"o_hi {o_hi!r}; bf16 grads bit-identical to f32: "
          f"{bf16_equals_f32}")
    check(quantizes == bf16_equals_f32,
          "the probe contradicts the bf16-vs-f32 deviation")
    return (x.cuda(), y.cuda()), err, launches["precision_probe"]


def phase_bf16_training():
    """`train` with SOLO_ARGV and `--fused-update-bf16` for 3 iterations,
    then one iteration of the population command with --fused-update-bf16
    (the in-training eval cut to 4 episodes, no re-eval, no polish): the
    launch counters around each.  Then one more bf16 population iteration
    cut into its phases.  Returns (solo launches, population launches, phase ms)."""
    from acas2d_tpu_torch import train
    with tempfile.TemporaryDirectory() as out:
        argv = SOLO_ARGV + ["--fused-update-bf16",
                "--total-steps", str(ITERS * SOLO_B * 128),
                "--iters-per-call", "1", "--out-dir", out]
        reset_counts()
        rows = train.run(train.parse_args(argv))
        solo = read_counts()
    print(f"[bf16 train] launches over {ITERS} iterations: {solo}")
    check(solo == expected(policy_rollout=8 * ITERS, ppo_grads=40 * ITERS))
    check_finite(rows)
    print(f"[bf16 train] env-steps/s after the first iteration: "
          f"{[round(r['steps_per_s']) for r in rows[1:]]}")
    with tempfile.TemporaryDirectory() as out:
        argv = (POP_ARGV[:POP_ARGV.index("--total-steps")]
                + ["--total-steps", str(POP_B * 128), "--eval-episodes", "4",
                   "--reval-episodes", "0", "--fused-update-bf16",
                   "--iters-per-call", "1", "--out-dir", out,
                   "--run-name", "pop_bf16"])
        reset_counts()
        prow = train.run(train.parse_args(argv))
        pop = read_counts()
    print(f"[bf16 train] population launches over 1 iteration at P={POP}: "
          f"{pop}")
    check(pop == expected(policy_rollout=8, ppo_grads=40))
    check_finite(prow)
    from acas2d_tpu_torch.ppo import population
    cfg = train.build_config(train.parse_args(POP_ARGV
                                              + ["--fused-update-bf16"]))
    ms = breakdown(
        lambda mark: population.make_population_step(
            cfg, DEFAULT_PARAMS, "cuda", on_phase=mark),
        population.init_population(cfg, DEFAULT_PARAMS, POP, "cuda"))
    print(f"[bf16 train] population iteration phases (ms): {json.dumps(ms)}"
          f"; iteration {sum(ms.values()):.2f} ms")
    return solo, pop, ms


# ----------------------------------------------------------------- phase 10

# Operations of one env-step of the policy rollout, by unit, beyond the env
# rollout's with obs and random actions (env_rollout_ops, below): the two
# towers' layer-1 and layer-2 products, MLP_PRODUCT_FLOP, on the TF32
# tensor cores as 3xTF32 (three products each) or float32 on the CUDA
# cores, the faster route bounding; the 256 tanhf, each charged one
# special-function op (one MUFU.TANH is the least the card could do for
# one; the IEEE tanhf issues two MUFU ops and ~15 others); the biases and
# heads' 514 float32 ops; and the Gaussian sample's log, root, cosine and
# divide (special) and 11 float32 ops more than a random action's.
MLP_PRODUCT_FLOP = 2 * 2 * (HIDDEN * OBS_DIM + HIDDEN * HIDDEN)
POLICY_STEP_OPS = {"f32": 2 * (2 * HIDDEN + 2 * HIDDEN + 1) + 11,
                   "sfu": 2 * 2 * HIDDEN + 4}
# per row: forward 2 x 4,672 MAC; backward per tower 8,832 MAC
GRAD_FLOP = 2 * (2 * 4672 + 2 * 8832)


def time_rollout(args):
    """args: (the kernel's operands, the episode ends of their launch)."""
    args, episodes = args
    P, PB = args[5].shape[0], args[2].shape[1]
    ms = cuda_time_ms(lambda: policy_rollout._rollout_cuda(*args), 50)
    plain_ms = cuda_time_ms(lambda: policy_rollout._rollout_plain(*args), 5,
                            warmup=1)
    n_bytes = 4 * (8 * PB + PB + 8 * PB + P * N_PARAMS              # inputs
                   + 9 * PB + PB + 8 * PB + K * PB * 8 + 6 * K * PB
                   + 2 * K * PB)
    ops = env_rollout_ops(PB, K, episodes, False, True)
    for unit, n in POLICY_STEP_OPS.items():
        ops[unit] += n * K * PB
    products = K * PB * MLP_PRODUCT_FLOP
    cores = bound_ops(n_bytes, {**ops, "f32": ops["f32"] + products})
    tensor = bound_ops(n_bytes, {**ops, "tf32": 3 * products})
    print(f"[time] rollout bound at P={P} B={PB // P} K={K}: {cores[0]:.4f} "
          f"ms with the products float32 on the CUDA cores, {tensor[0]:.4f} "
          f"ms 3xTF32 on the tensor cores (special-function ops alone "
          f"{ops['sfu'] / PEAK_OPS_PER_S['sfu'] * 1e3:.4f} ms)")
    return ms, plain_ms, min(cores, tensor)


def time_grads(args):
    params, data = args[:2]
    P, n = data.shape[:2]
    ms = cuda_time_ms(lambda: ppo_grads._grads_cuda(*args), 20)
    plain_ms = cuda_time_ms(lambda: ppo_grads._grads_plain_members(*args), 5)
    n_bytes = 4 * (P * n * 13 + 2 * P * N_PARAMS + 4 * P)
    flop = P * n * GRAD_FLOP
    if len(args) > 4 and args[4]:
        # bf16 operands with float32 sums: what the tensor cores do at 989
        # TFLOP/s, so that is the least time of the same work
        return ms, plain_ms, bound_ops(n_bytes, {"bf16": flop})
    # float32 products: on the CUDA cores, or as 3xTF32 (three TF32
    # products each) on the tensor cores; the faster route bounds
    cores = bound_ops(n_bytes, {"f32": flop})
    tensor = bound_ops(n_bytes, {"tf32": 3 * flop})
    print(f"[time] gradient bound at P={P} N={n}: {cores[0]:.4f} ms float32 "
          f"on the CUDA cores, {tensor[0]:.4f} ms 3xTF32 on the tensor cores")
    return ms, plain_ms, min(cores, tensor)


# Operations the env rollout's semantics need (csrc/env_rollout.cu and
# step_math.cuh), by unit: "f32" one per float32 add, multiply, compare,
# select, min/max or floor; "sfu" one per sine, cosine, square root or
# division, the least a special-function unit could do for each; "int" one
# per 32-bit integer op of the hash and the counters.  A step: the heading
# pair, a_lat / v once, four square roots (three in the geometry, one in
# the reward), four sines, and the geometry's eight divides (one in each of
# its three arctans, the two arctan2 quotients, the arctan's operand, the
# closing speed's two); the 2pi wraps are selects.  With obs, the eight
# features and their sum every step, and the new state's heading pair and
# geometry only where an episode ended: an episode that goes on observes
# the state its reward measured.
ENV_STEP_OPS = {"f32": 221, "sfu": 19, "int": 9}      # every env-step
ENV_ACTION_OPS = {"f32": 3, "int": 14}                # random actions only
ENV_OBS_OPS = {"f32": 18}                             # with_obs, every step
ENV_RESPAWN_OPS = {"f32": 29, "sfu": 2, "int": 42}    # per episode end
ENV_OBS_RESPAWN_OPS = {"f32": 159, "sfu": 18}         # with_obs, per end


def env_rollout_ops(B, T, episodes, zero_actions, with_obs):
    steps = B * T
    ops = {u: n * steps for u, n in ENV_STEP_OPS.items()}
    for table, n in ((ENV_ACTION_OPS, 0 if zero_actions else steps),
                     (ENV_OBS_OPS, steps if with_obs else 0),
                     (ENV_RESPAWN_OPS, episodes),
                     (ENV_OBS_RESPAWN_OPS, episodes if with_obs else 0)):
        for u, k in table.items():
            ops[u] = ops.get(u, 0) + k * n
    return ops


def chain(st, with_obs, events=None):
    """CHAIN more launches continuing a bench measure's chain, through the
    public wrapper as the bench makes them, ending in the host transfer
    that ends a bench repeat.  With `events` (a pair of CUDA events for
    each launch) the card first sleeps ~0.1 s, so that the launches queue
    behind the sleep and run back to back, each between its events.
    Returns (the state left, the launches' episode counts, host ms per
    launch)."""
    episodes = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if events:
        torch.cuda._sleep(200_000_000)
    for i in range(CHAIN):
        if events:
            events[i][0].record()
        st, stats = env_rollout.fused_rollout(st, SEED, HEADLINE_T,
                                              with_obs=with_obs)
        if events:
            events[i][1].record()
        episodes.append(stats["episodes"])
    stats["obs_sum" if with_obs else "reward_sum"].cpu()
    return st, episodes, (time.perf_counter() - t0) / CHAIN * 1e3


def time_env_rollout(args):
    """args: (the state a bench measure's last launch left, with_obs), at
    the headline shape.  On that state, the kernel against its plain
    version (both on the card; the plain version's second run timed).
    Then, from where that leaves off, the kernel's time in a chain: the
    card is held by a sleep while CHAIN chained launches queue behind it,
    so that the CUDA events around each launch time the kernel alone; then
    CHAIN more launches as the bench makes them, on the host clock.  The
    difference is the card's idle share of the bench's wall time.  The
    bound counts the chain's episode ends (the respawns it runs).
    Returns (kernel ms, plain ms, bound, max abs err)."""
    st, with_obs = args
    B, T = st["px"].shape[0], HEADLINE_T
    ops_args = (sm.kernel_constants(DEFAULT_PARAMS), DEFAULT_PARAMS.max_steps,
                st, SEED, T, False, with_obs)
    got = env_rollout._env_rollout_cuda(*ops_args)
    want = env_rollout._env_rollout_plain(*ops_args)
    torch.cuda.synchronize()
    tag = "env rollout headline" + (" obs" if with_obs else "")
    err = compare_env(tag, {**got[0], **got[1]}, {**want[0], **want[1]}, T)
    del want
    ends = {k: int(got[1][k].sum()) for k in ("episodes", "goals",
                                               "collisions")}
    print(f"[{tag}] B={B} T={T}, from the bench's chained state: episode "
          f"ends {ends}")
    plain_ms = cuda_time_ms(lambda: env_rollout._env_rollout_plain(*ops_args),
                            1, warmup=0)
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(CHAIN)]
    st, episodes, _ = chain(got[0], with_obs, events)
    ms = sum(e0.elapsed_time(e1) for e0, e1 in events) / CHAIN
    _, _, wall_ms = chain(st, with_obs)
    print(f"[{tag}] chained launch: kernel {ms:.4f} ms (CUDA events, launches "
          f"queued), {wall_ms:.4f} ms on the host clock as the bench "
          f"launches; the card idles {1 - ms / wall_ms:.1%} of the bench's "
          f"wall time")
    n_bytes = 4 * B * (9 + 14)             # nine arrays in, fourteen out
    per_launch = sum(int(e.sum()) for e in episodes) / CHAIN
    ops = env_rollout_ops(B, T, per_launch, False, with_obs)
    loop = env_rollout.sass_census()[(False, with_obs)]["loop"]["all"]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_ms = loop * (B // 32) * T / (4 * sms * clock_mhz * 1e6) * 1e3
    print(f"[{tag}] {per_launch:.0f} episode ends a launch; upper bound of "
          f"the issue time, from the static count: the loop body's {loop} "
          f"instructions, every rare path included, each issued every "
          f"warp-step at the full rate (4 a clock on each of {sms} SMs at "
          f"{clock_mhz:.0f} MHz): {issue_ms:.4f} ms a launch, against "
          f"{ms:.4f} ms measured")
    return ms, plain_ms, bound_ops(n_bytes, ops), err


def time_probe(args):
    x, y = args
    ms = cuda_time_ms(lambda: precision_probe._probe_cuda(x, y), 100)
    plain_ms = cuda_time_ms(lambda: precision_probe._probe_plain(x, y), 100)
    matmul_ms = cuda_time_ms(lambda: torch.matmul(x, y), 100)
    print(f"[time] note: torch.matmul alone (o_def's product, TF32 off) "
          f"{matmul_ms:.4f} ms")
    flop = 2 * 128 ** 3
    return ms, plain_ms, bound_ops(4 * 5 * 128 * 128,
                                   {"f32": flop, "bf16": flop, "f64": flop})


def phase_timing(rows_in, runs):
    """rows_in: (name, timer, args, max_err, launches, source, replaces) per
    kernel row; runs: (iteration ms, phase ms) per training main path.  A
    timer returns (ms, plain ms, (bound ms, bound by)) and may add the
    largest error of a comparison it made, which the row's error takes in."""
    rows = []
    per_launch = {}
    for name, timer, args, err, launches, source, replaces in rows_in:
        ms, plain_ms, (b_ms, b_by), *more = timer(args)
        err = max([err] + more)
        per_launch[name] = ms
        print(f"[time] {name} {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}; {ms / b_ms:.1f}x the bound)")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    for path, roll_name, grad_name in (
            ("solo", "policy_rollout", "ppo_grads"),
            ("members", "policy_rollout_members", "ppo_grads_members"),
            ("bf16 members", "policy_rollout_members",
             "ppo_grads_bf16_members")):
        it_ms, phases = runs[path]
        print(f"[time] {path} main-path iteration {it_ms:.2f} ms; rollout "
              f"phase {phases['rollout']:.2f} ms holds "
              f"{8 * per_launch[roll_name]:.2f} ms of kernel time, update "
              f"phase {phases['update']:.2f} ms holds "
              f"{40 * per_launch[grad_name]:.2f} ms, GAE "
              f"{phases['gae']:.2f} ms holds none")
    for name in ("env_rollout", "env_rollout_obs"):
        rate = HEADLINE_B * HEADLINE_T / per_launch[name] * 1e3
        print(f"[time] {name}: {rate:.4e} env-steps/s in kernel time")
    return rows


def print_device_lines(kernels=None) -> None:
    """The card's name and power limit, the kernels' JSON line when given,
    and the last line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    phase_build()
    if argv[:1] == ["--cards"]:
        cards = int(argv[1]) if len(argv) > 1 else torch.cuda.device_count()
        check(2 <= cards <= torch.cuda.device_count(),
              f"--cards {cards} on {torch.cuda.device_count()} cards")
        phase_across_cards(cards)
        print_device_lines()
        return 0
    roll = {"solo": phase_rollout(dev, 1, SOLO_B),
            "members": phase_rollout(dev, POP, POP_B)}
    grads = {"solo": phase_grads(dev, 1, SOLO_N),
             "members": phase_grads(dev, POP, POP_N)}
    env_err = phase_env_rollout(dev)
    phase_env_engine(dev)
    bf16 = {"solo": phase_bf16_grads(dev, 1, SOLO_N),
            "members": phase_bf16_grads(dev, POP, POP_N)}
    probe_args, probe_err, probe_launches = phase_probe(bf16["solo"][2])
    solo_launches, solo_it_s = phase_main_path()
    solo_phases = phase_breakdown()
    pop_launches, pop_it_s = phase_population()
    pop_phases = phase_population_breakdown()
    bench_runs = phase_bench()
    bf16_launches = phase_bf16_training()
    eval_res = phase_eval()
    phase_greedy_graphs()
    phase_solo_run()
    phase_resume()
    phase_pipeline(dev)
    phase_replayed_loop()
    phase_trace()
    phase_unfused_main_paths()
    phase_replayed_loop(UNFUSED_CASES)
    phase_unfused_population()
    phase_reference()
    phase_float64()
    phase_multi_process()
    phase_host_surface()
    roll8, grads8, sub_launches = phase_last_modules(dev, eval_res)
    cu, pt = "acas2d_tpu_torch/csrc/", "acas2d_tpu/ops/"
    rows = [
        ("policy_rollout", time_rollout,
         (roll["solo"][0], roll["solo"][2]), roll["solo"][1],
         solo_launches["policy_rollout"], cu + "policy_rollout.cu",
         pt + "pallas_policy.py:67"),
        ("policy_rollout_members", time_rollout,
         (roll["members"][0], roll["members"][2]), roll["members"][1],
         pop_launches["policy_rollout"], cu + "policy_rollout.cu",
         pt + "pallas_policy.py:67"),
        ("ppo_grads", time_grads, grads["solo"][0], grads["solo"][1],
         solo_launches["ppo_grads"], cu + "ppo_grads.cu",
         pt + "pallas_update.py:60"),
        ("ppo_grads_members", time_grads, grads["members"][0],
         grads["members"][1], pop_launches["ppo_grads"], cu + "ppo_grads.cu",
         pt + "pallas_update.py:60"),
        ("policy_rollout_members_p8", time_rollout, (roll8[0], roll8[2]),
         roll8[1], sub_launches["policy_rollout"], cu + "policy_rollout.cu",
         pt + "pallas_policy.py:67"),
        ("ppo_grads_members_p8", time_grads, grads8[0], grads8[1],
         sub_launches["ppo_grads"], cu + "ppo_grads.cu",
         pt + "pallas_update.py:60"),
        ("ppo_grads_bf16", time_grads, bf16["solo"][0], bf16["solo"][1],
         bf16_launches[0]["ppo_grads"], cu + "ppo_grads.cu",
         pt + "pallas_update.py:60"),
        ("ppo_grads_bf16_members", time_grads, bf16["members"][0],
         bf16["members"][1], bf16_launches[1]["ppo_grads"],
         cu + "ppo_grads.cu", pt + "pallas_update.py:60"),
    ] + [
        (name, time_env_rollout, (st, with_obs), env_err, launches,
         cu + "env_rollout.cu", pt + "pallas_step.py:205")
        for name, (launches, st, with_obs) in bench_runs.items()
    ] + [
        ("precision_probe", time_probe, probe_args, probe_err,
         probe_launches, cu + "precision_probe.cu",
         "scripts/pallas_tpu_check.py:244"),
    ]
    bf16_phases = bf16_launches[2]
    kernels = phase_timing(
        rows, {"solo": (solo_it_s * 1e3, solo_phases),
               "members": (pop_it_s * 1e3, pop_phases),
               "bf16 members": (sum(bf16_phases.values()), bf16_phases)})
    print_device_lines(kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
