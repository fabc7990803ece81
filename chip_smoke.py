"""Chip smoke test of the PyTorch/CUDA port (acas2d_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. build the CUDA kernels from acas2d_tpu_torch/csrc with nvcc (sm_90a);
  2. the rollout kernel against its plain PyTorch version, B = 2048 envs,
     K = 16 steps, same seed, weights and state: the public wrapper on
     tensors on the card against the same call on copies on the CPU;
  3. the PPO-gradient kernel against its plain version the same way,
     N = 65,536 rows, with the `tpu` preset's loss settings;
  4. the main path: `acas2d_tpu_torch.train` at the full `tpu` preset shape
     (2048 x 128, minibatch 65,536, 10 epochs) for 3 iterations, with the
     launch counters read around it (8 rollout and 40 gradient launches per
     iteration) and every metric finite;
  5. exact evaluation (float64 env) of artifacts/ppo_tpu_e_polished_best.npz,
     100 episodes, held to its committed record;
  6. kernel and plain-version times from CUDA events, each kernel's bound,
     the main-path iteration cut into rollout / GAE / update (the learner's
     train step with a phase hook that synchronises and reads the host
     clock), the card's name and power limit.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.envs import vector
from acas2d_tpu_torch.models.actor_critic import (ActorCritic, N_PARAMS,
                                                  OBS_DIM, HIDDEN, flatten,
                                                  gaussian_log_prob)
from acas2d_tpu_torch.ops import _cuda, policy_rollout, ppo_grads
from acas2d_tpu_torch.ops import step_math as sm
from acas2d_tpu_torch.ppo.config import tpu_default

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
B, K = 2048, 16                  # main-path rollout launch
N_MB = 65536                     # main-path minibatch
ITERS = 3
FLAGSHIP = "artifacts/ppo_tpu_e_polished_best.npz"
FLAGSHIP_RECORD = {"mean_reward": 1252.72, "std_reward": 72.04, "goals": 100}
# Tolerances, kernel on the card vs plain version on the CPU:
#  rollout: the kernel sums each 64-wide dot in its own order and contracts
#  multiply-adds (nvcc default), the plain version uses the CPU's BLAS and
#  libm; over 16 closed-loop steps float32 positions (~1e3 px) drift by a
#  few ulps.
ROLLOUT_RTOL, ROLLOUT_ATOL = 1e-4, 1e-3
#  gradients: 65,536-row float32 sums in another order; error relative to
#  each parameter block's largest gradient.
GRAD_REL_TOL = 1e-4
#  flagship eval: the float32 policy's matmuls sum in another order on the
#  card than on the CPU where the record was made; the record has 2 decimals.
EVAL_TOL = 0.05


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


def bound(n_bytes: float, n_flop: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flop / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 1

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


# ------------------------------------------------------------------ phase 2

def rollout_inputs(dev):
    gen = torch.Generator().manual_seed(1)
    params = flatten(ActorCritic(generator=gen)).to(dev)
    with torch.no_grad():
        params[-1] = -0.5                      # sigma ~0.6: varied actions
    es, obs = vector.reset_batch(B, DEFAULT_PARAMS, gen, torch.float32, dev)
    # episodes part-way through, so timeouts and respawns occur in K steps
    steps = torch.randint(1, DEFAULT_PARAMS.max_steps + 1, (B,), generator=gen)
    st = torch.stack([es.px, es.py, es.ppsi, es.tx[:, 0], es.ty[:, 0],
                      es.tv[:, 0], es.tpsi[:, 0], es.total_reward])
    return (sm.kernel_constants(DEFAULT_PARAMS), DEFAULT_PARAMS.max_steps,
            st.contiguous(), steps.to(dev, torch.int32), obs.contiguous(),
            params, 12345, 32, K)


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


def phase_rollout(dev):
    """The public wrapper on CUDA tensors (the kernel) against the same call
    on copies on the CPU (the plain version): this also checks the wrapper's
    state stacking, casts and the split of its outputs."""
    args = rollout_inputs(dev)
    _, _, st, steps, obs, params, seed, offset, k = args
    state = dict(zip(policy_rollout.STATE_KEYS, st.unbind(0)), steps=steps)
    got = policy_rollout.fused_policy_rollout(state, obs, params, seed,
                                              offset, k)
    want = policy_rollout.fused_policy_rollout(on_cpu(state), obs.cpu(),
                                               params.cpu(), seed, offset, k)
    torch.cuda.synchronize()
    max_err = 0.0
    for part, g, w in zip(("final", "buffers"), got, want):
        max_err = max(max_err, compare(f"rollout {part}", g, w,
                                       ROLLOUT_RTOL, ROLLOUT_ATOL))
    dones = int(want[1]["dones"].gt(0).sum())
    print(f"[rollout] B={B} K={K}: {dones} episode ends in the launch")
    check(dones > 0, "the comparison should exercise respawns")
    return args, max_err


# ------------------------------------------------------------------ phase 3

def grads_inputs(dev):
    """A main-path minibatch (N_MB rows, RAW advantages) whose ratios
    straddle the clip band, and the params, on `dev`."""
    gen = torch.Generator().manual_seed(2)
    model = ActorCritic(generator=gen)
    obs = torch.randn(N_MB, OBS_DIM, generator=gen) * 0.3
    with torch.no_grad():
        mean, log_std, value = model(obs)
        act = mean + torch.randn(N_MB, 1, generator=gen) * 0.7
        old_logp = (gaussian_log_prob(act, mean, log_std)
                    + torch.randn(N_MB, generator=gen) * 0.3)   # straddle the clip band
    adv = torch.randn(N_MB, generator=gen) * 3.0 + 0.5
    ret = torch.randn(N_MB, generator=gen)
    mb = torch.cat([obs, act, old_logp[:, None], value[:, None], adv[:, None],
                    ret[:, None]], 1)
    return flatten(model).to(dev), mb.to(dev).contiguous()


def phase_grads(dev):
    """The public wrapper on CUDA tensors (the kernel) against the same call
    on the CPU (the plain version), with the `tpu` preset's loss settings
    and once more with a non-zero ent_coef, whose sign enters the log-std
    gradient.  Returns the kernel's own operands at the main-path setting
    (advantages normalised as the wrapper does) for the timings."""
    cfg = tpu_default()
    params, mb = grads_inputs(dev)
    tower = (HIDDEN * OBS_DIM, HIDDEN, HIDDEN * HIDDEN, HIDDEN, HIDDEN, 1)
    sizes = list(tower) * 2 + [1]
    names = [f"{t}.{n}" for t in ("pi", "vf")
             for n in ("w1", "b1", "w2", "b2", "w_head", "b_head")] + ["log_std"]
    max_err = 0.0
    for ent_coef in (cfg.ent_coef, 0.01):
        kw = dict(clip_range=cfg.clip_range, vf_coef=cfg.vf_coef,
                  ent_coef=ent_coef,
                  normalize_advantage=cfg.normalize_advantage)
        g, aux = ppo_grads.ppo_minibatch_grads(params, mb, **kw)
        w, waux = ppo_grads.ppo_minibatch_grads(params.cpu(), mb.cpu(), **kw)
        torch.cuda.synchronize()
        g = g.cpu()
        max_err = max(max_err, float((g - w).abs().max()))
        for name, gb, wb in zip(names, g.split(sizes), w.split(sizes)):
            rel = float((gb - wb).abs().max() / (wb.abs().max() + 1e-12))
            print(f"[grads] ent_coef {ent_coef}: {name} rel err {rel:.3e}")
            check(rel < GRAD_REL_TOL, f"gradient {name} rel err {rel}")
        for key in sorted(waux):
            a, b = float(aux[key]), float(waux[key])
            rel = abs(a - b) / (abs(b) + 1e-6)
            print(f"[grads] ent_coef {ent_coef}: {key} {a:.6g} vs {b:.6g} "
                  f"(rel err {rel:.3e})")
            check(rel < GRAD_REL_TOL, f"aux {key} differs")
    clip_frac = float(waux["clip_fraction"])
    print(f"[grads] N={N_MB}: clip fraction {clip_frac:.3f}")
    check(0.05 < clip_frac < 0.95, "both clip regimes should be exercised")
    data = ppo_grads.normalize_adv_column(mb).contiguous()
    consts = ppo_grads._constants(N_MB, cfg.clip_range, cfg.vf_coef)
    return (params, data, consts, cfg.ent_coef), max_err


# ------------------------------------------------------------------ phase 4

def phase_main_path():
    from acas2d_tpu_torch import train
    argv = ["--preset", "tpu", "--total-steps", str(ITERS * 2048 * 128)]
    policy_rollout.fused_policy_rollout.launches = 0
    ppo_grads.ppo_minibatch_grads.launches = 0
    rows = train.run(train.parse_args(argv))
    torch.cuda.synchronize()
    launches = {"policy_rollout": policy_rollout.fused_policy_rollout.launches,
                "ppo_grads": ppo_grads.ppo_minibatch_grads.launches}
    print(f"[main] launches over {ITERS} iterations: {launches}")
    check(launches == {"policy_rollout": 8 * ITERS, "ppo_grads": 40 * ITERS})
    for row in rows:
        bad = [k for k, v in row.items() if not math.isfinite(v)]
        check(not bad, f"non-finite metrics {bad}")
    steady = [r["steps_per_s"] for r in rows[1:]]
    it_s = [r["seconds"] for r in rows[1:]]
    print(f"[main] env-steps/s after the first iteration: {steady} "
          f"(iteration seconds {it_s}; first {rows[0]['seconds']:.3f} s)")
    return launches, float(np.mean(it_s))


def phase_breakdown():
    """One more main-path iteration cut at its three phases: the learner's
    own train step, with a hook that synchronises and reads the host clock
    as each phase ends (after a warm-up iteration).  Phases: the fused
    rollout (8 launches), GAE, and the update (40 gradient launches +
    Adam)."""
    from acas2d_tpu_torch import train
    from acas2d_tpu_torch.ppo import learner
    cfg = train.build_config(train.parse_args(["--preset", "tpu"]))
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    train_step = learner.make_train_step(cfg, DEFAULT_PARAMS, "cuda",
                                         on_phase=mark)
    state = learner.init_train_state(cfg, DEFAULT_PARAMS, "cuda")
    for _ in range(2):                 # the second pass is the one reported
        marks.clear()
        mark("start")
        state, _ = train_step(state)
    ms = {name: (t - t_prev) * 1e3
          for (_, t_prev), (name, t) in zip(marks, marks[1:])}
    print(f"[breakdown] iteration phases (ms): {json.dumps(ms)}")
    return ms


# ------------------------------------------------------------------ phase 5

def phase_eval():
    from acas2d_tpu_torch import eval as eval_driver
    res = eval_driver.run(eval_driver.parse_args(
        ["--params-npz", FLAGSHIP, "--exact", "--episodes", "100"]))
    print(f"[eval] {json.dumps(res)}")
    rec = FLAGSHIP_RECORD
    check(res["goals"] == rec["goals"])
    check(abs(res["mean_reward"] - rec["mean_reward"]) < EVAL_TOL)
    check(abs(res["std_reward_ddof1"] - rec["std_reward"]) < EVAL_TOL)


# ------------------------------------------------------------------ phase 6

def phase_timing(roll_args, grad_args, launches, roll_err, grad_err, it_s,
                 phases):
    rollout_ms = cuda_time_ms(lambda: policy_rollout._rollout_cuda(*roll_args), 50)
    rollout_plain_ms = cuda_time_ms(
        lambda: policy_rollout._rollout_plain(*roll_args), 5, warmup=1)
    grads_ms = cuda_time_ms(lambda: ppo_grads._grads_cuda(*grad_args), 50)
    grads_plain_ms = cuda_time_ms(lambda: ppo_grads._grads_plain(*grad_args), 20)

    mlp_flop = 2 * 2 * (HIDDEN * OBS_DIM + HIDDEN * HIDDEN + HIDDEN)   # per env-step
    r_bytes = 4 * (8 * B + B + 8 * B + N_PARAMS                        # inputs
                   + 9 * B + B + 8 * B + K * B * 8 + 6 * K * B + 2 * K * B)
    r_bound, r_by = bound(r_bytes, K * B * mlp_flop)
    # per row: forward 2 x 4,672 MAC; backward per tower 8,832 MAC
    g_flop = N_MB * 2 * (2 * 4672 + 2 * 8832)
    g_bytes = 4 * (N_MB * 13 + N_PARAMS + N_PARAMS + 4)
    g_bound, g_by = bound(g_bytes, g_flop)
    print(f"[time] policy_rollout {rollout_ms:.4f} ms (plain {rollout_plain_ms:.3f}"
          f" ms, bound {r_bound:.4f} ms by {r_by})")
    print(f"[time] ppo_grads {grads_ms:.4f} ms (plain {grads_plain_ms:.4f} ms,"
          f" bound {g_bound:.4f} ms by {g_by})")
    print(f"[time] main-path iteration {it_s * 1e3:.2f} ms; rollout phase "
          f"{phases['rollout']:.2f} ms holds {8 * rollout_ms:.2f} ms of kernel"
          f" time, update phase {phases['update']:.2f} ms holds "
          f"{40 * grads_ms:.2f} ms, GAE {phases['gae']:.2f} ms holds none")
    return [
        {"name": "policy_rollout", "route": "cuda",
         "source": "acas2d_tpu_torch/csrc/policy_rollout.cu",
         "replaces": "acas2d_tpu/ops/pallas_policy.py:67",
         "launches": launches["policy_rollout"], "max_abs_err": roll_err,
         "ms": rollout_ms, "plain_ms": rollout_plain_ms, "bound_ms": r_bound,
         "bound_by": r_by, "library_ms": None},
        {"name": "ppo_grads", "route": "cuda",
         "source": "acas2d_tpu_torch/csrc/ppo_grads.cu",
         "replaces": "acas2d_tpu/ops/pallas_update.py:60",
         "launches": launches["ppo_grads"], "max_abs_err": grad_err,
         "ms": grads_ms, "plain_ms": grads_plain_ms, "bound_ms": g_bound,
         "bound_by": g_by, "library_ms": None},
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    phase_build()
    roll_args, roll_err = phase_rollout(dev)
    grad_args, grad_err = phase_grads(dev)
    launches, it_s = phase_main_path()
    phases = phase_breakdown()
    phase_eval()
    kernels = phase_timing(roll_args, grad_args, launches, roll_err,
                           grad_err, it_s, phases)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
