"""Chip smoke test of the PyTorch/CUDA port (acas2d_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. build the CUDA kernels from acas2d_tpu_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all at once;
  2. the rollout kernel against its plain PyTorch version, same seed,
     weights and state: the public wrapper on tensors on the card against
     the same call on copies on the CPU.  Solo (B = 2048 envs, K = 16) and
     member grid (P = 32 members x B = 1024 envs, K = 16, the population
     pipeline's launch);
  3. the PPO-gradient kernel against its plain version the same way, solo
     (N = 65,536 rows) and member-batched (P = 32 x N = 32,768), with the
     `tpu` preset's loss settings and again with ent_coef 0.01;
  4. the solo main path: `acas2d_tpu_torch.train` at the full `tpu` preset
     shape (2048 x 128, minibatch 65,536, 10 epochs) for 3 iterations, with
     the launch counters read around it (8 rollout and 40 gradient launches
     per iteration) and every metric finite; then one more iteration of the
     learner's step cut into rollout / GAE / update by its phase hook;
  5. the population main path: the shipped pipeline's command
     (scripts/population_pipeline.sh) for 3 iterations (--population 32
     --n-envs 1024 --minibatch-size 32768 --anneal-lr --fused-rollout
     --fused-update-packed --eval-episodes 32), with the re-eval cut from
     512 to 64 episodes and one polish round of one iteration at
     --polish-pop 16; the launch counters read around it (8 rollout and 40
     gradient launches per iteration, whatever P is), every metric finite,
     the selected policy through the port's exact eval (finite, no score
     gate); then one more population iteration cut into rollout / GAE /
     update;
  6. exact evaluation (float64 env) of artifacts/ppo_tpu_e_polished_best.npz,
     100 episodes, held to its committed record;
  7. kernel and plain-version times from CUDA events, each kernel's bound,
     the card's name and power limit.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
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
K = 16                           # rollout steps per launch (fused_chunk)
SOLO_B, SOLO_N = 2048, 65536     # solo main path: envs, minibatch rows
POP, POP_B, POP_N = 32, 1024, 32768   # population: members, envs, rows
ITERS = 3
POLISH_POP = 16
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
#  gradients: 32,768- or 65,536-row float32 sums in another order; error
#  relative to each parameter block's largest gradient.
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

def rollout_inputs(dev, P, B):
    """The kernel's operands for P members of B envs: each member its own
    weights (sigma ~0.6, so actions vary and clip), episodes part-way
    through, so that timeouts and respawns occur in K steps."""
    gen = torch.Generator().manual_seed(1)
    params = torch.stack([flatten(ActorCritic(generator=gen))
                          for _ in range(P)])
    params[:, -1] = -0.5
    es, obs = vector.reset_batch(P * B, DEFAULT_PARAMS, gen, torch.float32,
                                 "cpu")
    steps = torch.randint(1, DEFAULT_PARAMS.max_steps + 1, (P * B,),
                          generator=gen)
    st = torch.stack([es.px, es.py, es.ppsi, es.tx[:, 0], es.ty[:, 0],
                      es.tv[:, 0], es.tpsi[:, 0], es.total_reward])
    return (sm.kernel_constants(DEFAULT_PARAMS), DEFAULT_PARAMS.max_steps,
            st.to(dev).contiguous(), steps.to(dev, torch.int32),
            obs.to(dev).contiguous(), params.to(dev), 12345, 32, K)


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
    args = rollout_inputs(dev, P, B)
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
    return args, max_err


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
                  f"(worst of {P} member(s))")
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
    return (params, data, consts, cfg.ent_coef), max_err


# ------------------------------------------------------------------ phase 4

def reset_counts():
    policy_rollout.fused_policy_rollout_members.launches = 0
    ppo_grads.ppo_minibatch_grads_members.launches = 0


def read_counts():
    torch.cuda.synchronize()
    return {"policy_rollout":
            policy_rollout.fused_policy_rollout_members.launches,
            "ppo_grads": ppo_grads.ppo_minibatch_grads_members.launches}


def check_finite(rows):
    for row in rows:
        bad = [k for k, v in row.items()
               if not all(math.isfinite(x) for x in np.ravel(v))]
        check(not bad, f"non-finite metrics {bad}")


def phase_main_path():
    from acas2d_tpu_torch import train
    argv = ["--preset", "tpu", "--total-steps", str(ITERS * SOLO_B * 128)]
    reset_counts()
    rows = train.run(train.parse_args(argv))
    launches = read_counts()
    print(f"[main] launches over {ITERS} iterations: {launches}")
    check(launches == {"policy_rollout": 8 * ITERS, "ppo_grads": 40 * ITERS})
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
    cfg = train.build_config(train.parse_args(["--preset", "tpu"]))
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
        argv = POP_ARGV + ["--out-dir", out, "--run-name", "pop"]
        reset_counts()
        t0 = time.perf_counter()
        rows = train.run(train.parse_args(argv))
        wall = time.perf_counter() - t0
        launches = read_counts()
        iters = ITERS + 1                          # + the polish iteration
        print(f"[population] launches over {iters} iterations "
              f"({ITERS} at P={POP}, 1 at P={POLISH_POP}): {launches}")
        check(len(rows) == iters, f"{len(rows)} rows")
        check(launches == {"policy_rollout": 8 * iters,
                           "ppo_grads": 40 * iters})
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
             "--exact", "--episodes", "100"]))
        print(f"[population] exact eval of the selected policy: "
              f"{json.dumps(res)}")
        check(math.isfinite(res["mean_reward"]) and res["episodes"] == 100)
    it_s = [r["seconds"] for r in rows[1:ITERS]]
    return launches, float(np.mean(it_s))


def phase_population_breakdown():
    """One population iteration cut into its phases, and one greedy eval of
    the 32 members (32 episodes each, the pipeline's in-training eval),
    host clock around work that ends in a synchronise."""
    from acas2d_tpu_torch import train
    from acas2d_tpu_torch.ppo import population
    cfg = train.build_config(train.parse_args(POP_ARGV))
    state = population.init_population(cfg, DEFAULT_PARAMS, POP, "cuda")
    ms = breakdown(
        lambda mark: population.make_population_step(
            cfg, DEFAULT_PARAMS, "cuda", on_phase=mark), state)
    print(f"[breakdown] population iteration phases (ms): {json.dumps(ms)}")
    eval_fn = population.make_population_eval(cfg, DEFAULT_PARAMS,
                                              device="cuda")
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em = eval_fn(state.params, gen)
    torch.cuda.synchronize()
    print(f"[breakdown] one population eval ({POP} members x "
          f"{cfg.eval_episodes} episodes, mean length "
          f"{float(em['eval_length_mean'].mean()):.1f} steps): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return ms


# ------------------------------------------------------------------ phase 6

def phase_eval():
    from acas2d_tpu_torch import eval as eval_driver
    res = eval_driver.run(eval_driver.parse_args(
        ["--params-npz", FLAGSHIP, "--exact", "--episodes", "100"]))
    print(f"[eval] {json.dumps(res)}")
    rec = FLAGSHIP_RECORD
    check(res["goals"] == rec["goals"])
    check(abs(res["mean_reward"] - rec["mean_reward"]) < EVAL_TOL)
    check(abs(res["std_reward_ddof1"] - rec["std_reward"]) < EVAL_TOL)


# ------------------------------------------------------------------ phase 7

MLP_FLOP = 2 * 2 * (HIDDEN * OBS_DIM + HIDDEN * HIDDEN + HIDDEN)  # env-step
# per row: forward 2 x 4,672 MAC; backward per tower 8,832 MAC
GRAD_FLOP = 2 * (2 * 4672 + 2 * 8832)


def time_rollout(args):
    P, PB = args[5].shape[0], args[2].shape[1]
    ms = cuda_time_ms(lambda: policy_rollout._rollout_cuda(*args), 50)
    plain_ms = cuda_time_ms(lambda: policy_rollout._rollout_plain(*args), 5,
                            warmup=1)
    n_bytes = 4 * (8 * PB + PB + 8 * PB + P * N_PARAMS              # inputs
                   + 9 * PB + PB + 8 * PB + K * PB * 8 + 6 * K * PB
                   + 2 * K * PB)
    return ms, plain_ms, bound(n_bytes, K * PB * MLP_FLOP)


def time_grads(args):
    params, data = args[:2]
    P, n = data.shape[:2]
    ms = cuda_time_ms(lambda: ppo_grads._grads_cuda(*args), 20)
    plain_ms = cuda_time_ms(lambda: ppo_grads._grads_plain_members(*args), 5)
    n_bytes = 4 * (P * n * 13 + 2 * P * N_PARAMS + 4 * P)
    return ms, plain_ms, bound(n_bytes, P * n * GRAD_FLOP)


def phase_timing(roll, grads, launches, runs):
    """roll / grads: {"solo": (args, max_err), "members": ...}; launches
    and runs (iteration ms, phase ms) per main path."""
    rows = []
    spec = (("policy_rollout", "solo", roll, time_rollout,
             "acas2d_tpu_torch/csrc/policy_rollout.cu",
             "acas2d_tpu/ops/pallas_policy.py:67", "policy_rollout"),
            ("policy_rollout_members", "members", roll, time_rollout,
             "acas2d_tpu_torch/csrc/policy_rollout.cu",
             "acas2d_tpu/ops/pallas_policy.py:67", "policy_rollout"),
            ("ppo_grads", "solo", grads, time_grads,
             "acas2d_tpu_torch/csrc/ppo_grads.cu",
             "acas2d_tpu/ops/pallas_update.py:60", "ppo_grads"),
            ("ppo_grads_members", "members", grads, time_grads,
             "acas2d_tpu_torch/csrc/ppo_grads.cu",
             "acas2d_tpu/ops/pallas_update.py:60", "ppo_grads"))
    per_launch = {}
    for name, path, table, timer, source, replaces, counter in spec:
        args, err = table[path]
        ms, plain_ms, (b_ms, b_by) = timer(args)
        per_launch[name] = ms
        print(f"[time] {name} {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}; {ms / b_ms:.1f}x the bound)")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": launches[path][counter],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    for path, roll_name, grad_name in (
            ("solo", "policy_rollout", "ppo_grads"),
            ("members", "policy_rollout_members", "ppo_grads_members")):
        it_ms, phases = runs[path]
        print(f"[time] {path} main-path iteration {it_ms:.2f} ms; rollout "
              f"phase {phases['rollout']:.2f} ms holds "
              f"{8 * per_launch[roll_name]:.2f} ms of kernel time, update "
              f"phase {phases['update']:.2f} ms holds "
              f"{40 * per_launch[grad_name]:.2f} ms, GAE "
              f"{phases['gae']:.2f} ms holds none")
    return rows


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
    roll = {"solo": phase_rollout(dev, 1, SOLO_B),
            "members": phase_rollout(dev, POP, POP_B)}
    grads = {"solo": phase_grads(dev, 1, SOLO_N),
             "members": phase_grads(dev, POP, POP_N)}
    solo_launches, solo_it_s = phase_main_path()
    solo_phases = phase_breakdown()
    pop_launches, pop_it_s = phase_population()
    pop_phases = phase_population_breakdown()
    phase_eval()
    kernels = phase_timing(
        roll, grads, {"solo": solo_launches, "members": pop_launches},
        {"solo": (solo_it_s * 1e3, solo_phases),
         "members": (pop_it_s * 1e3, pop_phases)})
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
