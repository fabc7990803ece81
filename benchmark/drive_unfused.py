"""The `unfused` driver: PPO iterations of the program's default training
path, both fused flags off, as `python -m acas2d_tpu_torch.train` runs it
with no flags: the step-by-step rollout (`learner.rollout_members`: the
policy, the Gaussian sample and the engine's `step_autoreset` as one-op
kernels) and the autograd update (`ppo_loss_grads`, then `Optimizer.update`
every minibatch step).

Set-up, the window and the check are `drive_train`'s (its `Program`,
`make_inputs` and `numbers`), with two differences:

  * the counts held exactly (`launch_gap`): the fused kernels' launch
    counters at 0, and the program's tallies of the unfused path
    (`utils.profiling.TALLY`: `rollout.env_steps`, n_steps an iteration,
    and `update.autograd_steps`, n_epochs x n_minibatches), which a replay
    adds for what its captured iteration holds.  A program without the
    tallies is held to the launch counters alone;
  * the reference is `reference/unfused.py`, the rollout on the engine's
    statement of the env with the unfused path's draws.

The traced slice is one one-iteration call of the window's graph (an
iteration replays ~1 M kernel nodes, each a record of the trace), after a
profiler warm-up step that holds a single small operation.  The record
keeps the Chrome trace's size and the time to write and read it
(`trace_file`).
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import drive_train, tracing
from .drive_train import FOLLOWED, Inputs, Program, _gap, make_inputs, numbers
from .reference import unfused as ref_unfused

TALLIES = ("rollout.env_steps", "update.autograd_steps")


def _tally() -> Optional[Dict[str, int]]:
    """The program's tallies of the unfused path, or None for a program
    that keeps none."""
    from acas2d_tpu_torch.utils import profiling
    t = getattr(profiling, "TALLY", None)
    return None if t is None else {k: int(t.get(k, 0)) for k in TALLIES}


class UnfusedProgram(Program):
    """`drive_train.Program` whose counts are the unfused path's."""

    def launches(self) -> Dict[str, int]:
        return {**super().launches(), **(_tally() or {})}

    def launches_due(self, iterations: int) -> Dict[str, int]:
        """None of the fused kernels' launches, and the tallies' env and
        minibatch steps of `iterations` iterations."""
        cfg = self.cfg
        due = {"policy_rollout": 0, "ppo_grads": 0}
        if _tally() is not None:
            due.update({"rollout.env_steps": iterations * cfg.n_steps,
                        "update.autograd_steps": iterations * cfg.n_epochs
                        * cfg.n_minibatches})
        return due


class TimedSlice(tracing.Slice):
    """`tracing.Slice` that keeps the size of its Chrome trace and the
    seconds that writing and reading it took."""

    file: Optional[Dict[str, float]] = None

    def stop(self, work: Dict[str, float]) -> tracing.Trace:
        self._sync()
        t1 = time.time_ns()
        try:
            c0 = time.perf_counter()
            self._prof.step()
            self._prof.stop()
            c1 = time.perf_counter()
            size = os.path.getsize(self._path)
            tr = tracing.read(self._path, self.spans, self._t0, t1, work)
            self.file = {"bytes": size, "write_s": c1 - c0,
                         "read_s": time.perf_counter() - c1,
                         "device_ops": len(tr.device)}
            return tr
        finally:
            shutil.rmtree(self._dir, ignore_errors=True)


def follow(conf: Dict, inputs: Inputs, tf32: bool = False,
           fault: Optional[str] = None) -> Dict:
    """`drive_train.follow` on `reference/unfused.py`: the reference's
    first FOLLOWED iterations from the inputs."""
    cfg = drive_train.ref_config(conf)
    tr = ref_unfused.start(inputs.params, inputs.u,
                           [torch.Generator().manual_seed(s)
                            for s in inputs.gen_seeds])
    out = {"loss": []}
    for i in range(FOLLOWED):
        out["loss"].append(ref_unfused.iteration(cfg, tr, tf32, fault)
                           ["loss"].double().cpu().numpy())
        if i == 0:
            out["mu1"] = tr.mu.clone()
            out["params1"] = tr.params.clone()
        out[f"pos{i + 1}"] = torch.stack([tr.env.px, tr.env.py])
    out["params"] = tr.params.clone()
    return out


def calibration(conf: Dict, inputs: Inputs, readings: Dict, want: Dict,
                device) -> Dict:
    """`drive_train.calibration` (the TF32 control, the planted faults and
    where the readings part) with this reference followed."""
    kept = drive_train.follow
    drive_train.follow = follow
    try:
        return drive_train.calibration(conf, inputs, readings, want, None,
                                       device)
    finally:
        drive_train.follow = kept


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float, controls: bool = False) -> Dict:
    """One run of an `unfused` cell; returns the record the metrics read."""
    conf, traffic = cell.config, cell.traffic
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    inputs = make_inputs(conf, seed, device)
    prog = UnfusedProgram(conf, seed, device, inputs)
    prog.capture()
    # the window's call, all replays, from a state of its own
    rows = prog.readback(prog.call())
    readings = {"loss": [r.reshape(-1) for r in rows["loss"][:FOLLOWED]],
                "loss_steps": []}
    # the same graph replayed one iteration a call, from the start
    prog.state = prog.initial_state()
    for i in range(FOLLOWED):
        rows = prog.readback(prog.call(1))
        readings["loss_steps"].append(rows["loss"].reshape(-1))
        if i == 0:
            readings["mu1"] = prog.snapshot(prog.state.opt_state.mu)
            readings["params1"] = prog.snapshot(prog.state.params)
        es = prog.state.env_state
        readings[f"pos{i + 1}"] = torch.stack(
            [es.px.reshape(-1), es.py.reshape(-1)]).clone()
    readings["params"] = prog.snapshot(prog.state.params)
    w0 = time.perf_counter()
    while True:
        prog.readback(prog.call())
        if time.perf_counter() - w0 >= traffic["warm_seconds"]:
            break
    sync()
    setup_s = time.perf_counter() - t0

    iters = failed = 0
    counted = prog.launches()
    w0 = time.perf_counter()
    while True:
        rows = prog.readback(prog.call())
        iters += prog.K
        failed += int((~np.isfinite(rows["loss"])).any(axis=-1).sum())
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    launch_gap = _gap(prog.launches(), counted, prog.launches_due(iters))
    cfg, calls = prog.cfg, iters // prog.K
    shape = {"members": 1, "n_envs": cfg.n_envs, "n_steps": cfg.n_steps,
             "n_epochs": cfg.n_epochs, "minibatch": cfg.minibatch_size,
             "chunk": cfg.fused_chunk}

    tr, trace_file = None, None
    if trace:
        sl = TimedSlice(cuda)
        sl.start()
        torch.zeros(1, device=device).add_(1.0)
        sl.begin()
        counted = prog.launches()
        n = episodes = 0
        while n < traffic["trace_calls"]:
            with sl.span("call"):
                metrics = prog.call(1)
            with sl.span("readback"):
                rows = prog.readback(metrics)
            n += 1
            episodes += float(rows["episodes"].sum())
        launch_gap = max(launch_gap, _gap(prog.launches(), counted,
                                          prog.launches_due(n)))
        tr = sl.stop({"iterations": n, "episodes": episodes, **shape,
                      "launches_rollout": 0, "launches_grads": 0})
        trace_file = sl.file
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    c0 = time.perf_counter()
    want = follow(conf, inputs)
    nums = numbers(conf, inputs, readings, want)
    nums["launch_gap"] = float(launch_gap)
    sync()
    check_s = time.perf_counter() - c0
    record = {"setup_s": setup_s, "window_s": window_s,
              "work": {"iterations": iters, "calls": calls,
                       "env_steps": iters * cfg.batch_size, "evals": 0,
                       **shape},
              "eval_s": [], "trace": tr, "trace_file": trace_file,
              "attempted": iters, "failed": failed,
              "memory_peak_bytes": int(peak), "numbers": nums,
              "check_s": check_s,
              "call_vs_steps": max(
                  float(np.max(np.abs(np.asarray(a, float)
                                      - np.asarray(b, float))))
                  for a, b in zip(readings["loss"], readings["loss_steps"]))}
    if trace_file is not None:
        print(f"[bench] traced slice: {trace_file}", file=sys.stderr)
    if controls:
        record.update(calibration(conf, inputs, readings, want, device))
    return record
