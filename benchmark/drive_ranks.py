"""The `ranks` driver: PPO iterations of the program's env-sharded solo
learner on W cards of one host, one process a card, as

    python -m torch.distributed.run --nproc-per-node W \\
        -m acas2d_tpu_torch.train --preset tpu --fused-rollout --fused-update

runs them: every rank joins the group (`parallel.mesh.multihost_init`,
NCCL on the card, gloo on the CPU), builds the whole initial state from
the seed and keeps its rows of the env batch (`learner.shard_state`), and
calls `learner.make_train_loop(..., mesh=mesh)`: K replays a call of the
captured iteration, whose graph holds the minibatch steps' all-reduces and
the batch's all-gather.

The harness's own process is rank 0 on card 0: the window, the traced
slice, the launch counters, the program's counters and the memory peak
are its own.  It builds the kernels, then starts ranks 1 to W - 1
(`python -m benchmark.drive_ranks`, with `parallel.launch`'s environment
on a free port), which run the same set-up and calls untraced, with one
torch thread and TF32 off.  After every call rank 0 tells the others
whether another follows, through a gloo group of the driver's own (not
through the program's collectives, so its counters count the program
alone).  A rank that fails ends the run within seconds: rank 0 kills every
rank and exits, as it does when no call has ended for STALL_S (a replayed
graph waits on the other ranks with no timeout); a rank whose parent is
gone exits; the join and every eager collective give up after TIMEOUT_S.

The set-up and the check are `drive_train`'s (its `Program`, `numbers` and
`make_inputs`): the readings of iterations 1-3 from a call of K and from
one-iteration calls, the envs' positions gathered from every rank
(`learner.gather_state`) outside the window, against the reference's
iteration of the same split (`reference/sharded.py`: each rank's envs
rolled out at its folded seed, the rest the whole batch's iteration).
The record's `work` counts every rank's env-steps; the traced slice's
`work` is rank 0's share (its envs and minibatch rows), so that the
kernels' rooflines and the mfu read one card's work over one card's time,
and holds `world`, which the collectives' readers need.
"""

from __future__ import annotations

import argparse
import datetime
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import tracing
from .drive_train import (FOLLOWED, Inputs, Program, _gap, make_inputs,
                          numbers, ref_config)
from .reference import ppo as ref
from .reference import sharded as ref_sharded

TIMEOUT_S = 30       # how long a rank waits on another (join, collective)
STALL_S = 120        # how long rank 0 may go without a call's word
POLL_S = 0.2
RANK_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT")


class RankProgram(Program):
    """`drive_train.Program` on this rank's mesh: its share of the state
    and the training loop that `train.py` builds under a launcher."""

    def __init__(self, conf: Dict, seed: int, device: torch.device,
                 inputs: Inputs, mesh):
        self.mesh = mesh
        super().__init__(conf, seed, device, inputs)
        ep, cfg = self.env_params, self.cfg
        if device.type == "cuda":
            self.loop = self.learner.make_train_loop(cfg, ep, self.K, device,
                                                     mesh=mesh)
        else:
            self.step = self.learner.make_train_step(cfg, ep, device,
                                                     mesh=mesh)

    def initial_state(self):
        return self.learner.shard_state(super().initial_state(), self.mesh)

    def positions(self) -> torch.Tensor:
        """(2, n_envs) positions of the whole batch, gathered from every
        rank."""
        es = self.learner.gather_state(self.state, self.mesh).env_state
        return torch.stack([es.px.reshape(-1), es.py.reshape(-1)]).clone()


class Lockstep:
    """Rank 0's word to the others after every call: whether another call
    follows.  Through a gloo group of the driver's own."""

    def __init__(self, on_go=None):
        self.on_go = on_go
        self.group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=TIMEOUT_S))

    def go(self, more: bool = False) -> bool:
        flag = torch.tensor([int(more)], dtype=torch.int32)
        dist.broadcast(flag, 0, group=self.group)
        if self.on_go is not None:
            self.on_go()
        return bool(flag[0])


def rank0_inputs(inputs: Inputs) -> Inputs:
    """`inputs` made from the seed, as rank 0 made them: the replicated
    params and the whole batch's spawns are sent from rank 0 (the ones the
    reference follows), so that no rank's arithmetic of the seed (a QR
    with other host threads) can part them."""
    for x in (inputs.params, inputs.u):
        dist.broadcast(x, 0)
    return inputs


def setup(conf: Dict, seed: int, device: torch.device, mesh):
    """Every rank alike: the inputs, the program, the capture, and the
    check's readings (which gather the positions from every rank)."""
    inputs = rank0_inputs(make_inputs(conf, seed, device))
    prog = RankProgram(conf, seed, device, inputs, mesh)
    prog.capture()
    rows = prog.readback(prog.call())
    readings = {"loss": [r.reshape(-1) for r in rows["loss"][:FOLLOWED]]}
    prog.state = prog.initial_state()
    readings["loss_steps"] = []
    for i in range(FOLLOWED):
        rows = prog.readback(prog.call(1))
        readings["loss_steps"].append(rows["loss"].reshape(-1))
        if i == 0:
            readings["mu1"] = prog.snapshot(prog.state.opt_state.mu)
            readings["params1"] = prog.snapshot(prog.state.params)
        readings[f"pos{i + 1}"] = prog.positions()
    readings["params"] = prog.snapshot(prog.state.params)
    return inputs, prog, readings


def follow(conf: Dict, inputs: Inputs, world: int, tf32: bool = False,
           fault: Optional[str] = None) -> Dict:
    """`drive_train.follow` for a batch split over `world` ranks: the
    reference's first FOLLOWED iterations (`reference/sharded.py`)."""
    cfg = ref_config(conf)
    tr = ref.start(inputs.params, inputs.u,
                   [torch.Generator().manual_seed(s)
                    for s in inputs.gen_seeds])
    out = {"loss": []}
    for i in range(FOLLOWED):
        out["loss"].append(ref_sharded.iteration(cfg, tr, world, tf32, fault)
                           ["loss"].double().cpu().numpy())
        if i == 0:
            out["mu1"] = tr.mu.clone()
            out["params1"] = tr.params.clone()
        out[f"pos{i + 1}"] = torch.stack([tr.env["px"], tr.env["py"]])
    out["params"] = tr.params.clone()
    return out


def leave() -> None:
    """Leave the process group, once the caller has dropped its program
    (whose graph holds the group's communicators)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------ ranks 1..W-1

def worker(argv=None) -> int:
    """Rank 1..W-1: the same set-up and calls as rank 0, untraced, until
    rank 0 says no call follows."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)      # the cell's, JSON
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    parent = os.getppid()

    def orphaned():
        while True:
            if os.getppid() != parent:
                os._exit(3)
            time.sleep(POLL_S)

    threading.Thread(target=orphaned, daemon=True).start()
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from acas2d_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.multihost_init(args.device, timeout_s=TIMEOUT_S)
    lock = Lockstep()
    _, prog, _ = setup(json.loads(args.config), args.seed, mesh.device,
                       mesh)
    while True:
        prog.readback(prog.call())
        if not lock.go():
            break
    del prog
    leave()
    return 0


# ------------------------------------------------------------------ rank 0

class Ranks:
    """Ranks 1..W-1 as child processes of this one, and a thread that
    ends the run when one of them fails or rank 0 hears no word of a call
    for STALL_S (`tick`)."""

    def __init__(self, cell, seed: int, world: int, device: torch.device):
        from acas2d_tpu_torch.parallel import launch
        self.port = launch.free_port()
        self.cuda = device.type == "cuda"
        self.saved = {k: os.environ.get(k) for k in RANK_ENV}
        os.environ.update({k: v for k, v in launch.rank_env(
            0, world, self.port).items() if k in RANK_ENV})
        self.dir = tempfile.mkdtemp(prefix="bench-ranks-")
        self.procs: List[subprocess.Popen] = []
        self.logs = []
        for r in range(1, world):
            log = open(os.path.join(self.dir, f"rank{r}.err"), "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.drive_ranks",
                 "--config", json.dumps(cell.config), "--seed", str(seed),
                 "--device", "cuda" if self.cuda else "cpu"],
                cwd=str(cell.root), env=launch.rank_env(r, world, self.port),
                stdout=subprocess.DEVNULL, stderr=log))
        self.done = threading.Event()
        self.failed: Optional[str] = None
        self.tick()
        threading.Thread(target=self._watch, daemon=True).start()

    def tick(self) -> None:
        self.last = time.monotonic()

    def _tail(self, r: int) -> str:
        log = self.logs[r - 1]
        log.flush()
        log.seek(0)
        return log.read()[-4000:]

    def _watch(self) -> None:
        """Until the last call: a rank that exits ends the run.  On the
        card rank 0 may be waiting on it inside a replayed graph, which no
        timeout ends, so this process exits too."""
        while not self.done.wait(POLL_S):
            gone = [(r, p.poll()) for r, p in enumerate(self.procs, 1)
                    if p.poll() not in (None, 0)]
            if gone:
                self.failed = "\n".join(
                    f"rank {r} exited {code} before the run ended:\n"
                    f"{self._tail(r)}" for r, code in gone)
            elif time.monotonic() - self.last > STALL_S:
                self.failed = f"no call ended in {STALL_S} s"
            else:
                continue
            print(self.failed, file=sys.stderr, flush=True)
            self.kill()
            if self.cuda:
                os._exit(5)
            return

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def finish(self, timeout_s: float = TIMEOUT_S) -> None:
        """After the last call: wait for the ranks to leave, at most
        `timeout_s`; kill what is left."""
        self.done.set()
        end = time.monotonic() + timeout_s
        while time.monotonic() < end and any(p.poll() is None
                                             for p in self.procs):
            time.sleep(POLL_S / 4)
        self.kill()

    def close(self) -> None:
        self.done.set()
        self.kill()
        for log in self.logs:
            log.close()
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for f in os.listdir(self.dir):
            os.remove(os.path.join(self.dir, f))
        os.rmdir(self.dir)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float, controls: bool = False) -> Dict:
    """One run of a `ranks` cell on `cell.chips` ranks, this process rank
    0; returns the record the metrics read."""
    W = int(cell.chips)
    if device.type == "cuda":
        if torch.cuda.device_count() < W:
            raise RuntimeError(f"{W} ranks need {W} cards, "
                               f"{torch.cuda.device_count()} found")
        from acas2d_tpu_torch.ops import _cuda
        _cuda.build()      # once, before the ranks load it
    from acas2d_tpu_torch.parallel import mesh as mesh_lib
    ranks = Ranks(cell, seed, W, device)
    try:
        mesh = mesh_lib.multihost_init(device, timeout_s=TIMEOUT_S)
        lock = Lockstep(ranks.tick)
        record = _rank0(cell, seed, seconds, trace, device, t0, mesh, lock)
        ranks.finish()
        if ranks.failed:
            raise RuntimeError(ranks.failed)
    except BaseException:
        ranks.kill()
        for r in range(1, W):
            print(f"rank {r}'s stderr:\n{ranks._tail(r)}", file=sys.stderr)
        raise
    finally:
        ranks.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    return _check(cell.config, record, W, device, controls)


def _rank0(cell, seed, seconds, trace, device, t0, mesh, lock) -> Dict:
    conf, traffic = cell.config, cell.traffic
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    inputs, prog, readings = setup(conf, seed, device, mesh)
    w0 = time.perf_counter()
    while True:
        prog.readback(prog.call())
        lock.go(True)
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
        last = time.perf_counter() - w0 >= seconds
        lock.go(not last or trace)
        if last:
            break
    window_s = time.perf_counter() - w0
    launch_gap = _gap(prog.launches(), counted, prog.launches_due(iters))
    calls = iters // prog.K
    cfg, W = prog.cfg, mesh.size
    shape = {"members": 1, "n_envs": cfg.n_envs, "n_steps": cfg.n_steps,
             "n_epochs": cfg.n_epochs, "minibatch": cfg.minibatch_size,
             "chunk": cfg.fused_chunk, "world": W}

    tr = None
    if trace:
        sl = tracing.Slice(cuda)
        sl.start()
        prog.readback(prog.call())
        lock.go(True)
        sl.begin()
        counted = prog.launches()
        n = episodes = 0
        s0 = time.perf_counter()
        more = True
        while more:
            with sl.span("call"):
                metrics = prog.call()
            with sl.span("readback"):
                rows = prog.readback(metrics)
                n += prog.K
                episodes += float(rows["episodes"].sum())
                more = n < traffic["trace_calls"] * prog.K or (
                    time.perf_counter() - s0 < traffic["trace_seconds"])
                lock.go(more)
        launch_gap = max(launch_gap, _gap(prog.launches(), counted,
                                          prog.launches_due(n)))
        # rank 0's share: its envs, its rows of every minibatch, and the
        # episodes that ended there, taken as the mean rank's
        tr = sl.stop({"iterations": n, "episodes": episodes / W,
                      **shape, "n_envs": cfg.n_envs // W,
                      "minibatch": cfg.minibatch_size // W,
                      "launches_rollout": n * cfg.n_steps // cfg.fused_chunk,
                      "launches_grads": n * cfg.n_epochs
                      * cfg.n_minibatches})
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del prog
    leave()
    return {"setup_s": setup_s, "window_s": window_s,
            "work": {"iterations": iters, "calls": calls,
                     "env_steps": iters * cfg.batch_size, "evals": 0,
                     **shape},
            "eval_s": [], "trace": tr, "attempted": iters,
            "failed": failed, "memory_peak_bytes": int(peak),
            "launch_gap": launch_gap, "inputs": inputs,
            "readings": readings}


def _check(conf: Dict, record: Dict, world: int, device: torch.device,
           controls: bool) -> Dict:
    """The record's numbers: the readings against the reference of the
    same split, followed on this card after the ranks have left."""
    inputs, readings = record.pop("inputs"), record.pop("readings")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    want = follow(conf, inputs, world)
    nums = numbers(conf, inputs, readings, want)
    nums["launch_gap"] = float(record.pop("launch_gap"))
    if device.type == "cuda":
        torch.cuda.synchronize()
    record.update(numbers=nums, check_s=time.perf_counter() - c0,
                  call_vs_steps=max(
                      float(np.max(np.abs(np.asarray(a, float)
                                          - np.asarray(b, float))))
                      for a, b in zip(readings["loss"],
                                      readings["loss_steps"])))
    if controls:
        record["controls"] = {
            "tf32": numbers(conf, inputs, follow(conf, inputs, world, True),
                            want),
            **{f: numbers(conf, inputs, follow(conf, inputs, world, False, f),
                          want) for f in ("half", "reward")}}
    return record


if __name__ == "__main__":
    sys.exit(worker())
