"""The `train` driver: PPO iterations of the program's training loop, as
`python -m acas2d_tpu_torch.train` runs them, and with `evals` the
greedy eval after every call, as its population driver fires it.

Set-up makes the inputs from the seed (the members' initial params on the
device, SB3's initialisation; the envs' spawn uniforms; one host generator
a member, which gives the rollout seeds and the epoch permutations) and
builds one training loop object (`population.make_population_loop` or
`learner.make_train_loop`, K iterations a call as replays of a captured
iteration).  Every state it runs is built anew from the inputs, host
generators included, so each starts where the reference does.  Its first
call, on such a state, captures the iteration's graph (that call's first
iteration runs eagerly) and is set aside.  Then, from a new initial state,
one call of K iterations as the window makes it, all replays, gives the
losses of iterations 1-3; and from another, three calls of one iteration,
replays of the same graph, give the state after the first and the third,
which a call of K does not hand out.  The reference follows those three
iterations after the window.  With `evals`, one eval then warms the eval's
graphs.  Calls of K iterations (each with its eval, where the mix has
evals) then run until `warm_seconds` have passed, so that the window
starts on a warm card.

The window makes calls of K iterations; each call's metrics come back to
the host in one read-back, as the driver's rows do, and with `evals` the
eval follows on its own generator (`(seed + 1, global step)`), then the
population tracker's update with the params on the host, into a run dir
under TMPDIR.  The window ends with the first call (and its eval) that
ends after `seconds`.  On the card the program's launch counters
(`learner.KERNELS`) are read around the window and around the traced
slice, and held to what their iterations hold: `n_steps / fused_chunk`
rollout and `n_epochs x n_minibatches` gradient launches an iteration
(`launch_gap`, exact).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import checks, tracing
from .reference import ppo as ref
from .reference import rollouts as ref_roll

PPO_KEYS = ("n_envs", "n_steps", "total_timesteps", "minibatch_size",
            "n_epochs", "gamma", "gae_lambda", "clip_range", "ent_coef",
            "vf_coef", "max_grad_norm", "learning_rate", "adam_eps",
            "anneal_lr", "fused_rollout", "fused_chunk", "fused_update",
            "fused_update_packed", "fused_update_bf16", "eval_every_steps",
            "eval_episodes")
FOLLOWED = 3          # iterations the reference follows


@dataclasses.dataclass
class Inputs:
    params: torch.Tensor       # (P, N_PARAMS) on the device
    u: torch.Tensor            # (P * B, 5) spawn uniforms, float64
    gen_seeds: List[int]       # one a member


def members(conf: Dict) -> int:
    return max(1, int(conf["population"]))


def make_inputs(conf: Dict, seed: int, device) -> Inputs:
    s = np.random.SeedSequence(int(seed)).generate_state(
        members(conf) + 1, np.uint64)
    gen = torch.Generator(device=device).manual_seed(int(s[0]))
    P, B = members(conf), int(conf["n_envs"])
    params = ref.init_params(P, gen, device)
    u = torch.rand(P * B, 5, generator=gen, device=device,
                   dtype=torch.float64)
    return Inputs(params, u, [int(x) for x in s[1:]])


def eval_generator(seed: int, gstep: int) -> torch.Generator:
    """The eval's spawn generator at `gstep`: keyed by (seed + 1, gstep)."""
    key = np.random.SeedSequence([int(seed) + 1, int(gstep)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(key))


class Program:
    """The port's state and training loop object for one cell."""

    def __init__(self, conf: Dict, seed: int, device: torch.device,
                 inputs: Inputs):
        from acas2d_tpu_torch.config import DEFAULT_PARAMS
        from acas2d_tpu_torch.ppo import learner, population
        from acas2d_tpu_torch.ppo.config import PPOConfig
        self.learner, self.population = learner, population
        self.env_params = ep = DEFAULT_PARAMS
        self.device, self.P = device, members(conf)
        self.pop = int(conf["population"]) > 0
        self.cfg = cfg = PPOConfig(**{k: conf[k] for k in PPO_KEYS},
                                   seed=int(seed))
        self.K = int(conf["iters_per_call"])
        self.inputs, self.opt = inputs, learner.Optimizer(cfg)
        self.state = self.initial_state()
        if device.type == "cuda":
            self.loop = (population.make_population_loop(
                cfg, ep, self.K, device, torch.float32, None, self.P)
                if self.pop else learner.make_train_loop(cfg, ep, self.K,
                                                         device))
        else:
            # the plain versions: K eager steps a call, as on the CPU the
            # program's loop is
            self.loop = None
            self.step = (population.make_population_step(
                cfg, ep, device, pop=self.P) if self.pop
                else learner.make_train_step(cfg, ep, device))
        self.eval_fn = self.tracker = self.ckpt = None

    def initial_state(self):
        """The program's state at iteration 0, built anew from the inputs:
        the engine's spawn and first observation, fresh Adam moments, a
        fresh host generator a member."""
        from acas2d_tpu_torch.envs import core
        from acas2d_tpu_torch.types import EnvState
        ep, cfg, inputs = self.env_params, self.cfg, self.inputs
        es, obs = core.observe(core.spawn_from_uniforms(
            inputs.u, ep, torch.float32), ep)
        gens = [torch.Generator().manual_seed(s) for s in inputs.gen_seeds]
        if self.pop:
            P, B = self.P, cfg.n_envs
            es = EnvState(**{f.name: getattr(es, f.name).reshape(
                (P, B) + getattr(es, f.name).shape[1:]).contiguous()
                for f in dataclasses.fields(EnvState)})
            params = inputs.params.clone()
            return self.population.PopulationState(
                params=params, opt_state=self.opt.init(params), env_state=es,
                obs=obs.reshape(P, B, -1).contiguous(), generators=gens)
        params = inputs.params[0].clone()
        return self.learner.TrainState(
            params=params, opt_state=self.opt.init(params), env_state=es,
            obs=obs, generator=gens[0])

    def capture(self) -> None:
        """The loop's first call, which captures the iteration's graph, on
        a state of its own; its result is set aside."""
        if self.loop is not None:
            self.loop(self.initial_state())

    def call(self, k: Optional[int] = None):
        """One call of the loop object on the current state: K iterations,
        as the window makes it, or `k` (set-up's one-iteration calls);
        returns the metrics on the device."""
        k = self.K if k is None else k
        if self.loop is None:
            self.state, metrics = self.learner.stacked_loop(self.step, k)(
                self.state)
            return metrics
        if k == self.K:
            self.state, metrics = self.loop(self.state)
            return metrics
        K0 = self.loop.iters_per_call
        self.loop.iters_per_call = k
        try:
            self.state, metrics = self.loop(self.state)
        finally:
            self.loop.iters_per_call = K0
        return metrics

    def launches(self) -> Dict[str, int]:
        """The program's launch counters of the training kernels."""
        return {k: int(f.launches) for k, f in self.learner.KERNELS.items()}

    def launches_due(self, iterations: int) -> Dict[str, int]:
        """The launches `iterations` iterations hold on the card; the
        plain versions on the CPU launch none."""
        cfg, on = self.cfg, self.loop is not None
        return {"policy_rollout": on * iterations * cfg.n_steps
                // cfg.fused_chunk,
                "ppo_grads": on * iterations * cfg.n_epochs
                * cfg.n_minibatches}

    @staticmethod
    def readback(metrics) -> Dict[str, np.ndarray]:
        """The call's metrics on the host, in one transfer: (k,) or (k, P)
        each."""
        keys = list(metrics)
        vals = torch.stack([metrics[k].to(torch.float64)
                            for k in keys]).cpu().numpy()
        return dict(zip(keys, vals))

    def gstep(self) -> int:
        return self.state.iteration * self.cfg.batch_size

    def start_evals(self, run_dir: str) -> None:
        ep, cfg = self.env_params, self.cfg
        if self.pop:
            self.eval_fn = self.population.make_population_eval(
                cfg, ep, torch.float32, device=self.device)
            self.tracker = self.population.PopulationTracker(
                run_dir, self.P, cfg.seed)
        else:
            from acas2d_tpu_torch.utils.checkpoint import CheckpointManager
            self.eval_fn = self.learner.make_eval_fn(cfg, ep, torch.float32,
                                                     device=self.device)
            self.ckpt = CheckpointManager(os.path.join(run_dir,
                                                       "checkpoints"))

    def evaluate(self, spans=tracing.NO_SPANS) -> Dict:
        """The driver's eval at this step and its bookkeeping; returns what
        the check needs: the step, the params on the host and the eval's
        per-member metrics."""
        gstep = self.gstep()
        params = self.state.params
        with spans.span("eval"):
            em = {k: v.to(torch.float64).cpu().numpy().reshape(-1)
                  for k, v in self.eval_fn(
                      params, eval_generator(self.cfg.seed, gstep)).items()}
        with spans.span("tracker"):
            host = params.detach().cpu().numpy().reshape(self.P, -1)
            if self.pop:
                self.tracker.update(gstep, em["eval_return_mean"], host)
            else:
                flat = {k: float(v[0]) for k, v in em.items()}
                if self.ckpt.is_better(flat):
                    self.ckpt.update_best(
                        gstep, self.learner.state_to_dict(self.state), flat)
        return {"gstep": gstep, "params": host, "metrics": em}

    def snapshot(self, x: torch.Tensor) -> torch.Tensor:
        return x.detach().clone().reshape(self.P, -1)


def ref_config(conf: Dict) -> ref.Config:
    return ref.Config(
        n_envs=conf["n_envs"], n_steps=conf["n_steps"],
        minibatch=conf["minibatch_size"], n_epochs=conf["n_epochs"],
        gamma=conf["gamma"], gae_lambda=conf["gae_lambda"],
        clip=conf["clip_range"], ent_coef=conf["ent_coef"],
        vf_coef=conf["vf_coef"], max_grad_norm=conf["max_grad_norm"],
        lr=conf["learning_rate"], adam_eps=conf["adam_eps"],
        anneal_lr=conf["anneal_lr"],
        total_timesteps=conf["total_timesteps"], chunk=conf["fused_chunk"])


def follow(conf: Dict, inputs: Inputs, tf32: bool = False,
           fault: Optional[str] = None) -> Dict:
    """The reference's first FOLLOWED iterations from the inputs: each
    iteration's loss (P,), Adam's first moment after the first, the
    params after the last."""
    cfg = ref_config(conf)
    tr = ref.start(inputs.params, inputs.u,
                   [torch.Generator().manual_seed(s)
                    for s in inputs.gen_seeds])
    out = {"loss": []}
    for i in range(FOLLOWED):
        out["loss"].append(ref.iteration(cfg, tr, tf32, fault)["loss"]
                           .double().cpu().numpy())
        if i == 0:
            out["mu1"] = tr.mu.clone()
            out["params1"] = tr.params.clone()
        out[f"pos{i + 1}"] = torch.stack([tr.env["px"], tr.env["py"]])
    out["params"] = tr.params.clone()
    return out


def _gap(now: Dict[str, int], before: Dict[str, int],
         due: Dict[str, int]) -> int:
    """The launches counted since `before` that part from those `due`,
    summed over the kernels."""
    return sum(abs(now[k] - before[k] - due[k]) for k in due)


def numbers(conf: Dict, inputs: Inputs, prog: Dict, want: Dict
            ) -> Dict[str, float]:
    """The training numbers of `prog` (the program's readings, or another
    reference's) against the reference's `want`.  An iteration's loss is
    read from the call of K and from the one-iteration calls, and the
    wider gap of the two counts."""
    out = {f"loss_gap.{i + 1}": max(
        checks.loss_gap(prog[key][i], want["loss"][i])
        for key in ("loss", "loss_steps") if i < len(prog.get(key, ())))
        for i in range(FOLLOWED)}
    p0 = inputs.params
    p0 = p0.to(prog["params"].device)
    pairs = {"grad_gap": (prog["mu1"], want["mu1"]),
             "update_gap.1": (prog["params1"] - p0, want["params1"] - p0),
             "update_gap": (prog["params"] - p0, want["params"] - p0)}
    for name, (a, b) in pairs.items():
        out[name] = checks.leaf_gap(a, b, want["mu1"])
        out[name + ".median"] = checks.median_leaf_gap(a, b, want["mu1"])
    out["state_gap.1"] = checks.state_gap(prog["pos1"], want["pos1"])
    return out


def judge_evals(evals: List[Dict], episodes: int, device,
                tf32: bool = False) -> float:
    """The largest eval gap of the program's evals `evals` against the
    reference's on the same params and spawns."""
    worst = 0.0
    for e in evals:
        with ref.precision(tf32):
            want = ref_roll.greedy_eval(
                torch.as_tensor(e["params"], device=device),
                eval_generator(e["seed"], e["gstep"]), episodes, device)
        worst = max(worst, checks.eval_gap(e["metrics"], want))
    return worst


def calibration(conf: Dict, inputs: Inputs, readings: Dict, want: Dict,
                judged: Optional[List[Dict]], device) -> Dict:
    """What `benchmark/calibrate.py` reads besides the numbers: the
    control's and the planted faults' numbers against the reference
    (`controls`), and where the program's readings come from (`detail`:
    each leaf's gap, the envs whose positions part by over 1 px after each
    iteration, by member, and the members whose losses part most)."""
    tf = follow(conf, inputs, True)
    controls = {
        "tf32": numbers(conf, inputs, tf, want),
        "half": numbers(conf, inputs, follow(conf, inputs, False, "half"),
                        want),
        "reward": numbers(conf, inputs,
                          follow(conf, inputs, False, "reward"), want)}
    if judged is not None:
        controls["tf32"]["eval_gap"] = judge_evals(
            judged, conf["eval_episodes"], device, tf32=True)
    p0 = inputs.params
    P = p0.shape[0]
    detail = {"leaf_gaps": {}}
    for tag, got in (("program", readings), ("tf32", tf)):
        for name, a, b in (("grad", got["mu1"], want["mu1"]),
                           ("update", got["params"] - p0,
                            want["params"] - p0)):
            g = checks.leaf_gaps(a, b, want["mu1"]).max(0).values
            detail["leaf_gaps"][f"{tag}.{name}"] = dict(zip(ref.LEAVES,
                                                            g.tolist()))
    for i in range(1, FOLLOWED + 1):
        apart = ((readings[f"pos{i}"] - want[f"pos{i}"]).abs().sum(0)
                 > 1.0).view(P, -1).sum(1).tolist()
        detail[f"diverged_members.{i}"] = {m: c for m, c in enumerate(apart)
                                           if c}
        got, exp = (np.asarray(x["loss"][i - 1], float)
                    for x in (readings, want))
        g = np.abs(got - exp) / np.abs(exp)
        detail[f"loss_gap_members.{i}"] = [[int(m), float(g[m])]
                                           for m in np.argsort(g)[::-1][:3]]
    return {"controls": controls, "detail": detail}


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float, controls: bool = False) -> Dict:
    """One run of a `train` cell; returns the record the metrics read."""
    conf, traffic = cell.config, cell.traffic
    evals_on = bool(traffic.get("evals", False))
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    run_dir = tempfile.mkdtemp(prefix="bench-run-")
    try:
        inputs = make_inputs(conf, seed, device)
        prog = Program(conf, seed, device, inputs)
        prog.capture()
        # the window's call, all replays, from a state of its own
        rows = prog.readback(prog.call())
        readings = {"loss": [r.reshape(-1)
                             for r in rows["loss"][:FOLLOWED]]}
        # the same graph replayed one iteration a call, from the start
        prog.state = prog.initial_state()
        readings["loss_steps"] = []
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
        evals: List[Dict] = []
        if evals_on:
            prog.start_evals(run_dir)
            evals.append(prog.evaluate())
        w0 = time.perf_counter()
        while True:
            prog.readback(prog.call())
            if evals_on:
                prog.evaluate()
            if time.perf_counter() - w0 >= traffic["warm_seconds"]:
                break
        sync()
        setup_s = time.perf_counter() - t0

        iters = failed = 0
        window_evals, eval_s = [], []
        counted = prog.launches()
        w0 = time.perf_counter()
        while True:
            rows = prog.readback(prog.call())
            iters += prog.K
            failed += int((~np.isfinite(rows["loss"])).any(axis=-1).sum())
            if evals_on:
                e0 = time.perf_counter()
                window_evals.append(prog.evaluate())
                eval_s.append(time.perf_counter() - e0)
            if time.perf_counter() - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
        launch_gap = _gap(prog.launches(), counted, prog.launches_due(iters))
        calls = iters // prog.K
        P, batch = prog.P, prog.cfg.batch_size
        shape = {"members": P, "n_envs": prog.cfg.n_envs,
                 "n_steps": prog.cfg.n_steps, "n_epochs": prog.cfg.n_epochs,
                 "minibatch": prog.cfg.minibatch_size,
                 "chunk": prog.cfg.fused_chunk}

        tr = None
        if trace:
            sl = tracing.Slice(cuda)
            sl.start()
            prog.readback(prog.call())
            if evals_on:
                prog.evaluate()
            sl.begin()
            counted = prog.launches()
            n = episodes = 0
            s0 = time.perf_counter()
            while n < traffic["trace_calls"] * prog.K or (
                    time.perf_counter() - s0 < traffic["trace_seconds"]):
                with sl.span("call"):
                    metrics = prog.call()
                with sl.span("readback"):
                    rows = prog.readback(metrics)
                n += prog.K
                episodes += float(rows["episodes"].sum())
                if evals_on:
                    prog.evaluate(sl)
            launch_gap = max(launch_gap, _gap(prog.launches(), counted,
                                              prog.launches_due(n)))
            tr = sl.stop({"iterations": n, "episodes": episodes,
                          **shape,
                          "launches_rollout": n * prog.cfg.n_steps
                          // prog.cfg.fused_chunk,
                          "launches_grads": n * prog.cfg.n_epochs
                          * prog.cfg.n_minibatches})
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0

        # the sampled window evals, the warm one and two drawn from the seed
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), 17]))
        picks = sorted(set(rng.choice(len(window_evals),
                                      min(2, len(window_evals)),
                                      replace=False).tolist())) \
            if window_evals else []
        judged = evals + [window_evals[i] for i in picks]
        for e in judged:
            e["seed"] = prog.cfg.seed
        del prog, window_evals
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        c0 = time.perf_counter()
        want = follow(conf, inputs)
        nums = numbers(conf, inputs, readings, want)
        nums["launch_gap"] = float(launch_gap)
        if evals_on:
            nums["eval_gap"] = judge_evals(judged, conf["eval_episodes"],
                                           device)
        sync()
        check_s = time.perf_counter() - c0
        record = {"setup_s": setup_s, "window_s": window_s,
                  "work": {"iterations": iters, "calls": calls,
                           "env_steps": iters * P * batch,
                           "evals": len(eval_s), **shape},
                  "eval_s": eval_s, "trace": tr, "attempted": iters,
                  "failed": failed, "memory_peak_bytes": int(peak),
                  "numbers": nums, "check_s": check_s,
                  # the losses of the call of K against the one-iteration
                  # calls' (the same replays: 0 where they agree bit for bit)
                  "call_vs_steps": max(
                      float(np.max(np.abs(np.asarray(a, float)
                                          - np.asarray(b, float))))
                      for a, b in zip(readings["loss"],
                                      readings["loss_steps"]))}
        if controls:
            record.update(calibration(conf, inputs, readings, want,
                                      judged if evals_on else None, device))
        return record
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
