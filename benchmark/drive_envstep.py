"""The `envstep` driver: the program's fused env rollout chained on its own
state, as the program's env-stepping bench drives it.

Set-up makes the spawn uniforms of B envs on the device from the seed,
builds the program's state from them (its engine's spawn and first
observation) and runs the first launch from it, which the reference
follows from the same uniforms; then launches chained as the window
chains them warm the card for `warm_seconds`.
Every launch takes a seed of its own, drawn from the run's seed.  The
window chains launches of T steps, each on the state the last one left,
with a host transfer of one element of the newest sums every
`launches_per_sync` launches, and ends at the first transfer after
`seconds` (and after the judged launch).  One launch of the window, drawn from the seed, is kept with
its input and judged by the reference from that input.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from . import checks, tracing
from .reference import rollouts as ref_roll
from .reference import envmath as em

def _as_ref(st: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The program's flat state under the reference's names."""
    return {("total" if k == "total_reward" else k): v for k, v in st.items()}


def _outputs(st, stats) -> Dict[str, torch.Tensor]:
    return {**_as_ref(st), **stats}


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float, controls: bool = False) -> Dict:
    from acas2d_tpu_torch.config import DEFAULT_PARAMS
    from acas2d_tpu_torch.envs import core
    from acas2d_tpu_torch.ops import env_rollout
    conf, traffic = cell.config, cell.traffic
    B, T = int(conf["n_envs"]), int(traffic["steps_per_launch"])
    with_obs = bool(traffic["with_obs"])
    per_sync = int(traffic["launches_per_sync"])
    cuda = device.type == "cuda"
    ss = np.random.SeedSequence(int(seed))
    gen = torch.Generator(device=device).manual_seed(
        int(ss.generate_state(1, np.uint64)[0]))
    seeds = np.random.default_rng(ss.spawn(1)[0])
    u = torch.rand(B, 5, generator=gen, device=device, dtype=torch.float64)
    es, _ = core.observe(core.spawn_from_uniforms(u, DEFAULT_PARAMS,
                                                  torch.float32),
                         DEFAULT_PARAMS)
    st = env_rollout.flat_state(es)

    def launch(state, s):
        return env_rollout.fused_rollout(state, s, T, DEFAULT_PARAMS,
                                         with_obs=with_obs)

    def draw():
        return int(seeds.integers(-2 ** 31, 2 ** 31))

    seed1 = draw()
    st, stats = launch(st, seed1)
    first = _outputs(st, stats)
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < traffic["warm_seconds"]:
        for _ in range(per_sync):
            st, stats = launch(st, draw())
        stats["obs_sum"][:1].cpu()
    setup_s = time.perf_counter() - t0

    # the window's judged launch, drawn from the seed among its first
    # syncs (a window of 1 s holds ~100 of them)
    pick = int(np.random.default_rng([int(seed), 29]).integers(
        per_sync, 4 * per_sync))
    kept = None
    launches, w0 = 0, time.perf_counter()
    while True:
        for _ in range(per_sync):
            s = draw()
            if launches == pick:
                kept = (st, s)
            st, stats = launch(st, s)
            if launches == pick:
                kept = kept + (_outputs(st, stats),)
            launches += 1
        stats["obs_sum"][:1].cpu()
        if time.perf_counter() - w0 >= seconds and kept is not None:
            break
    window_s = time.perf_counter() - w0

    tr = None
    if trace:
        sl = tracing.Slice(cuda)
        sl.start()
        for _ in range(per_sync):
            st, stats = launch(st, draw())
        stats["obs_sum"][:1].cpu()
        sl.begin()
        n, episodes, s0 = 0, [], time.perf_counter()
        while time.perf_counter() - s0 < traffic["trace_seconds"]:
            with sl.span("launch"):
                for _ in range(per_sync):
                    st, stats = launch(st, draw())
                    episodes.append(stats["episodes"])
                    n += 1
            with sl.span("sync"):
                stats["obs_sum"][:1].cpu()
        tr = sl.stop({"launches": n, "n_envs": B,
                      "steps_per_launch": T, "with_obs": with_obs})
        tr.work["episodes"] = float(sum(int(e.sum()) for e in episodes))
        del episodes
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del st, stats
    gc.collect()

    nums = {}
    c0 = time.perf_counter()
    want = ref_roll.env_rollout(_start(u), seed1, T)
    share1, err1 = checks.env_agreement(first, want, T)
    del want
    state, s, got = kept
    want = ref_roll.env_rollout(_as_ref(state), s, T)
    share2, err2 = checks.env_agreement(got, want, T)
    nums["env_flipped"] = max(share1, share2)
    nums["env_err"] = max(err1, err2)
    check_s = time.perf_counter() - c0
    record = {"setup_s": setup_s, "window_s": window_s,
              "work": {"launches": launches, "env_steps": launches * B * T},
              "eval_s": [], "trace": tr, "attempted": launches, "failed": 0,
              "memory_peak_bytes": int(peak), "numbers": nums,
              "check_s": check_s}
    if controls:
        want = ref_roll.env_rollout(_start(u), seed1, T)
        low = ref_roll.env_rollout(_start(u), seed1, T,
                                   dtype=torch.bfloat16)
        share, err = checks.env_agreement(low, want, T)
        record["controls"] = {"bf16": {"env_flipped": share,
                                       "env_err": err}}
    return record


def _start(u: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reference's start from the spawn uniforms: the engine's spawn
    and first observation (which counts the first step)."""
    s, _ = em.observe(em.spawn_uniforms(u))
    return {"px": s.px, "py": s.py, "psi": s.psi, "tx": s.tx, "ty": s.ty,
            "tv": s.tv, "tpsi": s.tpsi, "steps": s.steps.to(torch.int32),
            "total": s.total}
