"""Run a Python command as W ranks on this host, with a time limit.

`run_ranks(["-m", "acas2d_tpu_torch.train", ...], 2, 120)` sets what
`python -m torch.distributed.run --nproc-per-node W` sets for each rank
(RANK, LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT
on a free port) and OMP_NUM_THREADS=1 unless it is set, so that
`parallel.mesh.multihost_init` joins the group as under the launcher.
Unlike the launcher it ends the whole run when one rank fails (its peers
would wait in a collective until their timeout) or when the time limit
passes, killing every rank, and it returns every rank's exit code and
output.  The tests and `chip_smoke.py` run their ranks through it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

GRACE_S = 10.0     # how long the other ranks may run on after one failed


@dataclasses.dataclass
class RankResult:
    rank: int
    returncode: Optional[int]     # None: killed by `run_ranks`
    stdout: str
    stderr: str


def free_port() -> int:
    """A TCP port that was free a moment ago (bound to 0 and released)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    """The environment of rank `rank` of `world` on this host."""
    env = dict(os.environ)
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def run_ranks(args: Sequence[str], world: int, timeout_s: float,
              cwd: Optional[str] = None) -> List[RankResult]:
    """`python <args>` as `world` ranks; waits for all of them, at most
    `timeout_s`, and returns each rank's result.  When a rank fails, the
    others are killed GRACE_S later; at the time limit every rank still
    running is killed.  Never leaves a process behind."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.ExitStack() as files:
        outs = [tuple(files.enter_context(open(os.path.join(tmp, f"{r}{k}"),
                                                "w+")) for k in (".out",
                                                                 ".err"))
                for r in range(world)]
        procs = []
        try:
            for r in range(world):
                procs.append(subprocess.Popen(
                    [sys.executable] + list(args), cwd=cwd,
                    env=rank_env(r, world, port), stdout=outs[r][0],
                    stderr=outs[r][1]))
            deadline = time.monotonic() + timeout_s
            failed_at = None
            while any(p.poll() is None for p in procs):
                now = time.monotonic()
                if failed_at is None and any(p.poll() not in (None, 0)
                                             for p in procs):
                    failed_at = now
                if now > deadline or (failed_at is not None
                                      and now > failed_at + GRACE_S):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        results = []
        for r, (o, e) in enumerate(outs):
            o.seek(0)
            e.seek(0)
            code = procs[r].returncode
            results.append(RankResult(r, None if code == -9 else code,
                                      o.read(), e.read()))
        return results


def check_ranks(results: List[RankResult]) -> List[RankResult]:
    """`results`, or a RuntimeError with every failed rank's stderr."""
    bad = [r for r in results if r.returncode != 0]
    if bad:
        raise RuntimeError("\n".join(
            f"rank {r.rank} exited {r.returncode}:\n{r.stderr[-4000:]}"
            for r in bad))
    return results
