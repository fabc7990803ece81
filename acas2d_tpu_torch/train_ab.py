"""A/B of the training driver's iteration time between source trees.

    python -m acas2d_tpu_torch.train_ab --source parent=_proof/parent \\
        [--rounds 3] -- --preset tpu --fused-rollout --fused-update \\
        --total-steps 2621440

runs `python -m acas2d_tpu_torch.train <args>` from this checkout ("tree")
and from each other tree (another checkout's root, e.g. a parent unpacked
with `git archive` into the gitignored `_proof/`), in turns (a, b, b, a,
...), each process into its own temporary `--out-dir`.  For each run it
prints the `seconds` of the iterations after the first (ms: from the
step's start to its metrics on the host), then one JSON line with each
tree's run medians and the median over all its iterations.  These are
host-clock times of separate processes: compare trees only within one
call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

import torch

ROOT = Path(__file__).resolve().parent.parent


def iteration_ms(stdout: str) -> List[float]:
    """The iteration times (ms) after the first of a driver's JSON rows."""
    rows = [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]
    return [r["seconds"] * 1e3 for r in rows[1:]]


def run_tree(root: Path, train_argv: List[str]) -> List[float]:
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run(
            [sys.executable, "-m", "acas2d_tpu_torch.train", *train_argv,
             "--out-dir", out], cwd=root, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=str(root)))
    if proc.returncode:
        raise RuntimeError(f"train in {root} exited {proc.returncode}:\n"
                           f"{proc.stderr[-2000:]}")
    return iteration_ms(proc.stdout)


def main(argv=None) -> Dict[str, Dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source", action="append", default=[],
                   metavar="NAME=DIR", help="another tree to time")
    p.add_argument("--rounds", type=int, default=3,
                   help="turns of every tree (alternating order)")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="-- then the driver's arguments")
    args = p.parse_args(argv)
    train_argv = args.train_args
    if train_argv[:1] == ["--"]:
        train_argv = train_argv[1:]
    trees = {"tree": ROOT}
    for spec in args.source:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    if torch.cuda.is_available():
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    names = list(trees)
    times: Dict[str, List[List[float]]] = {n: [] for n in names}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            ms = run_tree(trees[name], train_argv)
            times[name].append(ms)
            print(f"{name} median {statistics.median(ms):.2f} mean "
                  f"{statistics.fmean(ms):.2f} ms {[round(t, 1) for t in ms]}",
                  flush=True)
    result = {n: {"run_medians": [round(statistics.median(ms), 2)
                                  for ms in runs],
                  "median": round(statistics.median(
                      [t for ms in runs for t in ms]), 2)}
              for n, runs in times.items()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
