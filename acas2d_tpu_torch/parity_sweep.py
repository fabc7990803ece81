"""Seed sweep at the reference config of record (counterpart of
`scripts/parity_sweep.sh:6-24`): the evidence base for sample-efficiency
parity against the reference's single committed run (evaluations.npz,
final 1198).

    python -m acas2d_tpu_torch.parity_sweep [--out-dir runs/parity] \\
        [--ref-seeds 0,...,9] [--env8-seeds 0,1,2,3] [--exact-seeds 12] \\
        [--device cuda]

It trains, in this process through `train.main`, the reference config
(1 env x 2048 steps x 512 iterations) at each of --ref-seeds as
`ref_s<seed>`, the 8-env variant at each of --env8-seeds as
`env8_s<seed>`, and the config with `--exact-eval` (evals drawn from the
continuing Mersenne stream, so that the logged curve is
protocol-identical to the reference's evaluations.npz) at each of
--exact-seeds as `exact_eval_ref_s<seed>`, each into `<out-dir>/<name>/`,
its stdout and stderr into `<out-dir>/<name>.log`, whose last two lines
are echoed.  `python -m acas2d_tpu_torch.export_parity_artifacts` turns
the sweep into curves, params and a summary.

One deliberate difference from the script: a run that raises ends the
sweep with it (non-zero), where the script's loop moves on past a failed
or timed-out (`timeout 900`) run; a run left out would go unseen in the
summary.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from acas2d_tpu_torch import train

# scripts/parity_sweep.sh: (run-name prefix, train flags beside --seed,
# --run-name and --out-dir, seeds) in the script's order
SWEEP = (("ref", (), tuple(range(10))),
         ("env8", ("--n-envs", "8"), (0, 1, 2, 3)),
         ("exact_eval_ref", ("--exact-eval",), (12,)))


def commands(out_dir: str, seeds: Optional[Dict[str, Sequence[int]]] = None,
             sweep=SWEEP, device: Optional[str] = None
             ) -> List[Tuple[str, List[str]]]:
    """(run name, train argv) of every run, in order; `seeds` replaces a
    prefix's seed list."""
    seeds = seeds or {}
    dev = ["--device", device] if device else []
    out = []
    for prefix, flags, default in sweep:
        for s in seeds.get(prefix, default):
            name = f"{prefix}_s{s}"
            out.append((name, ["--seed", str(s)] + list(flags)
                        + ["--run-name", name, "--out-dir", out_dir] + dev))
    return out


def run_sweep(out_dir: str = "runs/parity",
              seeds: Optional[Dict[str, Sequence[int]]] = None,
              sweep=SWEEP, device: Optional[str] = None) -> List[str]:
    """Train every run of the sweep; returns their run dirs.  A run that
    raises ends the sweep."""
    os.makedirs(out_dir, exist_ok=True)
    dirs = []
    for name, argv in commands(out_dir, seeds, sweep, device):
        log = os.path.join(out_dir, f"{name}.log")
        with open(log, "w") as f, contextlib.redirect_stdout(f), \
                contextlib.redirect_stderr(f):
            train.main(argv)
        with open(log) as f:
            print("".join(f.readlines()[-2:]), end="", flush=True)
        dirs.append(os.path.join(out_dir, name))
    return dirs


def _seeds(text: str) -> Tuple[int, ...]:
    return tuple(int(s) for s in text.split(",") if s)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out-dir", default="runs/parity")
    for prefix, _, default in SWEEP:
        p.add_argument(f"--{prefix.split('_')[0]}-seeds", dest=prefix,
                       type=_seeds, default=default,
                       help=f"comma-separated seeds of the {prefix}_s<seed> "
                            f"runs (default {','.join(map(str, default))})")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    run_sweep(args.out_dir, {prefix: getattr(args, prefix)
                             for prefix, _, _ in SWEEP}, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
