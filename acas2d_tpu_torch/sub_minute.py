"""One command for a policy from scratch: an 8-member population and its
in-process polish, then the strict eval (counterpart of
`scripts/sub_minute.sh:25-53`).

    python -m acas2d_tpu_torch.sub_minute <master_seed> [out_prefix] \\
        [--out-dir runs/ppo] [--device cuda]

ONE `train` command (SUB_MINUTE_ARGV, the script's flags): 8 members on
the member-grid fused rollout and the fused update, 1024 envs x
134,217,728 steps each, then an 8-member polish stage of 33,554,432 steps,
as `<out-dir>/<prefix>_s<seed>` and `…_polish`.  The host clock around
that call is the training wall, written as `training_wall_s` (seconds, one
decimal, as the script writes it) into the polish stage's population.json,
beside the merge record the polish chaining wrote there.  Then the
strict verification, not part of the wall: `eval --params-npz
…_polish/selected_best.npz --exact --episodes 100 --out
…_polish/eval_100_exact.csv`.

With 8 members the winner clears 1200 on the strict protocol for some
seeds, not all (the script's odds note: max-of-8 finds a member with the
headroom ~52% of the time against ~95% for the pipeline's max-of-32);
`python -m acas2d_tpu_torch.pipeline` is the every-seed path.  A run that
raises ends the command, as the script's `set -e` does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

from acas2d_tpu_torch import eval as eval_driver
from acas2d_tpu_torch import train

# scripts/sub_minute.sh:29-35
SUB_MINUTE_ARGV = ["--preset", "tpu", "--anneal-lr", "--population", "8",
                   "--fused-rollout", "--fused-update-packed",
                   "--n-envs", "1024", "--minibatch-size", "32768",
                   "--total-steps", "134217728",
                   "--checkpoint-every", "134217728",
                   "--eval-episodes", "32", "--reval-episodes", "512",
                   "--polish-steps", "33554432", "--polish-pop", "8"]


def run_sub_minute(master_seed: int, prefix: str = "subminute",
                   argv: Sequence[str] = SUB_MINUTE_ARGV,
                   out_dir: str = "runs/ppo", device: Optional[str] = None,
                   eval_episodes: int = 100) -> Dict:
    """Train, record the wall, and run the strict eval.  Returns the polish
    dir, the training wall (s, unrounded) and the strict eval's summary."""
    S = int(master_seed)
    dev = ["--device", device] if device else []
    t0 = time.perf_counter()
    train.main(list(argv) + ["--seed", str(S), "--run-name",
                             f"{prefix}_s{S}", "--out-dir", out_dir] + dev)
    wall = time.perf_counter() - t0
    print(f"[sub_minute] seed {S} training wall: {wall:.1f} s",
          file=sys.stderr)
    polish = os.path.join(out_dir, f"{prefix}_s{S}_polish")
    path = os.path.join(polish, "population.json")
    with open(path) as f:
        record = json.load(f)
    record["training_wall_s"] = float(f"{wall:.1f}")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)

    summary = eval_driver.run(eval_driver.parse_args(
        ["--params-npz", os.path.join(polish, "selected_best.npz"),
         "--exact", "--episodes", str(eval_episodes), "--out",
         os.path.join(polish, f"eval_{eval_episodes}_exact.csv")] + dev),
        log=sys.stderr)
    print(json.dumps(summary))
    return {"polish": polish, "training_wall_s": wall, "strict": summary}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("master_seed", type=int)
    p.add_argument("out_prefix", nargs="?", default="subminute")
    p.add_argument("--out-dir", default="runs/ppo",
                   help="where the two stage dirs go")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    run_sub_minute(args.master_seed, args.out_prefix, out_dir=args.out_dir,
                   device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
