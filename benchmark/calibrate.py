"""Readings for the limits of a cell's correctness check, on the card.

    python3 benchmark/calibrate.py --workload pop32.train \\
        --seeds 11,12,13 --control-seeds 11,12 --seconds 2

For each seed, in one process (the kernels load once): a run of the cell
with a short window, and the numbers its check compares (the program's
readings: the lower ones).  On the control seeds also the same numbers of
the reference computed in the next precision down (TF32 for the training
cells' products, bfloat16 for the env rollout) and, for the training
cells, of the reference with a planted fault (half of each minibatch
left out; every reward altered where it is produced): the upper
readings.  One JSON line a seed, on standard output and appended to
`--out`.  The benchmark's own runs never run the controls.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import run, spec
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    torch.empty(1, device=device)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    t0 = T0
    for s in (int(x) for x in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats(device)
        rec = run.measure(cell, s, args.seconds, False, device, t0,
                          s in controls)
        line = {"workload": args.workload, "seed": s,
                "numbers": rec["numbers"],
                "controls": rec.get("controls"),
                "detail": rec.get("detail"),
                "setup_s": rec["setup_s"], "window_s": rec["window_s"],
                "check_s": rec["check_s"],
                "call_vs_steps": rec.get("call_vs_steps"),
                "work": rec["work"],
                "memory_peak_bytes": rec["memory_peak_bytes"],
                "seconds": time.perf_counter() - t0,
                "device": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
