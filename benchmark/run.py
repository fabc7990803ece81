"""The benchmark of `acas2d_tpu_torch` on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload pop32.train --seed 123 \\
        --seconds 10 --trace 0

Runs from the root of a checkout.  The cell (an entry of BENCHMARK.json's
`workloads`) names its configuration and traffic mix; the driver that
the mix names (`benchmark/drive_<drive>.py`) makes the inputs from
`--seed`, sets up the program and warms every shape the window uses
(`setup_s`), measures
for `--seconds`, then checks what the timed path produced against the
plain reference (`benchmark/reference/`).  The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics; with `--trace 1` its per-layer metrics,
read from a traced slice after the window), `device`, with `--trace 1`
`breakdown`, and last `checks`: each number compared, with its limit.
The same numbers end standard error.

A run fails, and prints no result, without a card, with fewer cards than
the cell asks for, where the program's package is missing from the
checkout, or where `jax`, `jaxlib`, `flax` or `acas2d_tpu` is loaded once
the window has closed.  The program's kernels build once into its own
directory inside the checkout (`acas2d_tpu_torch/_build/`).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = "acas2d_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "acas2d_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t0: float, controls: bool = False) -> dict:
    """One run of `cell` on `device` by its mix's driver
    (`benchmark/drive_<drive>.py`): the record."""
    from benchmark import spec
    return spec.driver(cell.traffic["drive"], cell.root).run(
        cell, seed, seconds, trace, device, t0, controls)


def metrics_of(cell, record: dict, trace: bool, root: Path = ROOT) -> dict:
    """The cell's end-to-end metrics (per-layer with `trace`), each read
    by its reader; a reader that finds nothing to read leaves its metric
    out."""
    from benchmark import spec
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], root).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(cell, record: dict, trace: bool, device: dict,
           root: Path = ROOT) -> dict:
    from benchmark import checks
    correct, judged = checks.judge(record["numbers"], cell.limits)
    out = {"correct": bool(correct and record["failed"] == 0),
           "attempted": int(record["attempted"]),
           "failed": int(record["failed"]),
           "metrics": metrics_of(cell, record, trace, root),
           "device": device}
    if trace and record["trace"] is not None:
        tr = record["trace"]
        out["device"] = {**device, "busy_s": tr.busy_s(),
                         "window_s": tr.window_s}
        out["breakdown"] = tr.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in judged.items()}
    return out


def _json_number(x):
    return x if isinstance(x, (int, str)) or math.isfinite(x) else str(x)


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / PROGRAM / "__init__.py").is_file():
        print(f"no {PROGRAM} package in {ROOT}: nothing to measure",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from benchmark import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    # one process with one host thread for torch's CPU work: the card is
    # what is measured, and idle worker threads only add the host's noise
    # (with torch's default threads the rates' medians read the same and
    # their spreads wider)
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    limit = power_limit()
    print(f"[bench] {args.workload} seed {args.seed} on {name} "
          f"({limit or 'power limit not read'})", file=sys.stderr)
    record = measure(cell, args.seed, args.seconds, bool(args.trace), device,
                     T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    out = result(cell, record, bool(args.trace),
                 {"platform": "gpu", "kind": name, "count": cell.chips,
                  "memory_peak_bytes": record["memory_peak_bytes"],
                  "power_limit": limit})
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    out["checks"] = {k: {kk: _json_number(vv) for kk, vv in c.items()}
                     for k, c in out["checks"].items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
