"""Cells, configurations, traffic mixes and metric readers, found by name.

`BENCHMARK.json` at the checkout's root lists them; each lives in files
of its own under `benchmark/`:

  * `workloads/<cell>.json`: the cell's configuration, mix and chips (as
    `BENCHMARK.json` states them) and the limits of its correctness check;
  * `configs/<config>.json`: the configuration as it is run (the file
    `BENCHMARK.json` names);
  * `traffic/<mix>.json`: the mix's parameters, with `drive`, the name of
    the general driver that reads them;
  * `drive_<drive>.py`: a driver, `run(cell, seed, seconds, trace, device,
    t0, controls) -> record`, which sets up, drives and times the window
    and checks what it produced (`train`, `envstep`);
  * `metrics/<metric>.py`: one reader a metric, `read(record) -> float or
    None`, which states its LAYER, UNIT, SOURCE and MOVES.

So a later change adds a cell, a configuration, a mix, a driver or a
metric as new files and new entries, and edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    chips: int
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path = ROOT


def benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json, with its files."""
    spec = benchmark(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    own = _json(root / "benchmark" / "workloads" / f"{name}.json")
    for k in ("config", "traffic", "chips"):
        if own[k] != entry[k]:
            raise ValueError(f"workloads/{name}.json says {k}={own[k]!r}, "
                             f"BENCHMARK.json {entry[k]!r}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in reported)]
    return Cell(name=name, config_name=entry["config"],
                config=_json(root / conf["file"]),
                traffic_name=entry["traffic"],
                traffic=_json(root / "benchmark" / "traffic"
                              / f"{entry['traffic']}.json"),
                chips=int(entry["chips"]), limits=dict(own["limits"]),
                end_to_end=e2e, per_layer=per, root=root)


def _load(name: str, path: Path) -> ModuleType:
    """The module at `path` under `name`, loaded once."""
    mod = sys.modules.get(name)
    if mod is not None and Path(getattr(mod, "__file__", "")) == path:
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    """The module of `benchmark/metrics/<metric>.py`."""
    return _load("bench_metric_" + metric.replace(".", "_"),
                 root / "benchmark" / "metrics" / f"{metric}.py")


def driver(drive: str, root: Path = ROOT) -> ModuleType:
    """The module of `benchmark/drive_<drive>.py`, inside the `benchmark`
    package, so that its relative imports find the yardstick."""
    return _load(f"benchmark.drive_{drive}",
                 (root / "benchmark" / f"drive_{drive}.py").resolve())
