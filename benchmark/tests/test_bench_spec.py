"""BENCHMARK.json and the files it names: every cell resolves by name to
its configuration, mix and metrics; the file keeps to the contract's
shapes; and a new cell, mix, configuration and metric come in as new files
and entries, with no file that is there edited."""

import json
import re
import shutil

import pytest

from benchmark import run, spec
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = spec.benchmark()
CELLS = [w["name"] for w in B["workloads"]]


def test_keys_and_names():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["benchmark"]
    assert 1 <= B["run_seconds"] <= 51
    names = ([c["name"] for c in B["configs"]] + CELLS
             + [m["name"] for m in B["end_to_end"] + B["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert "setup_s" in {m["name"] for m in B["end_to_end"]}
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    layers = {m["layer"] for m in B["per_layer"]}
    assert all(len(x) <= 200 and "\n" not in x for x in layers)
    assert len(json.dumps(B)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.load_cell(name)
    conf = next(c for c in B["configs"] if c["name"] == cell.config_name)
    assert (ROOT / conf["file"]).is_file()
    assert callable(spec.driver(cell.traffic["drive"]).run)
    assert cell.limits
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
        mod = spec.reader(m["name"])
        assert (mod.UNIT, mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["unit"], m["source"], m["layer"], m["moves"])
    for m in cell.end_to_end:
        mod = spec.reader(m["name"])
        assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"])


DRIVER = """
from . import checks


def run(cell, seed, seconds, trace, device, t0, controls=False):
    return {"setup_s": 1.0, "window_s": 2.0, "trace": None,
            "work": {"iterations": cell.traffic["iterations"]},
            "attempted": 1, "failed": 0, "memory_peak_bytes": 0,
            "numbers": {"loss_gap.1": checks.loss_gap([1.0], [1.0])}}
"""


def test_new_cell_comes_in_as_files(tmp_path):
    """A copy of the tree gains a configuration, a mix, a cell, a metric
    and a driver as new files and entries: they resolve, a run of the cell
    goes through the new driver and the metric reads, and no file that was
    there changed."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((ROOT / "benchmark/configs/solo_tpu.json").read_text())
    d = tmp_path / "benchmark"
    (d / "configs" / "solo4k.json").write_text(json.dumps(
        {**base, "name": "solo4k", "n_envs": 4096}))
    (d / "traffic" / "train_short.json").write_text(json.dumps(
        {"drive": "train", "evals": False, "trace_calls": 1,
         "trace_seconds": 0.0}))
    (d / "drive_fixed.py").write_text(DRIVER)
    (d / "traffic" / "fixed.json").write_text(json.dumps(
        {"drive": "fixed", "iterations": 12}))
    (d / "workloads" / "solo4k.fixed.json").write_text(json.dumps(
        {"config": "solo4k", "traffic": "fixed", "chips": 1,
         "limits": {"loss_gap.1": 0.0}}))
    (d / "workloads" / "solo4k.train_short.json").write_text(json.dumps(
        {"config": "solo4k", "traffic": "train_short", "chips": 1,
         "limits": {"loss_gap.1": 1.0}}))
    (d / "metrics" / "window.iterations.py").write_text(
        "LAYER = 'training loop'\nUNIT = 'iterations'\n"
        "SOURCE = 'program_counter'\nMOVES = 'train_env_steps_per_s'\n"
        "def read(record):\n    return record['work'].get('iterations')\n")
    bench["configs"].append({"name": "solo4k", "source": "x",
                             "file": "benchmark/configs/solo4k.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "solo4k.train_short",
                               "config": "solo4k", "traffic": "train_short",
                               "chips": 1, "why": "x"})
    bench["workloads"].append({"name": "solo4k.fixed", "config": "solo4k",
                               "traffic": "fixed", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"] += ["solo4k.train_short",
                                            "solo4k.fixed"]
    bench["per_layer"].append({"name": "window.iterations",
                               "unit": "iterations", "better": "higher",
                               "source": "program_counter",
                               "layer": "training loop",
                               "moves": "train_env_steps_per_s",
                               "workloads": ["solo4k.train_short",
                                             "solo4k.fixed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("solo4k.train_short", tmp_path)
    assert cell.config["n_envs"] == 4096
    assert cell.traffic["trace_calls"] == 1
    assert [m["name"] for m in cell.per_layer] == ["window.iterations"]
    mod = spec.reader("window.iterations", tmp_path)
    assert mod.read({"work": {"iterations": 12}}) == 12
    cell = spec.load_cell("solo4k.fixed", tmp_path)
    rec = run.measure(cell, 1, 1.0, True, None, 0.0)
    out = run.result(cell, rec, True, {}, tmp_path)
    assert out["correct"] is True
    assert out["metrics"] == {"window.iterations": {"value": 12.0,
                                                    "unit": "iterations"}}
    for p, data in before.items():
        assert p.read_bytes() == data
