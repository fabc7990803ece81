"""The training driver's A/B tool (`python -m acas2d_tpu_torch.train_ab`)
on the CPU at a tiny shape: it runs the driver from each tree in turns
(a, b, b, a) and reports, per run, the `seconds` of every iteration after
the first."""

import json

from acas2d_tpu_torch import train_ab

TINY = ["--preset", "tpu", "--fused-rollout", "--fused-update",
        "--device", "cpu", "--n-envs", "64", "--n-steps", "32", "--minibatch-size", "1024", "--n-epochs", "1",
        "--total-steps", str(3 * 64 * 32), "--eval-every", str(1 << 30),
        "--eval-episodes", "1"]


def test_iteration_ms_skips_the_first_row():
    out = "\n".join(["resumed", json.dumps({"seconds": 2.0}),
                     json.dumps({"seconds": 0.25}),
                     json.dumps({"seconds": 0.5})])
    assert train_ab.iteration_ms(out) == [250.0, 500.0]


def test_tool_times_trees_in_turns(capsys, monkeypatch):
    # one intra-op thread a driver: the suite runs workers side by side
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = train_ab.main(["--source", f"same={train_ab.ROOT}", "--rounds",
                         "2", "--"] + TINY)
    assert set(res) == {"tree", "same"}
    for r in res.values():
        assert len(r["run_medians"]) == 2
        assert all(m > 0 for m in r["run_medians"]) and r["median"] > 0
    runs = [line.split()[0] for line in capsys.readouterr().out.splitlines()
            if " median " in line]
    assert runs == ["tree", "same", "same", "tree"]
