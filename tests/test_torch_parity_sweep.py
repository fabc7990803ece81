"""`python -m acas2d_tpu_torch.parity_sweep` (the port of
scripts/parity_sweep.sh), on the CPU.

  * Its commands are the script's: the same runs in the same order, the
    same flags, names and output directory (less the script's `--platform
    cpu`: the port has `--device`).
  * A cut sweep of two runs (a few hundred steps each, one thread) writes
    their run dirs and logs and echoes each log's last two lines.
  * The seed lists and the output directory come from the command line.
  * A run that raises ends the sweep, where the script's loop moves on.
"""

import os
import re
import shlex

import pytest
import torch

from acas2d_tpu_torch import parity_sweep, train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = ("--device", "cpu", "--n-steps", "64", "--total-steps", "128",
       "--eval-every", "128", "--eval-episodes", "1",
       "--checkpoint-every", "128")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def script_commands():
    """(run name, train argv) of every run of scripts/parity_sweep.sh, in
    its order: each `python train.py` command, inside a `for s in ...`
    loop or not, with $s substituted."""
    with open(os.path.join(ROOT, "scripts", "parity_sweep.sh")) as f:
        text = f.read().replace("\\\n", " ")
    out = []
    seeds = None
    for line in text.splitlines():
        line = line.strip()
        m = re.match(r"for s in ([\d ]+); do", line)
        if m:
            seeds = m.group(1).split()
        elif line == "done":
            seeds = None
        elif "python train.py" in line:
            cmd = line[line.index("python train.py"):line.index(">")]
            argv = shlex.split(cmd)[2:]
            i = argv.index("--platform")
            del argv[i:i + 2]
            for s in seeds or [None]:
                a = [x.replace("$s", s) if s else x for x in argv]
                out.append((a[a.index("--run-name") + 1], a))
    return out


def test_commands_are_the_scripts():
    want = script_commands()
    assert len(want) == 10 + 4 + 1
    assert parity_sweep.commands("runs/parity") == want


def cut(sweep=parity_sweep.SWEEP):
    return tuple((p, tuple(flags) + CUT, seeds) for p, flags, seeds in sweep)


def test_cut_sweep_writes_its_runs(tmp_path, capsys):
    out = str(tmp_path / "parity")
    dirs = parity_sweep.run_sweep(out, {"ref": (3,), "env8": (),
                                        "exact_eval_ref": (12,)}, cut())
    assert dirs == [os.path.join(out, "ref_s3"),
                    os.path.join(out, "exact_eval_ref_s12")]
    printed = capsys.readouterr().out.splitlines()
    for d in dirs:
        for name in ("eval.csv", "summary.json", "train.jsonl"):
            assert os.path.exists(os.path.join(d, name)), (d, name)
        assert os.path.isdir(os.path.join(d, "checkpoints", "best"))
        with open(d + ".log") as f:
            tail = f.read().splitlines()[-2:]
        assert all(line in printed for line in tail)
    assert sorted(os.listdir(out)) == ["exact_eval_ref_s12",
                                       "exact_eval_ref_s12.log", "ref_s3",
                                       "ref_s3.log"]


def test_command_line_seeds_and_out_dir(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(train, "main", lambda argv: seen.append(argv) or 0)
    out = str(tmp_path / "p")
    assert parity_sweep.main(["--out-dir", out, "--ref-seeds", "4,5",
                              "--env8-seeds", "", "--exact-seeds", "7",
                              "--device", "cpu"]) == 0
    names = [a[a.index("--run-name") + 1] for a in seen]
    assert names == ["ref_s4", "ref_s5", "exact_eval_ref_s7"]
    assert all(a[a.index("--out-dir") + 1] == out and a[-2:] == ["--device",
                                                                "cpu"]
               for a in seen)
    assert "--exact-eval" in seen[2] and "--exact-eval" not in seen[0]


def test_a_raising_run_ends_the_sweep(tmp_path, monkeypatch):
    calls = []

    def failing(argv):
        calls.append(argv)
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(train, "main", failing)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        parity_sweep.main(["--out-dir", str(tmp_path / "p"), "--device",
                           "cpu"])
    assert len(calls) == 1
