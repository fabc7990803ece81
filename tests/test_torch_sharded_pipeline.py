"""A population run of the training driver on two gloo ranks (`python -m
torch.distributed.run --nproc-per-node 2 -m acas2d_tpu_torch.train
--population 4 ...`, here through `parallel.launch`): P = 4 members, two a
rank, with the evals, the snapshot archive, the re-eval and the selection
on rank 0, and a polish stage warm-started from rank 0's top snapshots.

One launch of two ranks (`python -m tests.test_torch_sharded_pipeline
worker DIR`) runs it; the test holds it against one process: the final
checkpoints, `population.json`, the snapshot archive and the rows of the
stage and of its polish stage, bit for bit (two members a rank: a rank of
one member would take the CPU's other matmul path for a batch of one,
which rounds otherwise), and each summary's `n_devices` 2."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from acas2d_tpu_torch import train
from acas2d_tpu_torch.parallel import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120
B = 16 * 16
# one eval a stage (its first iteration's), since evals are most of the time
POP = ["--preset", "tpu", "--device", "cpu", "--population", "4",
       "--n-envs", "16", "--n-steps", "16", "--minibatch-size", "64",
       "--n-epochs", "2", "--eval-every", str(4 * B), "--eval-episodes", "1",
       "--reval-episodes", "2", "--total-steps", str(2 * B),
       "--polish-steps", str(B), "--polish-pop", "4", "--run-name", "p"]


def _worker(d: str) -> None:
    torch.set_num_threads(1)
    train.main(POP + ["--out-dir", d])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # the ranks' (OMP_NUM_THREADS=1)
    try:
        d = str(tmp_path_factory.mktemp("sharded_pipeline"))
        launch.check_ranks(launch.run_ranks(
            ["-m", "tests.test_torch_sharded_pipeline", "worker", d], 2,
            JOIN_S, cwd=ROOT))
        one = str(tmp_path_factory.mktemp("one_process"))
        train.main(POP + ["--out-dir", one])
        yield d, one
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("stage", ["p", "p_polish"])
def test_population_on_two_ranks_is_one_process(runs, stage):
    from test_torch_sharded_driver import _assert_equal, _ckpt, _rows

    d, one = runs
    two, ref = f"{d}/{stage}", f"{one}/{stage}"
    steps = sorted(int(x) for x in os.listdir(f"{two}/checkpoints")
                   if x.isdigit())
    _assert_equal(_ckpt(two, steps[-1]), _ckpt(ref, steps[-1]))
    with open(f"{two}/population.json") as f, \
            open(f"{ref}/population.json") as g:
        assert json.load(f) == json.load(g)
    a, b = (np.load(f"{two}/population_best.npz"),
            np.load(f"{ref}/population_best.npz"))
    assert a.files == b.files
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
    with open(f"{two}/summary.json") as f:
        assert json.load(f)["n_devices"] == 2
    assert _rows(two, "train") == _rows(ref, "train")


if __name__ == "__main__":
    _worker(sys.argv[2])
