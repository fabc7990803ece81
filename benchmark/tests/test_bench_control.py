"""The control: the reference put in the program's place and computed in
the next precision down must come out not correct by the cell's limits.
The env rollout's (bfloat16) runs here on the CPU; the training cells'
(TF32 products) needs the card, where it runs at the solo cell's own size:

    python -m pytest benchmark/tests/test_bench_control.py -q
"""

import time

import pytest

from benchmark import checks, run, spec
from conftest import SEED, measure, tiny


def test_env_control_fails():
    cell = tiny("envstep.obs")
    rec = measure(cell, controls=True)
    ok, _ = checks.judge(rec["controls"]["bf16"], cell.limits)
    assert not ok


@pytest.mark.cuda
def test_training_control_fails(cuda):
    cell = spec.load_cell("solo_tpu.train")
    rec = run.measure(cell, SEED, 1.0, False, cuda, time.perf_counter(),
                      controls=True)
    ok, _ = checks.judge(rec["numbers"], cell.limits)
    assert ok
    tf32 = dict(rec["controls"]["tf32"])
    ok, _ = checks.judge(tf32, cell.limits)
    assert not ok
