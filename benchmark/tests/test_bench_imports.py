"""Nothing the harness runs loads JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's)."""

import subprocess
import sys

from conftest import ROOT

PROBE = r"""
import sys, time, torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import measure, tiny
from benchmark import run
for name in ("envstep.obs", "solo_tpu.train"):
    measure(tiny(name), seconds=0.2)
print(",".join(run.forbidden_modules()) or "none")
"""


def test_no_jax_in_a_run():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT),
                                            tests=str(ROOT / "benchmark"
                                                      / "tests"))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "none"


def test_forbidden_by_whole_name(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "acas2d_tpu_torch_x", sys)
    assert "acas2d_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "acas2d_tpu.envs", sys)
    assert "acas2d_tpu" in run.forbidden_modules()
