"""The port and chip_smoke.py import neither jax nor the JAX package: in a
fresh interpreter where importing `jax`, `flax`, `optax`, `acas2d_tpu`,
the JAX package's `scripts` or `pandas` (which the card's machine lacks)
fails, every module of acas2d_tpu_torch and chip_smoke import cleanly, and
importing them builds nothing and touches no device."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "acas2d_tpu", "scripts",
             "pandas"):
    sys.modules[name] = None          # any import of these now raises
import acas2d_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(acas2d_tpu_torch.__path__,
                                              "acas2d_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import acas2d_tpu_torch.ops._cuda as c
assert not c._LIBS
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "acas2d_tpu",
                                       "scripts", "pandas")
                and sys.modules[m] is not None)
assert not loaded, loaded
print(" ".join(mods))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    assert len(mods) >= 21                   # every module was imported
    for m in ("ppo.population", "ops.env_rollout", "ops.precision_probe",
              "bench", "utils.checkpoint", "utils.logging",
              "envs.telemetry", "utils.episode_csv", "best_selection",
              "population_merge", "pipeline", "parallel.mesh",
              "parallel.launch", "parallel.dryrun"):
        assert f"acas2d_tpu_torch.{m}" in mods, m
