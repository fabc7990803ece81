"""A/B readings of the env-only rollout kernel (csrc/env_rollout.cu).

    python -m acas2d_tpu_torch.env_ab [--variants no_trig no_div ...]
        [--source parent=path/to/csrc ...]

Builds the package's source ("kernel"), each named variant of it (the
package's env_rollout.cu and step_math.cuh with one part taken out or
changed by a text edit) and each other source directory given (a parent
commit's csrc/, unpacked with `git archive`: its env_rollout.cu is compiled
against its own step_math.cuh), with `ab.build`, one nvcc each, all at
once.  Then, at the bench's headline shape (B = 262,144 envs, T = 256
steps a launch, seed 7), from a state the package's kernel flew 1,024 steps
from the bench's spawns, so that episodes end every step:

- every build's outputs against those of the package's build and of each
  other source, bit for bit, in the three modes of chip_smoke.py's env
  phase (random actions without and with obs, zero actions with obs): the
  count of differing envs and the largest difference per field (a variant
  that takes a part out differs; an exact rewrite does not);
- one launch of each build, without and with obs, timed with CUDA events
  while the card works through launches queued behind a sleep (as
  chip_smoke.py:chain), in turns: every build forward, then backward,
  twice (a, b, b, a) (`ab.time_turn`);
- each build's instructions from `cuobjdump -sass`, by kind, in the whole
  kernel and in its T-step loop (`env_rollout.sass_census`), and, where the
  build has the entry point, its registers, local memory and blocks an SM.

It prints one JSON line: the card's name and power limit, its SM clocks
and SM count, and the readings.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from acas2d_tpu_torch.ab import build, smi, source_dirs, time_turn
from acas2d_tpu_torch.bench import SEED
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.envs import vector
from acas2d_tpu_torch.ops import env_rollout
from acas2d_tpu_torch.ops import step_math as sm

FILES = ("env_rollout.cu", "step_math.cuh")
_TRIG = "using Trig = acas::BoundedTrig;"
# variant: [(file, old text, new text)] edits of the package's sources,
# every occurrence replaced; each must occur
VARIANTS = {
    # the IEEE sinf / cosf in the loop (the exact rewrites alone)
    "ieee_trig": [("env_rollout.cu", _TRIG, "using Trig = acas::IeeeTrig;")],
    # no trig: the loop's sines and cosines a multiply-add of the argument
    "no_trig": [("env_rollout.cu", _TRIG, """struct CheapTrig {
  static __device__ __forceinline__ float sin(float x) { return 0.5f * x; }
  static __device__ __forceinline__ void sincos(float x, float* s,
                                                float* c) {
    *s = 0.5f * x;
    *c = 1.0f - 0.5f * x;
  }
};
using Trig = CheapTrig;""")],
    # the arctan's divide a product
    "no_div": [("step_math.cuh", "float xr = num / den;",
                "float xr = num * den;")],
    # a respawned lane observes the reward's geometry, like the others
    "no_obs_geometry": [("env_rollout.cu",
                         "      if (done) {\n        float cp2",
                         "      if (false) {\n        float cp2")],
    # no respawn: an ended episode flies on
    "no_respawn": [("env_rollout.cu",
                    "    if (done) {\n      const float rb_psi",
                    "    if (false) {\n      const float rb_psi")],
    # no minimum of blocks an SM: ptxas picks the registers
    "no_min_blocks": [("env_rollout.cu",
                       "__launch_bounds__(THREADS, MIN_BLOCKS)",
                       "__launch_bounds__(THREADS)")],
}
MODES = {"random": dict(zero_actions=False, with_obs=False),
         "random obs": dict(zero_actions=False, with_obs=True),
         "zero obs": dict(zero_actions=True, with_obs=True)}
B, T, FLOWN = 262144, 256, 1024
CHAIN = 8                 # timed launches a turn


def flown_state() -> Dict[str, torch.Tensor]:
    """The bench's spawns on the card flown FLOWN steps by the package's
    kernel."""
    gen = torch.Generator().manual_seed(0)
    es, _ = vector.reset_batch(B, DEFAULT_PARAMS, gen, torch.float32, "cuda")
    st = env_rollout.flat_state(es)
    for _ in range(FLOWN // T):
        st, _ = env_rollout.fused_rollout(st, SEED, T)
    return st


def differing(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
              ) -> Dict[str, Tuple[int, float]]:
    """{field: (envs whose bits differ, the largest difference)}, for each
    field that differs."""
    out = {}
    for k, v in got.items():
        bad = v.view(torch.int32) != want[k].view(torch.int32)
        if bool(bad.any()):
            d = (v[bad].double() - want[k][bad].double()).abs()
            out[k] = (int(bad.sum()), float(d.max()))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--variants", nargs="*", default=list(VARIANTS),
                   choices=list(VARIANTS))
    p.add_argument("--source", nargs="*", default=[], metavar="NAME=DIR",
                   help="another csrc/ directory with the same C interface")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("env_ab: CUDA is not available", file=sys.stderr)
        return 1
    others = {}
    for spec in args.source:
        name, path = spec.split("=", 1)
        others[name] = Path(path).resolve()
    dirs = source_dirs("env", FILES, VARIANTS, args.variants, others)
    libs = build("env_rollout.cu", dirs, "env")
    consts = sm.kernel_constants(DEFAULT_PARAMS)
    st = flown_state()

    def run(name, mode):
        return env_rollout._env_rollout_cuda(
            consts, DEFAULT_PARAMS.max_steps, st, SEED, T, lib=libs[name],
            **MODES[mode])

    outs = {n: {} for n in libs}
    for name in libs:
        for mode in MODES:
            final, stats = run(name, mode)
            outs[name][mode] = {**final, **stats}
    torch.cuda.synchronize()
    ends = {m: {k: int(outs["kernel"][m][k].sum())
                for k in ("episodes", "goals", "collisions")} for m in MODES}
    bits = {ref: {n: {m: differing(outs[n][m], outs[ref][m]) for m in MODES}
                  for n in libs if n != ref}
            for ref in ["kernel", *others]}
    del outs
    order = list(libs) + list(libs)[::-1]
    ms: Dict[str, Dict[str, List[float]]] = {n: {} for n in libs}
    for _ in range(2):
        for name in order:
            for mode in ("random", "random obs"):
                ms[name].setdefault(mode, []).append(
                    time_turn(lambda: run(name, mode), CHAIN))
    clocks = smi("clocks.sm,clocks.max.sm")     # as the timed launches end
    census = {}
    for name, lib in libs.items():
        c = env_rollout.sass_census(Path(lib._name))
        census[name] = {m: c[(o["zero_actions"], o["with_obs"])]
                        for m, o in MODES.items()}
        if hasattr(lib, "acas_env_rollout_attrs"):
            for m, o in MODES.items():
                census[name][m]["attrs"] = env_rollout.kernel_attrs(
                    o["zero_actions"], o["with_obs"], lib)
    print(json.dumps({
        "device": smi("name,power.limit"),
        "clocks_mhz": clocks,
        "sms": torch.cuda.get_device_properties(0).multi_processor_count,
        "shape": {"B": B, "T": T, "flown": FLOWN, "episode_ends": ends},
        "ms": ms, "bits_differing": bits, "census": census}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
