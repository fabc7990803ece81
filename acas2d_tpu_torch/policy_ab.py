"""A/B readings of the policy rollout kernel (csrc/policy_rollout.cu).

    python -m acas2d_tpu_torch.policy_ab [--variants onex_tf32 ...]
        [--source parent=path/to/csrc ...]

Builds the package's source ("kernel"), each named variant of it (the
package's policy_rollout.cu and headers with one part taken out by a text
edit: its results are wrong, only its time counts; or, `seed_by_value`,
with the seed a kernel argument again: the same bits) and each other source
directory given (a parent commit's csrc/, unpacked with `git archive`: its
policy_rollout.cu against its own headers), one nvcc each, all at once
(`ab.build`).  Then, at both main-path shapes (solo: P = 1, B = 2048;
members: P = 32, B = 1024; K = 16, chip_smoke.py's operands):

- every build's outputs against the plain version's on the CPU (the
  largest and the mean error of each float field, integer mismatches) and
  bit for bit against the package's build and each other source (the
  count of differing entries a field);
- the package's build again at other launch shapes (MT, W), whose outputs
  must equal its own launch shape's bit for bit, so their times show what
  the choice of `policy_rollout.launch_shape` gains, and at K = 0 and 1
  (its fixed cost and one step);
- one launch of each build and shape timed with CUDA events while the card
  works through launches queued behind a sleep, in turns: every build
  forward, then backward, twice (a, b, b, a) (`ab.time_turn`);
- each build's registers, stack frame and spills (ptxas), its instructions
  by kind (`policy_rollout.sass_census`) and, where the build has the
  entry point, its dynamic shared memory and blocks an SM at each shape.

A source whose entry point takes no launch shape (an earlier parent's) is
launched without one, and one that takes the seed as a value
(`policy_rollout.reads_seed`) with the seed's value.  It prints one JSON line: the card's name and power
limit, its SM clocks and SM count, and the readings.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from acas2d_tpu_torch.ab import build, smi, source_dirs, time_turn
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.envs import vector
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ops import _cuda, policy_rollout
from acas2d_tpu_torch.ops import step_math as sm

FILES = ("policy_rollout.cu", "tf32x3.cuh", "step_math.cuh")
# variant: [(file, old text, new text)] edits of the package's sources
VARIANTS = {
    # 1xTF32: hi * hi alone, the split's correction terms dropped
    "onex_tf32": [("tf32x3.cuh", "  mma(c, a.h, b.l);\n  mma(c, a.l, b.h);\n",
                   "")],
    # no tanhf: h = the pre-activation
    "no_tanh": [("policy_rollout.cu", "tanhf(", "(")],
    # no env step: the policy warp samples and steps nothing, so the
    # observations stay the first ones
    "no_env_step": [("policy_rollout.cu",
                     "if (stepper && active) {\n      EnvState v",
                     "if (false) {\n      EnvState v")],
    # the seed as a kernel argument, as before it was read from device
    # memory: the same bits, its time beside the kernel's
    "seed_by_value": [
        ("policy_rollout.cu", "int K, const int* __restrict__ seed,",
         "int K, uint32_t seed,"),
        ("policy_rollout.cu", "(uint32_t)__ldg(seed) * 0x9E3779B9u",
         "seed * 0x9E3779B9u"),
        ("policy_rollout.cu", "const int* seed, int step_offset, int",
         "int seed, int step_offset, int"),
        ("policy_rollout.cu",
         "int acas_policy_rollout_reads_seed(void) { return 1; }\n", "")],
}
SHAPES = {"solo": (1, 2048), "members": (32, 1024)}
# other launch shapes (MT, W) of the package's build, timed beside its own
OTHER_SHAPES = {"solo": [(1, 2), (2, 1)],
                "members": [(2, 2), (2, 8), (1, 4)]}
K = 16
SHORT_K = (0, 1)          # the package's build also timed at these K
CHAIN = 20                # timed launches a turn
FIELDS = ("st", "steps", "obs", "obs_buf", "fbuf", "ibuf")
BUFFERS = ("actions", "log_probs", "values", "rewards", "dones",
           "episode_return")
# The card check that tells 3xTF32 from 1xTF32 products (chip_smoke.py's
# rollout phases and tests/test_torch_cuda.py): the kernel's largest and
# mean absolute error against the plain version in the values and actions
# buffers, P x B x K entries each, at the main-path operands.  PARENT_ERR
# is the parent kernel's (float32 FMA chains on the CUDA cores, so
# summation order alone), the larger of its solo and member readings
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).  3xTF32 alone errs about
# as much at these operands (emulated on the CPU: values 3.3e-7 / 3.9e-7
# largest, 6e-8 mean), so SEPARATION leaves a factor of ~4 over the two
# added; 1xTF32 errs ~1000 times the parent's in the values (5e-4 / 4e-3
# largest, 1e-4 mean) and 11-40 times in the solo actions, whose head
# weights start 100 times smaller.
PARENT_ERR = {"values": (5.066394805908203e-07, 6.177026734555113e-08),
              "actions": (3.5762786865234375e-07, 1.73799244242742e-08)}
SEPARATION = 8.0


def separation_bounds() -> Dict[str, Tuple[float, float]]:
    """{field: (bound of the largest error, bound of the mean error)}."""
    return {k: (SEPARATION * m, SEPARATION * a)
            for k, (m, a) in PARENT_ERR.items()}


def operands(dev, P: int, B: int, k: int = K):
    """The kernel's operands for P members of B envs (chip_smoke.py's):
    each member its own weights (sigma ~0.6, so actions vary and clip),
    episodes part-way through, so that timeouts and respawns occur in K
    steps."""
    gen = torch.Generator().manual_seed(1)
    params = torch.stack([flatten(ActorCritic(generator=gen))
                          for _ in range(P)])
    params[:, -1] = -0.5
    es, obs = vector.reset_batch(P * B, DEFAULT_PARAMS, gen, torch.float32,
                                 "cpu")
    steps = torch.randint(1, DEFAULT_PARAMS.max_steps + 1, (P * B,),
                          generator=gen)
    st = torch.stack([es.px, es.py, es.ppsi, es.tx[:, 0], es.ty[:, 0],
                      es.tv[:, 0], es.tpsi[:, 0], es.total_reward])
    return (sm.kernel_constants(DEFAULT_PARAMS), DEFAULT_PARAMS.max_steps,
            st.to(dev).contiguous(), steps.to(dev, torch.int32),
            obs.to(dev).contiguous(), params.to(dev), 12345, 32, k)


def named(out) -> Dict[str, torch.Tensor]:
    """_rollout_cuda / _rollout_plain outputs by name, fbuf and ibuf by
    buffer."""
    d = dict(zip(FIELDS, out))
    d.update(zip(BUFFERS, d.pop("fbuf")))
    d.update(zip(("episode_steps", "outcome"), d.pop("ibuf")))
    return d


def errors(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
           ) -> Dict[str, Tuple[float, float]]:
    """{field: (largest, mean) absolute error} of the float fields and
    {field: (mismatches, 0)} of the integer ones, got on the card against
    want on the CPU."""
    out = {}
    for k, w in want.items():
        g = got[k].cpu()
        if torch.is_floating_point(w):
            d = (g.double() - w.double()).abs()
            out[k] = (float(d.max()), float(d.mean()))
        else:
            out[k] = (int((g != w).sum()), 0)
    return out


def separating(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
               ) -> Dict[str, Tuple[float, float, bool]]:
    """{field: (largest error, mean error, within separation_bounds())} of
    the values and actions buffers."""
    errs = errors({k: got[k] for k in PARENT_ERR},
                  {k: want[k] for k in PARENT_ERR})
    bounds = separation_bounds()
    return {k: (m, a, m <= bounds[k][0] and a <= bounds[k][1])
            for k, (m, a) in errs.items()}


def differing(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
              ) -> Dict[str, int]:
    """{field: entries whose bits differ}, for each field that differs."""
    out = {}
    for k, v in got.items():
        n = int((v.contiguous().view(torch.int32)
                 != want[k].contiguous().view(torch.int32)).sum())
        if n:
            out[k] = n
    return out


def takes_shape(lib) -> bool:
    """Whether a build's entry point takes the launch shape."""
    return hasattr(lib, "acas_policy_rollout_attrs")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--variants", nargs="*", default=list(VARIANTS),
                   choices=list(VARIANTS))
    p.add_argument("--source", nargs="*", default=[], metavar="NAME=DIR",
                   help="another csrc/ directory whose policy_rollout.cu has "
                        "the same C interface, with or without the launch "
                        "shape")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("policy_ab: CUDA is not available", file=sys.stderr)
        return 1
    others = {}
    for spec in args.source:
        name, path = spec.split("=", 1)
        others[name] = Path(path).resolve()
    libs = build("policy_rollout.cu", source_dirs(
        "policy", FILES, VARIANTS, args.variants, others), "policy")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    # (build, launch shape, K) entries of each main-path shape
    runs: Dict[str, Dict[str, Tuple[str, tuple, int]]] = {}
    ops = {}
    for tag, (P, B) in SHAPES.items():
        own = policy_rollout.launch_shape(P, B, sms)
        runs[tag] = {n: (n, own if takes_shape(lib) else (), K)
                     for n, lib in libs.items()}
        for s in OTHER_SHAPES[tag] if takes_shape(libs["kernel"]) else ():
            runs[tag][f"kernel {s[0]}x{s[1]}"] = ("kernel", s, K)
        for k in SHORT_K:
            runs[tag][f"kernel K={k}"] = ("kernel", runs[tag]["kernel"][1], k)
        ops[tag] = {k: operands("cuda", P, B, k) for k in (K, *SHORT_K)}

    errs, bits, sep = {}, {}, {}
    for tag in SHAPES:
        want = named(policy_rollout._rollout_plain(
            *(a.cpu() if torch.is_tensor(a) else a for a in ops[tag][K])))
        outs = {}
        for name, (lib, shape, k) in runs[tag].items():
            if k == K:
                outs[name] = named(policy_rollout._rollout_cuda(
                    *ops[tag][K], lib=libs[lib], shape=shape))
        torch.cuda.synchronize()
        errs[tag] = {n: errors(o, want) for n, o in outs.items()}
        sep[tag] = {n: separating(o, want) for n, o in outs.items()}
        bits[tag] = {ref: {n: differing(o, outs[ref])
                           for n, o in outs.items() if n != ref}
                     for ref in ["kernel", *others]}
        del outs, want

    ms: Dict[str, Dict[str, List[float]]] = {}
    for _ in range(2):
        for tag in SHAPES:
            order = list(runs[tag]) + list(runs[tag])[::-1]
            for name in order:
                lib, shape, k = runs[tag][name]
                ms.setdefault(tag, {}).setdefault(name, []).append(time_turn(
                    lambda: policy_rollout._rollout_cuda(
                        *ops[tag][k], lib=libs[lib], shape=shape), CHAIN))
    clocks = smi("clocks.sm,clocks.max.sm")     # as the timed launches end

    census = {}
    for name, lib in libs.items():
        lib_file = Path(lib._name)
        c = {"sass": policy_rollout.sass_census(lib_file),
             "ptxas": _cuda.ptxas_frames(
                 lib_file.with_suffix(".log").read_text())}
        if takes_shape(lib):
            shapes = {s for tag in SHAPES
                      for b, s, _ in runs[tag].values() if b == name}
            c["attrs"] = {f"{mt}x{w}": policy_rollout.kernel_attrs(mt, w, lib)
                          for mt, w in sorted(shapes)}
        census[name] = c
    print(json.dumps({
        "device": smi("name,power.limit"), "clocks_mhz": clocks, "sms": sms,
        "shapes": {tag: {"P": P, "B": B, "K": K,
                         "launch_shape": policy_rollout.launch_shape(P, B,
                                                                     sms)}
                   for tag, (P, B) in SHAPES.items()},
        "ms": ms, "errors": errs, "separating": sep,
        "bits_differing": bits, "census": census}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
