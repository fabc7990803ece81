"""A/B timing of the PPO-gradient kernel (csrc/ppo_grads.cu) on the card.

    python -m acas2d_tpu_torch.grads_ab [--variants no_mma no_tanh ...]
        [--source parent=path/to/csrc ...]

Builds the package's source ("kernel"), each named variant of it (the
package's ppo_grads.cu and tf32x3.cuh with one part taken out by a text
edit: its results are wrong, only its time counts) and each other source
directory given (a parent commit's csrc/, say: its ppo_grads.cu against its
own headers), into its own library under `_build/ab/`, one nvcc each, all
at once (`ab.build`).  Then it times one launch (both passes) of each at
the main-path shapes, solo (N = 65,536) and P = 32 members (N = 32,768
each), f32 and bf16, with CUDA events, in turns: every build forward, then
backward, twice (a, b, b, a).  It prints one JSON line: the card's name and
power limit, per build and setting the ms of each turn, and per build each
first pass's SASS instructions counted by opcode (`cuobjdump -sass`).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path
from typing import Dict, List

import torch

from acas2d_tpu_torch.ab import build, smi, source_dirs
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ops import _cuda, ppo_grads

FILES = ("ppo_grads.cu", "tf32x3.cuh", "wgmma_tf32.cuh")
# variant: [(file, old text, new text)] edits of the package's sources
VARIANTS = {
    # no mma.sync product (the bf16 pass's): the instructions are skipped
    "no_mma": [("ppo_grads.cu", 'asm("mma.sync', 'if (0) asm("mma.sync'),
               ("tf32x3.cuh", 'asm("mma.sync', 'if (0) asm("mma.sync')],
    # no warpgroup product (the f32 pass's): the wgmma.mma_async
    # instructions are skipped
    "no_wgmma": [("wgmma_tf32.cuh", '"wgmma.mma_async',
                  '"// wgmma.mma_async')],
    # no ldmatrix: fragments are a lane's id
    "no_ldmatrix": [("ppo_grads.cu", 'asm volatile("ldmatrix',
                     'for (auto& x : r) x = threadIdx.x;\n  '
                     'if (0) asm volatile("ldmatrix')],
    # no tanhf: h = the pre-activation
    "no_tanh": [("ppo_grads.cu", "tanhf(", "(")],
    # no named barriers between the two warps of a row tile
    "no_pair_sync": [("ppo_grads.cu", 'asm volatile("bar.sync',
                      'if (0) asm volatile("bar.sync')],
    # no bf16 copies written: the products read whatever the copies hold
    "no_bf16_copies": [
        ("ppo_grads.cu", "e2b[(t0 + r) * LDB + col] =",
         "if (0) e2b[(t0 + r) * LDB + col] ="),
        ("ppo_grads.cu", "e1b[(t0 + r) * LDB + col] =",
         "if (0) e1b[(t0 + r) * LDB + col] ="),
        ("ppo_grads.cu", "store_c<true>(h1", "store_c(h1")],
}
SHAPES = {"solo": (1, 65536), "members": (32, 32768)}


def operands(P: int, n: int, seed: int = 0):
    """P members' random policies and normalised minibatches on the card,
    as `_grads_cuda` takes them."""
    gen = torch.Generator().manual_seed(seed)
    params = torch.stack([flatten(ActorCritic(generator=gen))
                          for _ in range(P)])
    data = torch.randn(P, n, ppo_grads.N_COLS, generator=gen) * 0.5
    data = ppo_grads.normalize_adv_column(data)
    return (params.cuda(), data.cuda().contiguous(),
            ppo_grads._constants(n, 0.2, 0.5), 0.0)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--variants", nargs="*", default=list(VARIANTS),
                   choices=list(VARIANTS))
    p.add_argument("--source", nargs="*", default=[], metavar="NAME=DIR",
                   help="another csrc/ directory whose ppo_grads.cu has the "
                        "same C interface")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("grads_ab: CUDA is not available", file=sys.stderr)
        return 1
    others = {}
    for spec in args.source:
        name, path = spec.split("=", 1)
        others[name] = Path(path).resolve()
    libs = build("ppo_grads.cu", source_dirs(
        "grads", FILES, VARIANTS, args.variants, others), "grads")
    ops = {shape: operands(*pn) for shape, pn in SHAPES.items()}
    order = list(libs) + list(libs)[::-1]
    ms: Dict[str, Dict[str, List[float]]] = {name: {} for name in libs}
    for _ in range(2):
        for name in order:
            for shape, args_ in ops.items():
                for bf16 in (False, True):
                    key = f"{shape} {'bf16' if bf16 else 'f32'}"
                    ms[name].setdefault(key, []).append(time_ms(
                        lambda: ppo_grads._grads_cuda(*args_, bf16=bf16,
                                                      lib=libs[name])))
    census = {}
    for name, lib in libs.items():
        listing = _cuda.sass_listing(Path(lib._name))
        census[name] = {
            k: dict(Counter(op for _, op, _ in v))
            for k, v in listing.items() if "grad_partials_" in k}
    print(json.dumps({"device": smi("name,power.limit"), "ms": ms,
                      "census": census}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
