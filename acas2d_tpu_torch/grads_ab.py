"""A/B timing of the PPO-gradient kernel (csrc/ppo_grads.cu) on the card.

    python -m acas2d_tpu_torch.grads_ab [--variants no_mma no_tanh ...]
        [--source parent=path/to/ppo_grads.cu ...]

Builds the package's source ("kernel"), each named variant of it (the
source with one part taken out by a text edit: its results are wrong, only
its time counts) and each other source given (a parent commit's, say),
into its own library under `_build/ab/`, one nvcc each, all at once.  Then
it times one launch (both passes) of each at the main-path shapes, solo
(N = 65,536) and P = 32 members (N = 32,768 each), f32 and bf16, with CUDA
events, in turns: every build forward, then backward, twice (a, b, b, a).
It prints one JSON line: the card's name and power limit and, per build
and setting, the ms of each turn.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ops import _cuda, ppo_grads

# variant: (old text, new text) edits of csrc/ppo_grads.cu, every
# occurrence replaced; each must occur
VARIANTS = {
    # no tensor-core product: the mma.sync instructions are skipped
    "no_mma": [('asm("mma.sync', 'if (0) asm("mma.sync')],
    # no ldmatrix: fragments are a lane's id
    "no_ldmatrix": [('asm volatile("ldmatrix',
                     'for (auto& x : r) x = threadIdx.x;\n  '
                     'if (0) asm volatile("ldmatrix')],
    # no tanhf: h = the pre-activation
    "no_tanh": [("tanhf(", "(")],
    # no named barriers between the two warps of a row tile
    "no_pair_sync": [('asm volatile("bar.sync',
                      'if (0) asm volatile("bar.sync')],
    # no bf16 copies written: the products read whatever the copies hold
    "no_bf16_copies": [
        ("if constexpr (BF16) e2b[", "if constexpr (false) e2b["),
        ("if constexpr (BF16) e1b[", "if constexpr (false) e1b["),
        ("store_c<BF16>(h1", "store_c(h1")],
}
SHAPES = {"solo": (1, 65536), "members": (32, 32768)}


def build(sources: Dict[str, str],
          include: Optional[Dict[str, Path]] = None
          ) -> Dict[str, ctypes.CDLL]:
    """{name: source text} -> {name: loaded library}, one nvcc each, all
    at once, under `_build/ab/`.  A source finds its headers in
    include[name], else in the package's csrc/."""
    out_dir = _cuda.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{name}.so"
        inc = (include or {}).get(name, _cuda.CSRC)
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(inc),
               "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} exited {proc.returncode}:"
                               f"\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def variant_source(base: str, edits: List[Tuple[str, str]]) -> str:
    for old, new in edits:
        if old not in base:
            raise ValueError(f"variant edit {old!r} matches nothing")
        base = base.replace(old, new)
    return base


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
    p.add_argument("--source", nargs="*", default=[], metavar="NAME=PATH",
                   help="another ppo_grads.cu with the same C interface")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("grads_ab: CUDA is not available", file=sys.stderr)
        return 1
    base = (_cuda.CSRC / "ppo_grads.cu").read_text()
    sources = {"kernel": base}
    sources.update({v: variant_source(base, VARIANTS[v])
                    for v in args.variants})
    for spec in args.source:
        name, path = spec.split("=", 1)
        with open(path) as f:
            sources[name] = f.read()
    libs = build(sources)
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
