"""What the A/B tools (`env_ab`, `grads_ab`, `policy_ab`) share: building
a kernel source, its variants and other source directories side by side
with nvcc, and timing launches on the card in turns.

A variant is the package's sources with one part taken out or changed by
text edits, [(file, old text, new text)], every occurrence replaced; each
edit must match, so a later edit of the sources cannot silently turn a
variant into the kernel itself.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

from acas2d_tpu_torch.ops import _cuda

Edits = List[Tuple[str, str, str]]


def variant_files(files: Dict[str, str], edits: Edits) -> Dict[str, str]:
    """The sources {file name: text} with the edits applied."""
    files = dict(files)
    for name, old, new in edits:
        if old not in files[name]:
            raise ValueError(f"variant edit of {name} {old!r} matches "
                             f"nothing")
        files[name] = files[name].replace(old, new)
    return files


def source_dirs(prefix: str, files: Iterable[str], table: Dict[str, Edits],
                variants: Iterable[str], others: Dict[str, Path]
                ) -> Dict[str, Path]:
    """{build name: directory holding its sources}: the package's csrc/
    ("kernel"), each variant of table written under `_build/ab/<prefix>-
    <variant>/`, and the other directories."""
    base = {f: (_cuda.CSRC / f).read_text() for f in files}
    dirs = {"kernel": _cuda.CSRC}
    for v in variants:
        d = _cuda.BUILD_DIR / "ab" / f"{prefix}-{v}"
        d.mkdir(parents=True, exist_ok=True)
        for f, text in variant_files(base, table[v]).items():
            (d / f).write_text(text)
        dirs[v] = d
    dirs.update(others)
    return dirs


def build(main: str, dirs: Dict[str, Path], prefix: str
          ) -> Dict[str, ctypes.CDLL]:
    """`nvcc` of each directory's `main` source against its own headers,
    one each, all at once, into `_build/ab/lib<prefix>-<name>.so` (with
    the compiler's output beside it, `.log`): {name: loaded library}."""
    out_dir = _cuda.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, d in dirs.items():
        lib = out_dir / f"lib{prefix}-{name}.so"
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(d),
               "-o", str(lib), str(d / main)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {prefix}-{name} exited "
                               f"{proc.returncode}:\n{log}")
        lib.with_suffix(".log").write_text(log)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def time_turn(run, chain: int) -> float:
    """Mean ms of `chain` launches of `run` that queue behind a sleep of
    the card, each between its own CUDA events, so that they time the
    kernel and not the host."""
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(chain)]
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    for e0, e1 in events:
        e0.record()
        run()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in events) / chain


def smi(query: str) -> str:
    """`nvidia-smi --query-gpu=<query>` of the first card."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
