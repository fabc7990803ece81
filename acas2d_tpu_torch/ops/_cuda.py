"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface, at first use, into `acas2d_tpu_torch/_build/`
(listed in .gitignore).  Missing libraries are built in parallel, one `nvcc`
per source.  A library's file name carries a digest of its sources and flags,
so an edited source is rebuilt.  Nothing here runs at import time, and
nothing falls back: a missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("policy_rollout", "ppo_grads", "env_rollout", "precision_probe",
           "phase_mark", "greedy_step")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Dict[str, object]]:
    """Compile every listed library that is missing, all at once.  Returns
    the build seconds and compiler output of each library it built."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    info, failed = {}, []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        info[n] = {"seconds": time.perf_counter() - t0, "log": out}
        if proc.returncode != 0:
            failed.append(f"nvcc {n}.cu exited {proc.returncode}:\n{out}")
            continue
        lib_path(n).with_suffix(".log").write_text(out)
        os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("\n".join(failed))
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu.  Where it is missing, every
    missing library is built first (in parallel)."""
    lib = _LIBS.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build()
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


_PTXAS_FN = re.compile(r"Function properties for (\S+)")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")


def ptxas_frames(log: str) -> Dict[str, Tuple[int, int, int]]:
    """`nvcc -Xptxas -v` output -> {mangled function name: (stack frame
    bytes, spill store bytes, spill load bytes)} a thread."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            cur = m.group(1)
            continue
        m = _PTXAS_FRAME.search(line)
        if m and cur:
            out[cur] = tuple(int(v) for v in m.groups())
            cur = None
    return out


def build_log(name: str) -> str:
    """The compiler's output of the package's build of csrc/<name>.cu,
    written beside its library when it was built."""
    return lib_path(name).with_suffix(".log").read_text()


_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s*(.*)$")

Instr = Tuple[int, str, Optional[int]]


def parse_sass(text: str) -> Dict[str, List[Instr]]:
    """`cuobjdump -sass` output -> {mangled function name: [(address,
    opcode with its modifiers (predicate dropped), branch target or
    None)]}."""
    fns: Dict[str, List[Instr]] = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = fns.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = _SASS_LINE.match(line)
        if cur is None or not m:
            continue
        body = m.group(2).split(";")[0].split()
        if body and body[0].startswith("@"):
            body = body[1:]
        if not body:
            continue
        hexes = [t.rstrip(",") for t in body[1:] if t.startswith("0x")]
        target = (int(hexes[-1], 16) if body[0].startswith("BRA") and hexes
                  else None)
        cur.append((int(m.group(1), 16), body[0], target))
    return fns


def sass_listing(lib_file: Path) -> Dict[str, List[Instr]]:
    """`parse_sass` of `cuobjdump -sass` of a built library."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    return parse_sass(subprocess.run([tool, "-sass", str(lib_file)],
                                     capture_output=True, text=True,
                                     check=True).stdout)


def sass_ops(name: str, functions: Iterable[str]) -> Dict[str, Dict[str, int]]:
    """`cuobjdump -sass` of the built library of csrc/<name>.cu: for each
    of `functions` (a substring of a kernel's mangled name), its
    instructions counted by opcode (predicates dropped, modifiers kept,
    e.g. `HMMA.16816.F32.BF16`)."""
    ops: Dict[str, Dict[str, int]] = {f: {} for f in functions}
    for mangled, instrs in sass_listing(lib_path(name)).items():
        fn = next((f for f in ops if f in mangled), None)
        for _, op, _ in instrs if fn else ():
            ops[fn][op] = ops[fn].get(op, 0) + 1
    return ops


def check(rc: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        lib.acas_error_string.restype = ctypes.c_char_p
        lib.acas_error_string.argtypes = [ctypes.c_int]
        msg = lib.acas_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t, name: str, dtype, shape) -> None:
    """Check a kernel operand: CUDA, dtype, shape, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
