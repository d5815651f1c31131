"""Build and load the port's CUDA kernels (route (b): nvcc -> a shared
library with a plain C interface, bound with ctypes).

Every `csrc/*.cu` source compiles on first use, one `nvcc` process per
source, all started together, into `src/repro_torch/_build/` (listed in
.gitignore). A library is named by a hash of its source and flags, so an
edited source rebuilds and an unchanged one is reused within a checkout.
Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("paged_attention", "moe_gemm", "expert_gemv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of the last build, per source
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ on the machine with the card"
    )


def _lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no up-to-date library (in parallel)
    and load all of them. Raises with nvcc's output if a build fails."""
    missing = [n for n in SOURCES if n not in _LIBS]
    if not missing:
        return _LIBS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for name in missing:
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building all on first use."""
    return build_all()[name]


def check(err: int, op: str) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel's C entry."""
    if err != 0:
        raise RuntimeError(f"{op}: CUDA launch failed with cudaError_t {err}")
