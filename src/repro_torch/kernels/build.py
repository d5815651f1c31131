"""Build and load the port's CUDA kernels (route (b): nvcc -> a shared
library with a plain C interface, bound with ctypes).

Every `csrc/*.cu` source compiles on first use, one `nvcc` process per
source, all started together, into `src/repro_torch/_build/` (listed in
.gitignore). A library is named by a hash of its source, every shared
header `csrc/*.cuh` and the flags, so an edited source or header
rebuilds and an unchanged one is reused within a checkout.
`count_mma` counts a built library's tensor-core instructions (wgmma
and mma.sync) with `cuobjdump`. Nothing here runs at import time: the
CPU tests import every module of the port on a machine with no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("paged_attention", "paged_attention_mla", "moe_gemm", "expert_gemv",
           "flash_attention")
# the code a C entry returns, plus the CUresult, for a tensor map that
# cuTensorMapEncodeTiled refused (hopper_mma.cuh's kErrTensorMap)
ERR_TENSOR_MAP = 10000
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    f"-DERR_TENSOR_MAP={ERR_TENSOR_MAP}",
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


def cuobjdump() -> Optional[str]:
    """The toolkit's cuobjdump (beside nvcc), else Triton's copy, else None."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    try:
        cand = Path(_nvcc()).parent / "cuobjdump"
        if cand.exists():
            return str(cand)
    except RuntimeError:
        pass
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cand = Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
        if cand.exists():
            return str(cand)
    return None


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def count_mma(tool: str, name: str) -> Dict[str, int]:
    """Tensor-core instructions in the SASS of the built library of
    `csrc/<name>.cu`, read with the cuobjdump at `tool`: HGMMA (warpgroup
    wgmma) and HMMA (warp mma.sync)."""
    sass = subprocess.run([tool, "-sass", str(_lib_path(name))], capture_output=True,
                          text=True, check=True).stdout.splitlines()
    return {op: sum(op in line for line in sass) for op in ("HGMMA", "HMMA")}


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
    """Raise on a nonzero code returned by a kernel's C entry: a
    cudaError_t, or ERR_TENSOR_MAP + the CUresult of a refused tensor map."""
    if err >= ERR_TENSOR_MAP:
        raise RuntimeError(f"{op}: cuTensorMapEncodeTiled failed with CUresult "
                           f"{err - ERR_TENSOR_MAP}")
    if err != 0:
        raise RuntimeError(f"{op}: CUDA launch failed with cudaError_t {err}")
