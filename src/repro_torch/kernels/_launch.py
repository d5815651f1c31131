"""Helpers shared by the kernel wrappers: ctypes arguments and checks."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.backend import is_fake  # noqa: F401 (the wrappers' L.is_fake)

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# dynamic shared memory one block may use on an H100 (232,448 bytes)
MAX_SMEM = 232448
# bytes: the granule of a TMA tensor map's base address and strides
TMA_ALIGN = 16


# FLOPs of the kernel launches a fake-tensor trace stood in for: the
# kernels are not aten ops, so FlopCounterMode cannot see them
TRACE_FLOPS = {"flops": 0}


def trace_launch(flops: int, *shape, like: torch.Tensor) -> torch.Tensor:
    """A kernel launch in a fake-tensor trace: its output (fake, `like`'s
    dtype and device) and its FLOPs counted, nothing run."""
    TRACE_FLOPS["flops"] += int(flops)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def device_index(t: torch.Tensor) -> int:
    """The index of the CUDA device a tensor lies on (a CUDA tensor's
    device always carries it)."""
    return t.device.index


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def dtype_code(t: torch.Tensor, op: str) -> int:
    if t.dtype not in DTYPE_CODE:
        raise TypeError(f"{op}: dtype {t.dtype} not supported (float32 or bfloat16)")
    return DTYPE_CODE[t.dtype]


def require(cond: bool, op: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{op}: {what}")


def same_device(op: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts[1:]:
        require(t.device == dev, op, f"tensors on {dev} and {t.device}")
