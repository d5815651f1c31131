"""Helpers shared by the kernel wrappers: ctypes arguments and checks."""
from __future__ import annotations

import ctypes

import torch

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# dynamic shared memory one block may use on an H100 (232,448 bytes)
MAX_SMEM = 232448


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


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
