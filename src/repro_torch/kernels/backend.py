"""Kernel-backend selection for every kernel family of the port.

One rule, on the model of `repro/kernels/backend.py:resolve_backend`,
but keyed on the tensor's device instead of the JAX platform:

    "auto" -> the hand-written CUDA kernel for a CUDA tensor, the plain
              PyTorch version for a CPU tensor
    "cuda" -> always the CUDA kernel; a CPU tensor raises
    "ref"  -> always the plain PyTorch version (chip_smoke.py uses it to
              hold each kernel against its plain version on the card)

A CUDA tensor on a card that is not sm_90 raises: the kernels are built
for `sm_90a` only, and nothing falls back to the plain version behind
the caller's back.

Observability: the op layer brackets each call with `kernel_span`, on
the process-global tracer of `repro_torch.obs.trace` (installed by
`resolve_obs`; `set_kernel_tracer` is `install_tracer`), under the
reference's op names (`paged_decode_gqa`, `paged_prefill_gqa`,
`paged_decode_mla`, `paged_prefill_mla` in models/attention.py;
`grouped_expert_matmul`, `grouped_expert_ffn`, `cold_expert_ffn`, `mha`
in the kernels' ops.py), one span per op call, with the call's shape.
Unlike the JAX package (where the span runs once per trace), the port
runs eagerly, so the span brackets every call. The span's `backend` is
the kind the op's own `use_kernel` resolved inside it ("ref" when the op
ran its plain version without asking).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.obs.trace import NULL_SPAN, active_tracer, install_tracer

set_kernel_tracer = install_tracer  # the process-global slot, under its earlier name

__all__ = [
    "CHOICES",
    "kernel_span",
    "resolve_backend",
    "set_kernel_tracer",
    "use_kernel",
    "wants_grad",
]

CHOICES = ("auto", "cuda", "ref")


def resolve_backend(choice: str, *, knob: str = "backend") -> str:
    """Validate a config- or call-level choice string. `knob` names the
    config field in the error message."""
    if choice not in CHOICES:
        raise ValueError(f"unknown {knob} {choice!r}; expected one of {CHOICES}")
    return choice


def _check_card(device: torch.device) -> None:
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"the port's CUDA kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is sm_{major}{minor}"
        )


_TRACE_ROUTE = False  # inside `trace_kernel_route`


@contextlib.contextmanager
def trace_kernel_route():
    """Within, a fake tensor (a shape-only trace, launch/dryrun.py) takes
    the kernel route on any device, as the card's tensors do: each launch
    stands in as its output and FLOPs (kernels/_launch.py `trace_launch`).
    Real tensors are untouched."""
    global _TRACE_ROUTE
    prev, _TRACE_ROUTE = _TRACE_ROUTE, True
    try:
        yield
    finally:
        _TRACE_ROUTE = prev


def is_fake(t: torch.Tensor) -> bool:
    """Whether `t` is a fake tensor (shapes only, nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def use_kernel(choice: str, t: torch.Tensor, *, op: str = "kernel") -> bool:
    """True when `op` must launch its CUDA kernel on tensor `t`, False
    when it runs its plain PyTorch version. Raises where the choice
    cannot be honored (a CPU tensor under "cuda", a non-Hopper card)."""
    kernel = _resolve_kind(choice, t, op)
    if _OPEN_KERNEL_ARGS is not None:  # inside a kernel span: its backend
        _OPEN_KERNEL_ARGS["backend"] = "cuda" if kernel else "ref"
    return kernel


def _resolve_kind(choice: str, t: torch.Tensor, op: str) -> bool:
    resolve_backend(choice)
    if choice == "ref":
        return False
    if _TRACE_ROUTE and is_fake(t):
        return True
    if t.device.type == "cuda":
        _check_card(t.device)
        return True
    if choice == "cuda":
        raise RuntimeError(
            f"{op}: backend='cuda' needs CUDA tensors, got one on {t.device}"
        )
    return False


def wants_grad(*ts) -> bool:
    """Whether autograd records a call on these tensors: a kernel route
    then needs a gradient (moe_gemm has one; the expert GEMV raises)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# --------------------------------------------------------------- tracing
# the args of the innermost open kernel span, where `use_kernel` writes
# the kind it resolved (None while no kernel span is open)
_OPEN_KERNEL_ARGS = None


# what the leading dims of the tensor an op's span is given count
_SHAPE_DIMS = {
    "paged_decode_gqa": ("rows",), "paged_decode_mla": ("rows",),
    "paged_prefill_gqa": ("rows", "chunk"), "paged_prefill_mla": ("rows", "chunk"),
    "grouped_expert_matmul": ("rows",), "mha": ("rows", "chunk"),
    "grouped_expert_ffn": ("slots", "rows"), "cold_expert_ffn": ("slots", "rows"),
}


def kernel_span(op: str, t: torch.Tensor, tables: Optional[torch.Tensor] = None):
    """Span `kernel.<op>` around one op call on the installed tracer
    (NULL_SPAN when off). Args: the call's shape, read off `t` (`rows`,
    and `chunk` tokens a row or `slots` of an expert op, as `_SHAPE_DIMS`
    says) and a paged op's `tables` (`blocks`, the table width), and the
    `backend` ("cuda" | "ref") that the op's `use_kernel` resolves inside
    it."""
    tr = active_tracer()
    if tr is None:
        return NULL_SPAN
    shape = dict(zip(_SHAPE_DIMS[op], t.shape))
    if tables is not None:
        shape["blocks"] = tables.shape[1]
    return _KernelSpan(tr.span(f"kernel.{op}", cat="kernel", backend="ref", **shape))


class _KernelSpan:
    """A kernel span open as the innermost one, where `use_kernel`
    writes the kind it resolves."""

    __slots__ = ("span", "prev")

    def __init__(self, span):
        self.span = span

    def __enter__(self):
        global _OPEN_KERNEL_ARGS
        self.prev, _OPEN_KERNEL_ARGS = _OPEN_KERNEL_ARGS, self.span.args
        return self.span.__enter__()

    def __exit__(self, *exc):
        global _OPEN_KERNEL_ARGS
        _OPEN_KERNEL_ARGS = self.prev
        return self.span.__exit__(*exc)
