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

Observability: `set_kernel_tracer` installs a process-global
`repro_torch.obs.Tracer`; op wrappers bracket each call with
`kernel_span`. Unlike the JAX package (where the span runs once per
trace), the port runs eagerly, so the span brackets every call.
"""
from __future__ import annotations

import torch

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


def use_kernel(choice: str, t: torch.Tensor, *, op: str = "kernel") -> bool:
    """True when `op` must launch its CUDA kernel on tensor `t`, False
    when it runs its plain PyTorch version. Raises where the choice
    cannot be honored (a CPU tensor under "cuda", a non-Hopper card)."""
    resolve_backend(choice)
    if choice == "ref":
        return False
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
# Process-global kernel tracer, installed by repro_torch.obs.resolve_obs
# whenever a stack resolves with tracing enabled (the last one wins).
_KERNEL_TRACER = None


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def set_kernel_tracer(tracer) -> None:
    """Install (or clear, with None) the tracer `kernel_span` emits to."""
    global _KERNEL_TRACER
    _KERNEL_TRACER = tracer


def kernel_span(op: str, kind: str):
    """Span `kernel.<op>` with the resolved kind ("cuda" | "ref") around
    one op-wrapper call, on the installed tracer (no-op when off)."""
    tr = _KERNEL_TRACER
    if tr is None or not tr.enabled:
        return _NULL_SPAN
    return tr.span(f"kernel.{op}", cat="kernel", backend=kind)
