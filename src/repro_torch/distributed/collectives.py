"""Collective helpers (port of repro/distributed/collectives.py:
`int8_quantize` :22, `int8_dequantize` :28, `compressed_psum` :32,
`cross_pod_grad_reduce` :49), plus the autograd-aware collectives the
model code's mesh branches use: one home for every collective the mesh
forwards run, each with its backward rule (f / g, gather / piece or
reduce-scatter, reduce-scatter / gather, all-to-all / its inverse,
broadcast / the owner's gradient), which is what GSPMD's transpose of
the reference's program computes.

On a (pod, data, model) mesh the gradient all-reduce splits into a cheap
reduce within a pod and an expensive one across pods. `compressed_psum`
quantizes only the cross-pod hop: int8 with one scale per tensor and
round-half-even rounding (as `jnp.round`); the error-feedback residual
lives in the optimizer state (training/optimizer.py), so the
quantization bias cancels over steps.

Each process group of size 1 is skipped outright by the functions here
(the Functions themselves run on any group): a one-device mesh computes
exactly what the unsharded code computes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def int8_quantize(x: torch.Tensor):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _size(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of `x` over `group` (no autograd); `x` itself when
    the group is a single rank."""
    if _size(group) == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def compressed_psum(x: torch.Tensor, group, method: str = "int8") -> torch.Tensor:
    """Sum of `x` over `group` with a compressed wire format. int8: each
    rank contributes its quantize round trip (4x fewer wire bytes than
    fp32); bf16: cast, reduce, cast back; anything else: a plain sum."""
    if method == "bf16":
        return all_reduce(x.to(torch.bfloat16), group).to(x.dtype)
    if method == "int8":
        q, scale = int8_quantize(x.float())
        return all_reduce(int8_dequantize(q, scale), group).to(x.dtype)
    return all_reduce(x, group)


def cross_pod_grad_reduce(grads, mesh, method: str = "int8"):
    """The mean of every gradient leaf over the mesh's "pod" dim, with the
    compressed wire format; the identity on a mesh without one. Leaves
    are plain tensors (each rank's own)."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if "pod" not in names:
        return grads
    group = mesh.get_group("pod")
    n = dict(zip(names, tuple(mesh.shape)))["pod"]
    return tree_map(lambda g: compressed_psum(g / n, group, method), grads)


# ------------------------------------------------ autograd-aware collectives
# Each Function below is one collective with its backward rule. Their
# backward passes run their collective on every rank whatever the
# gradient holds (zeros included), so every rank issues the same
# collectives in the same order. They run on any group, one rank
# included; the wrappers `copy_to_group`, `reduce_from_group` and
# `gather_dim` skip a one-rank group, as this module's other functions
# do, and distributed/tensor_parallel.py calls the Functions themselves.
def _reduced(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _gathered(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Every rank's `x` joined along `dim`, in group order."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _scattered(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The sum over the group of `x`, this rank's 1/n of it along `dim`."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


class CopyToGroup(torch.autograd.Function):
    """Megatron's f. Forward: the identity (`x` whole on every rank).
    Backward: the gradient summed over the group (each rank computed a
    part of it in rank-specific compute)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """Megatron's g. Forward: the sum over the group of each rank's
    partial result. Backward: the identity (every rank holds the whole
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class ReduceCopy(torch.autograd.Function):
    """g then f: partial results summed over the group into a tensor that
    only rank-specific compute reads. Both passes sum over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class GatherDim(torch.autograd.Function):
    """Forward: the n ranks' pieces joined along `dim` in group order.
    Backward: this rank's piece (index `idx`) of the gradient, which is
    whole on every rank; or, with `reduce`, the sum over the group of the
    gradients, each rank's differing (the rows an FSDP weight met there),
    scattered back to the pieces: a reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group, n, idx, dim, reduce=False):
        ctx.group, ctx.n, ctx.idx, ctx.dim, ctx.reduce = group, n, idx, dim, reduce
        return _gathered(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            gx = _scattered(g, ctx.group, ctx.n, ctx.dim)
        else:
            step = g.shape[ctx.dim] // ctx.n
            gx = g.narrow(ctx.dim, ctx.idx * step, step)
        return gx, None, None, None, None, None


class ReduceScatter(torch.autograd.Function):
    """Forward: the sum over the group of x, this rank's 1/n of it along
    `dim`. Backward: the gradients of every rank's part gathered."""

    @staticmethod
    def forward(ctx, x, group, n, dim=0):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _scattered(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.group, ctx.n, ctx.dim), None, None, None


class AllToAll(torch.autograd.Function):
    """Forward: one all-to-all of x's rows (`send[r]` rows to rank r,
    `recv[r]` from it; None: equal splits). Backward: the inverse
    all-to-all, send and receive counts swapped."""

    @staticmethod
    def forward(ctx, x, group, recv=None, send=None):
        ctx.group, ctx.recv, ctx.send = group, recv, send
        return _exchange(x, group, recv, send)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.send, ctx.recv), None, None, None


def _exchange(x: torch.Tensor, group, recv, send) -> torch.Tensor:
    x = x.contiguous()
    rows = x.shape[0] if recv is None else sum(recv)
    out = x.new_empty((rows, *x.shape[1:]))
    dist.all_to_all_single(out, x, recv, send, group=group)
    return out


class Broadcast(torch.autograd.Function):
    """Forward: `x` of the group's rank `src` (a global rank) on every
    rank. Backward: the owner's own gradient, zeros elsewhere: every rank
    computes with the broadcast tensor whole, as the same replicated
    compute, so its gradient is whole and equal on every rank and counts
    once, at the owner."""

    @staticmethod
    def forward(ctx, x, group, src):
        ctx.owner = dist.get_rank() == src
        out = x.clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.owner else torch.zeros_like(g)), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else ReduceFromGroup.apply(x, group)


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' pieces joined along `dim` (backward: this rank's piece)."""
    n = _size(group)
    return x if n == 1 else GatherDim.apply(x, group, n, dist.get_rank(group), dim)


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: every rank's `x` in group order (no autograd)."""
    n = _size(group)
    return x[None] if n == 1 else _gathered(x[None], group, n, 0)
