"""Collective helpers (port of repro/distributed/collectives.py:
`int8_quantize` :22, `int8_dequantize` :28, `compressed_psum` :32,
`cross_pod_grad_reduce` :49), plus the autograd-aware collectives the
model code's mesh branches use.

On a (pod, data, model) mesh the gradient all-reduce splits into a cheap
reduce within a pod and an expensive one across pods. `compressed_psum`
quantizes only the cross-pod hop: int8 with one scale per tensor and
round-half-even rounding (as `jnp.round`); the error-feedback residual
lives in the optimizer state (training/optimizer.py), so the
quantization bias cancels over steps.

Each process group of size 1 is skipped outright: a one-device mesh
computes exactly what the unsharded code computes.
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
class _CopyToGroup(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient summed over the
    group (each rank computed a part of it from the same input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Forward: the sum over the group of each rank's partial result.
    Backward: the identity (every rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDim(torch.autograd.Function):
    """Forward: the ranks' pieces joined along `dim` in group order.
    Backward: this rank's piece of the (identical) gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.n = dist.get_rank(group), _size(group)
        parts = [torch.empty_like(x) for _ in range(ctx.n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.rank], None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _ReduceFromGroup.apply(x, group)


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if _size(group) == 1 else _GatherDim.apply(x, group, dim)


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: every rank's `x` in group order (no autograd)."""
    if _size(group) == 1:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


class _GatherShards(torch.autograd.Function):
    """Forward: a leaf's shards gathered over the mesh dims `places`
    shards it on (innermost dim first). Backward: the gradients of the
    ranks that computed on other batch rows summed over `dp`, then this
    rank's chunk of the sum."""

    @staticmethod
    def forward(ctx, local, mesh, places, dp):
        ctx.mesh, ctx.places, ctx.dp = mesh, places, dp
        out = local
        for i in reversed(range(len(places))):
            if places[i].is_shard():
                out = _gather(out, mesh.get_group(i), places[i].dim)
        return out

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed.sharding import local_chunk

        g = all_reduce(g.contiguous(), ctx.dp)
        return local_chunk(g, ctx.mesh, ctx.places).contiguous(), None, None, None


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    if _size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def gather_shards(local: torch.Tensor, mesh, places, dp) -> torch.Tensor:
    """The full tensor of which `local` is this rank's shard under `places`
    (mesh dims to leave sharded given as Replicate), differentiable: its
    gradient is reduced over the DP group `dp` back to the shard."""
    return _GatherShards.apply(local, mesh, places, dp)
