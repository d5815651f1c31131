"""AdamW with fp32 moments and an optional compressed-gradient path
(port of repro/training/optimizer.py).

Moments are fp32 whatever the parameter dtype. The compression settings
(bf16, or int8 with error feedback) emulate the numerics of a lossy
cross-host gradient reduce, as in the reference. The update is
functional like the reference's: it returns new parameter and state
trees and leaves its inputs as they were. Every step quantity (the
warm-up, beta ** step, the clip factor) is an fp32 tensor, so it rounds
as JAX's does, and the global norm sums its leaves in JAX's leaf order.
On a mesh (training/train_step.py) the update runs on each rank's
shards, with the norm and the int8 scale taken over the whole leaves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import all_reduce
from repro_torch.tree import leaves, tree_map

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # gradient compression of the cross-host reduce
    compression: str = "none"  # none | bf16 | int8_ef


def adamw_init(params: Params, cfg: AdamWConfig = AdamWConfig()) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    state = {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.compression == "int8_ef":
        state["ef"] = tree_map(zeros, params)  # error-feedback residual
    return state


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree, replicas=None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf. Over the shards of a
    mesh (`replicas`: a tree of how many ranks hold each element of each
    leaf, `group`: every rank of the mesh) each element counts once."""
    if replicas is None:
        return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in leaves(tree)))
    total = sum(torch.sum(torch.square(leaf.float())) / r
                for leaf, r in zip(leaves(tree), leaves(replicas)))
    return torch.sqrt(all_reduce(total, group))


def compress_grad(g: torch.Tensor, method: str, ef: Optional[torch.Tensor], group=None):
    """The lossy wire format of the cross-host reduce. Returns
    (decompressed grad, new error residual). int8 rounds half to even,
    as `jnp.round` does; its scale is the largest |g| of the whole leaf,
    taken over `group` when the leaf is sharded."""
    if method == "bf16":
        return g.to(torch.bfloat16).float(), ef
    if method == "int8_ef":
        gf = g.float() + (ef if ef is not None else 0.0)
        amax = all_reduce(torch.max(torch.abs(gf)), group, op=dist.ReduceOp.MAX)
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        deq = q * scale
        return deq, gf - deq
    return g.float(), ef


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: Dict[str, Any],
                 cfg: AdamWConfig = AdamWConfig(), *, replicas=None,
                 group=None) -> Tuple[Params, Dict[str, Any]]:
    """One AdamW step. On a mesh the leaves are this rank's shards:
    `replicas` and `group` (see `global_norm`) make the clip norm and the
    int8 scale those of the whole leaves."""
    step = state["step"] + 1
    lr = _schedule(cfg, step)
    gnorm = global_norm(grads, replicas, group)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    t = step.float()
    f32 = dict(dtype=torch.float32, device=t.device)
    bias1 = 1 - torch.tensor(cfg.beta1, **f32) ** t
    bias2 = 1 - torch.tensor(cfg.beta2, **f32) ** t
    efs = state.get("ef")

    def upd(p, g, m, v, ef=None):
        g, new_ef = compress_grad(g.float() * clip, cfg.compression, ef, group)
        m = cfg.beta1 * m + (1 - cfg.beta1) * g
        v = cfg.beta2 * v + (1 - cfg.beta2) * g * g
        mh = m / bias1
        vh = v / bias2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v, new_ef

    if efs is not None:
        out = tree_map(upd, params, grads, state["m"], state["v"], efs)
    else:
        out = tree_map(upd, params, grads, state["m"], state["v"])

    new_state = {"m": _unzip(out, 1), "v": _unzip(out, 2), "step": step}
    if efs is not None:
        new_state["ef"] = _unzip(out, 3)
    return _unzip(out, 0), new_state


def _unzip(tree, i: int):
    """Item i of every tuple leaf of a tree of tuples."""
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    return tree[i]
