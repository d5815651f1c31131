"""Training step (port of repro/training/train_step.py): cross entropy
plus the MoE aux loss, each layer group activation-checkpointed in
`forward_train`, optional microbatch gradient accumulation, AdamW.

Gradients come from `torch.autograd.grad` over detached copies of the
parameter leaves, so a step is a function of (params, opt_state, batch)
as the reference's is. On the card the MoE layers' grouped GEMMs, their
recompute and their dX products run the hand-written `moe_gemm` kernel
(kernels/moe_gemm/kernel.py); the reference cannot differentiate its
Pallas kernel and trains through its einsums.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import forward_train, init_params
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import leaves, tree_map, unflatten

Params = Any


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [B, S, V]; labels [B, S] int -> scalar mean CE (fp32)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - picked)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Any]):
    logits, aux, counts = forward_train(params, cfg, batch)
    ce = cross_entropy(logits, batch["labels"])
    return ce + aux, {"ce": ce, "aux": aux, "expert_counts": counts}


def value_and_grad(params: Params, cfg: ModelConfig, batch: Dict[str, Any]):
    """(loss, metrics, grads): `loss_fn` and its gradient with respect to
    every parameter leaf (zeros for a leaf the loss does not reach, as
    JAX gives), in the parameters' dtypes."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(tracked, cfg, batch)
        flat = leaves(tracked)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    metrics = {k: None if v is None else v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    n_microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "ce"}). With n_microbatches > 1, gradients sum in
    fp32 over equal slices of the batch, then divide by their number
    (activation memory scales with 1/n); the aux metric is then
    `loss * 0.0` and the counts None, as in the reference."""

    def accumulated(params, batch):
        n = n_microbatches
        mbs = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
               for i in range(n)]
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)
        dev = leaves(params)[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        ce = torch.zeros((), dtype=torch.float32, device=dev)
        for mb in mbs:
            mb_loss, metrics, grads = value_and_grad(params, cfg, mb)
            acc = tree_map(torch.add, acc, grads)
            loss, ce = loss + mb_loss, ce + metrics["ce"]
        grads = tree_map(lambda g: g / float(n), acc)
        return loss / n, {"ce": ce / n, "aux": loss * 0.0, "expert_counts": None}, grads

    def train_step(params, opt_state, batch):
        if n_microbatches > 1:
            loss, metrics, grads = accumulated(params, batch)
        else:
            loss, metrics, grads = value_and_grad(params, cfg, batch)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, "ce": metrics["ce"]}

    return train_step


def init_train_state(seed: int, cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                     device=None):
    params = init_params(seed, cfg, device=device)
    return params, adamw_init(params, opt_cfg)
