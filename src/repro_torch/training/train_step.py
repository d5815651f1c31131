"""Training step (port of repro/training/train_step.py): cross entropy
plus the MoE aux loss, each layer group activation-checkpointed in
`forward_train`, optional microbatch gradient accumulation, AdamW.

Gradients come from `torch.autograd.grad` over detached copies of the
parameter leaves, so a step is a function of (params, opt_state, batch)
as the reference's is.

On a device mesh (`make_train_step(..., mesh=)`) the step computes what
the reference's one program (GSPMD) computes on the global batch, and
partitions it as GSPMD partitions the reference's program under
`tree_pspecs`: params and AdamW moments are stored as DTensors with the
`tree_pspecs` / `opt_state_pspecs` placements, each rank takes its rows
of the global batch (split over the DP axes), and the forward and the
backward run on the shards (`models.model.mesh_forward_train`,
distributed/tensor_parallel.py): attention heads, Mamba / xLSTM
channels, the MLPs' F and the vocab split over "model", FSDP weights
gathered over "data" just before use inside each layer group's
checkpoint and gathered again for its recompute, every collective
differentiable (distributed/collectives.py). The cross entropy is
vocab-parallel where the head splits the vocab, so the logits are never
gathered; every rank's loss is its rows' share of it plus the whole
batch's aux loss (its gradient the rank's part), and every leaf's
gradient is summed over the DP shards once (an FSDP weight's by its
gather's reduce-scatter over "data"). AdamW then updates the shards, with
the clip norm and the int8 scale taken over the whole leaves. Kernels see
plain local tensors, never DTensors. On the card the MoE layers' grouped
GEMMs, their recompute and their dX products run the hand-written
`moe_gemm` kernel (kernels/moe_gemm/kernel.py); the reference cannot
differentiate its Pallas kernel and trains through its einsums.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.models.model import forward_train, init_params, mesh_forward_train
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

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


def vocab_parallel_cross_entropy(tp, logits: torch.Tensor, labels: torch.Tensor,
                                 lo: int, vocab: int) -> torch.Tensor:
    """`cross_entropy` of logits split over "model" by vocab: this rank's
    columns [B, S, n] from vocab index `lo` (those at `vocab` or past it
    are padding, left out). The row max over "model" (detached: a
    stabilizer), the sum of exps summed over "model", and each label's
    logit from the rank that holds it, summed: the whole [B, S, V] logits
    are never gathered. Every rank returns the same scalar."""
    lf = logits.float()
    n = lf.shape[-1]
    if lo + n > vocab:
        real = lo + torch.arange(n, device=lf.device) < vocab
        lf = torch.where(real, lf, torch.full_like(lf, float("-inf")))
    top = tp.max_model(lf.max(-1).values)
    lse = torch.log(tp.sum_model(torch.exp(lf - top[..., None]).sum(-1))) + top
    rel = labels.long() - lo
    mine = (rel >= 0) & (rel < n)
    picked = torch.gather(lf, -1, rel.clamp(0, n - 1)[..., None])[..., 0]
    picked = tp.sum_model(torch.where(mine, picked, torch.zeros_like(picked)))
    return torch.mean(lse - picked)


def _sum_over_dp(tp, grads, places):
    """Every leaf's gradient summed over the DP shards once: a leaf split
    over "data" had its gradient reduce-scattered over "data" by its FSDP
    gather's backward, so only the other DP axes ("pod") remain; any other
    leaf sums over every DP axis. Rows whole on every DP rank (`tp.split`
    false) are counted once: nothing is summed."""
    if not tp.split:
        return grads
    dp = [a for a in tp.names if a in ("pod", "data")]
    out = []
    for g, pl in zip(grads, places):
        split = {tp.names[i] for i, q in enumerate(pl) if q.is_shard()}
        grp = tp.group([a for a in dp if not (a == "data" and "data" in split)])
        out.append(tp.all_reduce(g, grp))
    return out


def mesh_value_and_grad(params: Params, cfg: ModelConfig, batch: Dict[str, Any], mesh,
                        places):
    """`value_and_grad` on a mesh: params a tree of this rank's shards
    (plain tensors) placed as `places` says ({path: DTensor placements}),
    batch the global batch. The forward and backward run partitioned
    (`mesh_forward_train`): each rank's loss is its rows' share of the
    cross entropy (vocab-parallel where the head splits the vocab) plus
    the aux loss (whole, its gradient this rank's part), and each leaf's
    gradient comes out as its shard's, summed over the DP shards. Returns
    the whole batch's (loss, metrics) and this rank's shard of every
    leaf's gradient."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = leaves(tracked)
    paths = [path for path, _ in leaves_with_path(tracked)]
    local = unflatten(tracked, [tpl.local_of(t, places[path], mesh)
                                for path, t in zip(paths, flat)])
    b = batch["tokens"].shape[0]
    tp = tpl.TP(mesh, b)
    rows = {k: shd.shard_rows(v, mesh) for k, v in batch.items()}
    with shd.use_mesh(mesh, b), torch.enable_grad():
        logits, lo, aux, counts = mesh_forward_train(tp, local, cfg, rows)
        ce_rows = (cross_entropy(logits, rows["labels"]) if lo is None
                   else vocab_parallel_cross_entropy(tp, logits, rows["labels"], lo,
                                                     cfg.vocab_size))
        ce_part = ce_rows * (1.0 / tp.n_dp)  # these rows' share
        grads = torch.autograd.grad(ce_part + aux, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    grads = _sum_over_dp(tp, grads, [places[path] for path in paths])
    ce = tp.sum_dp(ce_part.detach())
    metrics = {"ce": ce, "aux": aux.detach(), "expert_counts": counts}
    return ce + aux.detach(), metrics, unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    n_microbatches: int = 1, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "ce"}). With n_microbatches > 1, gradients sum in
    fp32 over equal slices of the batch, then divide by their number
    (activation memory scales with 1/n); the aux metric is then
    `loss * 0.0` and the counts None, as in the reference. With `mesh`,
    params and opt_state are DTensor trees (`shard_train_state`) and the
    batch is the global one, the same on every rank."""
    if mesh is not None:
        return _mesh_train_step(cfg, opt_cfg, n_microbatches, mesh)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _accumulate(
            lambda mb: value_and_grad(params, cfg, mb), params, batch, n_microbatches)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, "ce": metrics["ce"]}

    return train_step


def _accumulate(vg, params, batch, n: int):
    """vg(batch) -> (loss, metrics, grads) over the whole batch, or summed
    in fp32 over n equal slices of its rows and divided by n."""
    if n == 1:
        return vg(batch)
    mbs = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
           for i in range(n)]
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                   params)
    dev = leaves(params)[0].device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    ce = torch.zeros((), dtype=torch.float32, device=dev)
    for mb in mbs:
        mb_loss, metrics, grads = vg(mb)
        acc = tree_map(torch.add, acc, grads)
        loss, ce = loss + mb_loss, ce + metrics["ce"]
    grads = tree_map(lambda g: g / float(n), acc)
    return loss / n, {"ce": ce / n, "aux": loss * 0.0, "expert_counts": None}, grads


def _mesh_train_step(cfg, opt_cfg, n_microbatches, mesh):
    from torch.distributed.tensor import DTensor

    world = shd.axis_group(mesh, tuple(mesh.mesh_dim_names))[0]

    def train_step(params, opt_state, batch):
        places = {path: list(t.placements) for path, t in leaves_with_path(params)}
        local = tree_map(lambda t: t.to_local(), params)
        loss, metrics, grads = _accumulate(
            lambda mb: mesh_value_and_grad(local, cfg, mb, mesh, places), local, batch,
            n_microbatches)
        reps = tree_map(lambda t: shd.replicas_of(t.placements, mesh), params)
        new, state = adamw_update(local, grads, tree_map(lambda t: t.to_local(), opt_state),
                                  opt_cfg, replicas=reps, group=world)

        def wrap(t, like):
            return DTensor.from_local(t, mesh, like.placements, run_check=False,
                                      shape=like.shape, stride=like.stride())

        return (tree_map(wrap, new, params), tree_map(wrap, state, opt_state),
                {"loss": loss, "ce": metrics["ce"]})

    return train_step


def shard_train_state(params: Params, opt_state: Dict[str, Any], mesh, cfg: ModelConfig):
    """(params, opt_state) stored as DTensors on `mesh`: params under
    `tree_pspecs`, the moments under the same specs, the step replicated."""
    specs = shd.tree_pspecs(params, mesh, cfg)
    opt_specs = shd.opt_state_pspecs(opt_state, specs)
    return (shd.shard_tree(params, mesh, specs),
            {k: shd.shard_tree(v, mesh, opt_specs[k]) if isinstance(v, dict)
             else shd.distribute(v, mesh, shd.placements(opt_specs[k], mesh))
             for k, v in opt_state.items()})


def init_train_state(seed: int, cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                     device=None):
    params = init_params(seed, cfg, device=device)
    return params, adamw_init(params, opt_cfg)
