"""Training step (port of repro/training/train_step.py): cross entropy
plus the MoE aux loss, each layer group activation-checkpointed in
`forward_train`, optional microbatch gradient accumulation, AdamW.

Gradients come from `torch.autograd.grad` over detached copies of the
parameter leaves, so a step is a function of (params, opt_state, batch)
as the reference's is.

On a device mesh (`make_train_step(..., mesh=)`) the step computes what
the reference's one program (GSPMD) computes on the global batch. Params
and AdamW moments are stored as DTensors with the `tree_pspecs` /
`opt_state_pspecs` placements. Each rank takes its rows of the global
batch (split over the DP axes); each layer group's weights are gathered
just before use, inside its checkpoint (the routed experts stay this
rank's E/m under `set_moe_sharding_hints`); every rank's loss is its
rows' share of the cross entropy plus the whole batch's aux loss, and
each gathered weight's gradient is summed over the DP shards and cut
back to its shard. AdamW then updates the shards, with the clip norm and
the int8 scale taken over the whole leaves. Kernels see plain local
tensors, never DTensors. On the card the MoE layers' grouped GEMMs, their
recompute and their dX products run the hand-written `moe_gemm` kernel
(kernels/moe_gemm/kernel.py); the reference cannot differentiate its
Pallas kernel and trains through its einsums.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import all_reduce, gather_shards
from repro_torch.models.model import forward_train, init_params
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


class _Gather:
    """forward_train's `gather` on a mesh: each leaf of a subtree (this
    rank's shard, a plain tensor) gathered to the full tensor, or, for a
    routed expert weight sharded over the expert dim under the MoE hints,
    to this rank's E/m experts. `places`: {path: DTensor placements}."""

    def __init__(self, mesh, places):
        from repro_torch.models.moe import _SHARDING_HINTS

        self.mesh, self.places = mesh, places
        self.dp, self.dp_n, _ = shd.dp_group(mesh)
        self.sizes = tuple(mesh.shape)
        self.ep = None
        if _SHARDING_HINTS is not None:
            self.ep = list(mesh.mesh_dim_names).index(_SHARDING_HINTS[1])
        self.cache = {}

    def _places(self, path: tuple, leaf, stacked: bool):
        from torch.distributed.tensor import Replicate, Shard

        lead = 1 if stacked else 0  # one scan group: the group dim is never sharded
        places = []
        for pl in self.places[path]:
            assert not (stacked and pl == Shard(0)), path
            places.append(Shard(pl.dim - lead) if pl.is_shard() else pl)
        routed = path[-1] in ("w_gate", "w_up", "w_down") and "shared" not in path
        if (self.ep is not None and routed and leaf.dim() >= 3
                and places[self.ep] == Shard(leaf.dim() - 3)):
            places[self.ep] = Replicate()  # the expert dim stays this rank's
        return places

    def _leaf(self, path: tuple, leaf, stacked: bool):
        key = (path, stacked)
        if key not in self.cache:  # None: nothing to gather, no gradient to reduce
            places = self._places(path, leaf, stacked)
            moves = self.dp_n > 1 or any(
                p.is_shard() and n > 1 for p, n in zip(places, self.sizes))
            self.cache[key] = places if moves else None
        places = self.cache[key]
        return leaf if places is None else gather_shards(leaf, self.mesh, places, self.dp)

    def __call__(self, tree, prefix: tuple, stacked: bool = False):
        flat = [self._leaf(prefix + path, leaf, stacked) for path, leaf in leaves_with_path(tree)]
        return unflatten(tree, flat)


def _whole_stacks(params: Params, mesh, places):
    """(params, places) with every stacked leaf whose scan-group dim the
    rules split (a dense MLP [L, D, F] read as experts when the layer count
    divides the axis) gathered along it, so each scan group can be taken:
    its gradient flows back as this rank's groups (the later gathers sum
    it over the DP shards)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.collectives import gather_dim

    places = dict(places)
    flat = []
    for path, leaf in leaves_with_path(params):
        pl = places[path]
        if path[0] == "stack" and any(p.is_shard() and p.dim == 0 for p in pl):
            pl = list(pl)
            for i in reversed(range(len(pl))):  # inner mesh dims first
                if pl[i].is_shard() and pl[i].dim == 0:
                    leaf = gather_dim(leaf, mesh.get_group(i), 0)
                    pl[i] = Replicate()
            places[path] = pl
        flat.append(leaf)
    return unflatten(params, flat), places


def mesh_value_and_grad(params: Params, cfg: ModelConfig, batch: Dict[str, Any], mesh,
                        places):
    """`value_and_grad` on a mesh: params a tree of this rank's shards
    (plain tensors) placed as `places` says ({path: DTensor placements}),
    batch the global batch. Returns the whole batch's (loss, metrics) and
    this rank's shard of every leaf's gradient."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    _, n_dp, _ = shd.dp_group(mesh)
    local = {k: shd.shard_rows(v, mesh) for k, v in batch.items()}
    with shd.use_mesh(mesh), torch.enable_grad():
        stacks, places = _whole_stacks(tracked, mesh, places)
        logits, aux, counts = forward_train(stacks, cfg, local, gather=_Gather(mesh, places))
        ce_part = cross_entropy(logits, local["labels"]) * (1.0 / n_dp)  # rows' share
        flat = leaves(tracked)
        grads = torch.autograd.grad(ce_part + aux, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    ce = all_reduce(ce_part.detach(), shd.dp_group(mesh)[0])
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
