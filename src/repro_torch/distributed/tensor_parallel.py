"""Tensor-parallel compute on a device mesh: the partitioning GSPMD
derives for the reference's serving and training functions from its
sharding rules (repro/distributed/sharding.py), written out.

Each rank holds its shard of every leaf (`Local`: the plain tensor, the
mesh axes that split it and the whole leaf's shape) and computes on its
rows of the batch (split over the DP axes). A weight sharded over "data"
(FSDP storage) is gathered over "data" just before use; what stays split
over "model" decides the layer's partitioning, as the rules place it:
- a weight split along its output dim (heads, F, vocab) is
  column-parallel: each rank computes its columns;
- one split along its contracting dim (the heads' fallback D, a row-
  parallel w_down or wo, the router) gives partial sums, all-reduced over
  "model";
- a replicated one is computed whole on every rank;
- one whose columns hold nb blocks ([x | z], [i | f | z | o]) while the
  layer's state splits its channels is regrouped to this rank's channels
  of each block by one all-to-all (`block_cols`, `block_weight`).
A batch that does not split over the DP axes stays whole on every DP rank
(`TP`'s `batch`), as the reference replicates it.

Every collective here runs on its group even when the group is one rank
(a (1, 1) mesh runs the mesh code and its collectives, not the unsharded
functions). Nothing here allocates a whole cache or tier buffer.

The train step differentiates through all of it: each collective has its
backward rule (distributed/collectives.py), and every place where an
activation whole on every model rank enters rank-specific compute (a
column-split projection, the column slice of a D-split one, this rank's
channels or heads) passes Megatron's f (`TP.copy_model`), so its
gradient is summed over "model" once. FSDP gathers reduce-scatter their
gradients over "data"; a scan group broadcast from its owning rank
counts its (replicated) gradient once, at the owner.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers


class Local:
    """This rank's shard `t` of a leaf whose whole shape is `shape`;
    `axes` maps each mesh axis that splits it to the tensor dim it splits
    (axes on one dim nest major first, in mesh order, as DTensor nests
    them). Indexing takes one scan group of a stacked leaf. Where the
    rules split the group dim itself (a stacked dense MLP read as experts
    [E, D, F] when the layer count divides the axis), group g lives on
    one rank of that axis: `src` = (axis, that rank's index), and `t`
    there holds it (elsewhere, another group of the same shape)."""

    __slots__ = ("t", "axes", "shape", "src")

    def __init__(self, t: torch.Tensor, axes: Dict[str, int], shape: tuple, src=None):
        self.t, self.axes, self.shape, self.src = t, axes, tuple(shape), src

    @property
    def dtype(self):
        return self.t.dtype

    def _group_split(self):
        split = [a for a, d in self.axes.items() if d == 0]
        if len(split) > 1 or (split and self.src is not None):
            raise ValueError(f"the group dim of {self.shape} is split as {self.axes}")
        return (split[0] if split else None), {a: d - 1 for a, d in self.axes.items() if d}

    def __getitem__(self, g):
        axis, rest = self._group_split()
        if axis is None:
            return Local(self.t[g], rest, self.shape[1:])
        n = self.t.shape[0]
        return Local(self.t[g % n], rest, self.shape[1:], src=(axis, g // n))

    def unbind(self) -> list:
        """`[self[g] for g in range(shape[0])]` from one `torch.unbind` of
        the local tensor: its backward stacks the groups' gradients in one
        pass, where indexing group by group adds a zero gradient the size
        of the whole leaf per group."""
        axis, rest = self._group_split()
        parts = torch.unbind(self.t, 0)
        n = len(parts)
        return [Local(parts[g % n], rest, self.shape[1:],
                      src=None if axis is None else (axis, g // n))
                for g in range(self.shape[0])]


def unbind_locals(tree) -> list:
    """The scan groups of a stacked subtree of `Local`s (`Local.unbind`)."""
    if isinstance(tree, dict):
        parts = {k: unbind_locals(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: part[g] for k, part in parts.items()} for g in range(n)]
    return tree.unbind()


def local_leaf(dt, mesh) -> Local:
    """A DTensor as a `Local` (its local tensor, shared, not copied)."""
    return local_of(dt.to_local(), dt.placements, mesh)


def local_of(t: torch.Tensor, placements, mesh) -> Local:
    """This rank's shard `t` (a plain tensor) of a leaf placed as
    `placements` on `mesh`, as a `Local` (the whole shape from the
    shard's: the rules split only dims that divide)."""
    names = list(mesh.mesh_dim_names)
    sizes = shd.mesh_shape(mesh)
    axes, shape = {}, list(t.shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            axes[names[i]] = pl.dim
            shape[pl.dim] *= sizes[names[i]]
    return Local(t, axes, tuple(shape))


def spec_locals(tree, specs, mesh):
    """A tree of tensors (meta ones: no storage) as `Local`s placed as the
    spec tree `specs` says (each whole tensor's shape, `t` itself)."""
    if isinstance(tree, dict):
        return {k: spec_locals(v, specs[k], mesh) for k, v in tree.items()}
    axes = {}
    for d, entry in enumerate(specs):
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            axes[a] = d
    return Local(tree, axes, tuple(tree.shape))


def local_tree(tree, mesh):
    """Every DTensor leaf of a tree as a `Local`."""
    if isinstance(tree, dict):
        return {k: local_tree(v, mesh) for k, v in tree.items()}
    return local_leaf(tree, mesh)


# ------------------------------------------------------------- collectives
def _max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group (no gradient: a stabilizer)."""
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class TP:
    """The mesh's groups as the serving functions use them: "model" (the
    tensor- and sequence-parallel axis), the DP axes (pod, data: the batch
    rows), and "data" (FSDP storage, the cold tier's homes).

    `batch` is the global batch's rows. Where it does not split over the DP
    axes (`split` false) every DP shard holds and computes the whole batch,
    as the reference replicates it: the DP group is then (None, 1, 0) and
    nothing that sums or gathers rows runs over it, so the replicas count
    once."""

    def __init__(self, mesh, batch: Optional[int] = None):
        self.mesh = mesh
        self.names = list(mesh.mesh_dim_names)
        self.sizes = shd.mesh_shape(mesh)
        if "model" not in self.sizes:
            raise ValueError(f"a serving mesh needs a 'model' axis, got {self.names}")
        self.model, self.m, self.mi = shd.axis_group(mesh, "model")
        if shd.dp_axes(mesh) is None:
            raise ValueError(f"a serving mesh needs a DP axis, got {self.names}")
        self.batch = batch
        self.split = batch is None or shd.rows_split(mesh, batch)
        self.dp, self.n_dp, self.dp_i = shd.dp_group(mesh, batch)

    def group(self, axes) -> Tuple:
        """(group, size, index) over `axes` (mesh order), or a one-rank
        stand-in (None, 1, 0) for no axes."""
        axes = tuple(a for a in self.names if a in axes)
        return shd.axis_group(self.mesh, axes) if axes else (None, 1, 0)

    # ------------------------------------------------------ collectives
    # each with its backward rule (distributed/collectives.py): a train
    # step differentiates through them
    def sum_model(self, x):
        """Partial sums over "model" (backward: the identity)."""
        return col.ReduceFromGroup.apply(x, self.model)

    def sum_copy_model(self, x):
        """Partial sums over "model" that only rank-specific compute reads
        (backward: the gradients' sum over "model")."""
        return col.ReduceCopy.apply(x, self.model)

    def copy_model(self, x):
        """`x`, whole on every model rank, entering rank-specific compute
        (backward: the gradients' sum over "model")."""
        return col.CopyToGroup.apply(x, self.model)

    def max_model(self, x):
        return _max(x, self.model)

    def gather_model(self, x, dim: int):
        """Every model rank's `x` joined along `dim` (backward: this
        rank's piece of the gradient)."""
        return col.GatherDim.apply(x, self.model, self.m, self.mi, dim)

    def sum_dp(self, x):
        """The sum over the DP shards' rows (replicated rows: `x` itself)."""
        return col.ReduceFromGroup.apply(x, self.dp) if self.split else x

    def gather_dp(self, x):
        """[n_dp, *x.shape]: every DP shard's `x`, in global row order."""
        if not self.split:
            return x[None]
        return col.GatherDim.apply(x[None], self.dp, self.n_dp, self.dp_i, 0)

    def all_reduce(self, x, grp):
        g, _, _ = grp
        return x if g is None else col.ReduceFromGroup.apply(x, g)

    def all_gather(self, x, grp, dim: int = 0):
        g, n, i = grp
        return x if g is None else col.GatherDim.apply(x, g, n, i, dim)

    def reduce_scatter(self, x, grp):
        g, n, _ = grp
        return x if g is None else col.ReduceScatter.apply(x, g, n)

    def all_to_all_model(self, x):
        """x [m, ...]: row j to model rank j; returns row j from rank j."""
        return col.AllToAll.apply(x, self.model)

    def regroup_model(self, pieces: torch.Tensor) -> torch.Tensor:
        """Blocks split by columns to blocks split by channels. A leaf's
        last dim holds nb blocks of W (Mamba's [x | z], sLSTM's [i | f | z
        | o]) and "model" splits it into contiguous chunks, so rank j holds
        pieces p = j * nb + q (q < nb) of W/m, where piece p is channels
        [r W/m, (r + 1) W/m) of block b for p = b m + r. `pieces` [nb, ...]
        are this rank's, in order; one all-to-all over "model" sends piece
        p to rank r and returns [nb, ...]: this rank's channels of blocks
        0..nb-1 (backward: the inverse all-to-all)."""
        nb, m, j = pieces.shape[0], self.m, self.mi
        dest = [(j * nb + q) % m for q in range(nb)]
        order = sorted(range(nb), key=lambda q: (dest[q], q))
        src = [(b * m + j) // nb for b in range(nb)]  # blocks arrive in src order = b order
        send = torch.cat([pieces[q:q + 1] for q in order])  # device ops only: no host copy
        return col.AllToAll.apply(send, self.model, [src.count(r) for r in range(m)],
                                  [dest.count(r) for r in range(m)])

    # ---------------------------------------------------------- weights
    def chunk(self, n: int) -> Tuple[int, int]:
        """(first index, count) of this rank's contiguous 1/m of n."""
        if n % self.m:
            raise ValueError(f"{n} does not split over {self.m} model ranks")
        step = n // self.m
        return self.mi * step, step

    def weight(self, leaf: Local) -> Tuple[torch.Tensor, Optional[int], Optional[torch.Tensor]]:
        """(w, dim, idx): the leaf gathered over every axis but "model"
        (FSDP storage), the dim "model" still splits (None: replicated),
        and, when "data" and "model" nest on that dim, the global indices
        of the entries this rank holds along it (None: the contiguous
        chunk `chunk(shape[dim])`)."""
        w, idx = leaf.t, None
        if leaf.src is not None:  # one rank holds this scan group: it sends it
            g, _, _ = shd.axis_group(self.mesh, leaf.src[0])
            w = col.Broadcast.apply(w, g, dist.get_global_rank(g, leaf.src[1]))
        dm = leaf.axes.get("model")
        for axis in self.names:
            d = leaf.axes.get(axis)
            if axis == "model" or d is None:
                continue
            if axis != "data":
                raise ValueError(f"a weight split over {axis!r}: {leaf.axes}")
            g, n, i = shd.axis_group(self.mesh, "data")
            # backward: the reduce-scatter over "data" of the gradients of
            # the rows each data rank met (its own piece where the rows
            # are whole on every rank)
            w = col.GatherDim.apply(w, g, n, i, d, self.split)
            if d == dm:  # ("data", "model") on one dim: data-major pieces
                idx = self.nested_index(leaf.shape[d], n, self.mi, w.device)
        return w, dm, idx

    def nested_index(self, n: int, ds: int, j: int, device) -> torch.Tensor:
        """Global indices, along a dim of n split over ("data", "model"),
        of what model rank j holds once "data" is gathered."""
        c = n // (ds * self.m)
        base = torch.arange(ds, device=device)[:, None] * (n // ds) + j * c
        return (base + torch.arange(c, device=device)[None, :]).reshape(-1)

    def take(self, x: torch.Tensor, dim: int, n: int, idx) -> torch.Tensor:
        """This rank's entries of `x` along `dim` (whole, n long) for a
        weight split there: the contiguous chunk, or `idx`."""
        if idx is not None:
            return x.index_select(dim, idx)
        lo, step = self.chunk(n)
        return x.narrow(dim, lo, step)

    def gather_cols(self, y: torch.Tensor, n: int, idx) -> torch.Tensor:
        """The whole last dim (n long) from every model rank's entries of
        it (the contiguous chunks, or nested indices as `weight` gives)."""
        full = self.gather_model(y, -1)
        if idx is None:
            return full
        ds = self.sizes["data"]
        order = torch.cat([self.nested_index(n, ds, j, y.device) for j in range(self.m)])
        return full.index_select(-1, torch.argsort(order))


# ------------------------------------------------------------------ layers
def embed(tp: TP, table: Local, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding lookup (reference rules :51-55): a vocab-parallel table
    looks up the tokens in this rank's vocab range (zeros elsewhere) and
    sums over "model"; a D-split one (odd vocab) gathers its columns."""
    w, dm, idx = tp.weight(table)
    tok = tokens.long()
    if dm == 0:
        if idx is not None:
            raise ValueError(f"a vocab split over ('data', 'model'): {table.axes}")
        lo, n = tp.chunk(table.shape[0])
        rel = tok - lo
        mine = (rel >= 0) & (rel < n)
        rows = w[rel.clamp(0, n - 1)] * mine[..., None].to(w.dtype)
        return tp.sum_model(rows)
    if dm == 1:
        return tp.gather_cols(w[tok], table.shape[1], idx)
    return w[tok]


def out_proj(tp: TP, x: torch.Tensor, w_leaf: Local, transpose: bool = False,
             eq: Optional[str] = None, keep_cols: bool = False):
    """x [..., D] @ w [D, N] (or w [N, D] transposed, a tied table; `eq`
    the einsum to use instead of @) with x whole on every model rank:
    column-parallel over N (each rank's columns gathered over "model"),
    or split along D (partial sums summed over "model"), or whole. With
    `keep_cols` (the logits of training's vocab-parallel cross entropy):
    (y, lo), y this rank's contiguous columns from index lo: a
    column-parallel y as computed; for a D-split w, the weight regrouped
    by one all-to-all over "model" from D rows to columns (N padded with
    zero columns to a multiple of m: this rank's ceil(N/m), past N on the
    last ranks), which moves w's bytes where summing the partial products
    would move [..., N] of them; a whole y with lo None."""
    w, dm, idx = tp.weight(w_leaf)

    def mm(a, b):
        return a @ b if eq is None else torch.einsum(eq, a, b)

    if transpose:
        w = w.T
        dm = None if dm is None else 1 - dm
    d, n = (w_leaf.shape[1], w_leaf.shape[0]) if transpose else w_leaf.shape
    lo = None
    if dm == 1:
        y = mm(tp.copy_model(x), w)
        if keep_cols and idx is None:
            lo, _ = tp.chunk(n)
        else:
            y = tp.gather_cols(y, n, idx)
    elif dm == 0 and keep_cols and idx is None:
        step = -(-n // tp.m)
        pieces = F.pad(w, (0, step * tp.m - n)).unflatten(-1, (tp.m, step)).movedim(-2, 0)
        y = mm(tp.copy_model(x), tp.all_to_all_model(pieces).flatten(0, 1))
        lo = tp.mi * step
    elif dm == 0:
        y = tp.sum_model(mm(tp.take(tp.copy_model(x), -1, d, idx), w))
    else:
        y = mm(x, w)
    return (y, lo) if keep_cols else y


def block_weight(tp: TP, leaf: Local, nb: int, split: bool) -> torch.Tensor:
    """A weight whose last dim holds nb blocks of W channels, as this rank
    computes with it: [..., nb, W/m] (its channels of every block) where
    `split` (the channels a layer's state splits over "model"), else
    [..., nb, W]. A column-split weight is regrouped by one all-to-all
    over "model" (`TP.regroup_model`); a whole one is cut."""
    w, dm, idx = tp.weight(leaf)
    last = len(leaf.shape) - 1
    blocks = leaf.shape[-1] // nb
    if dm is None:
        w = w.unflatten(-1, (nb, blocks))
        if not split:
            return w
        lo, n = tp.chunk(blocks)
        return tp.copy_model(w).narrow(-1, lo, n)
    if dm != last or idx is not None or not split:
        raise ValueError(f"a block weight {leaf.shape} split as {leaf.axes}, channels "
                         f"{'split' if split else 'whole'}")
    pieces = w.unflatten(-1, (nb, -1)).movedim(-2, 0)
    return tp.regroup_model(pieces).movedim(0, -2)


def block_cols(tp: TP, x: torch.Tensor, leaf: Local, nb: int, split: bool) -> torch.Tensor:
    """x [..., S, D] @ w [D, nb W] restricted to this rank's channels of
    each block: [..., S, nb, W/m] (`split`) or [..., S, nb, W]. A
    column-split w regroups once a call, on the side that moves fewer
    bytes: the activations (x @ the local columns, then the all-to-all)
    at one token a row, as decode runs, where a rank's rows are far fewer
    than w's D rows; the weight otherwise (the dry-run's jamba
    prefill_32k holds 2 x 32768 token rows a rank against D = 4096)."""
    if split:  # this rank's channels: rank-specific compute
        x = tp.copy_model(x)
    if x.shape[-2] != 1 or "model" not in leaf.axes:
        return (x @ block_weight(tp, leaf, nb, split).flatten(-2)).unflatten(-1, (nb, -1))
    w, dm, idx = tp.weight(leaf)
    if dm != len(leaf.shape) - 1 or idx is not None or not split:
        raise ValueError(f"a block weight {leaf.shape} split as {leaf.axes}")
    y = (x @ w).unflatten(-1, (nb, -1))
    return tp.regroup_model(y.movedim(-2, 0)).movedim(0, -2)


def whole(tree):
    """A replicated subtree (norm scales, routing tables) as plain tensors."""
    if isinstance(tree, dict):
        return {k: whole(v) for k, v in tree.items()}
    if tree.axes:
        raise ValueError(f"expected a replicated leaf, got one split {tree.axes}")
    return tree.t


def router_logits(tp: TP, flat: torch.Tensor, router: Local) -> torch.Tensor:
    """fp32 router logits [T, E] of flat [T, D] (the router's D split over
    "model" where it divides)."""
    return out_proj(tp, flat.float(), router)


def mlp(tp: TP, p, x: torch.Tensor) -> torch.Tensor:
    """The dense SwiGLU MLP: w_gate / w_up column-parallel over F, w_down
    row-parallel, one sum over "model" (reference rules :96-101)."""
    return _swiglu(tp, p, x, layers.mlp)


def shared_ffn(tp: TP, p, x: torch.Tensor) -> torch.Tensor:
    """The shared experts [n, D, F] / [n, F, D], split over F as the dense
    MLP is."""
    from repro_torch.models.moe import shared_ffn as plain

    return _swiglu(tp, p, x, plain)


def _swiglu(tp: TP, p, x: torch.Tensor, plain) -> torch.Tensor:
    """`plain` (the unsharded SwiGLU) on this rank's F columns; the partial
    down products summed over "model" where F is split."""
    w = {k: tp.weight(p[k]) for k in ("w_gate", "w_up", "w_down")}
    split = w["w_down"][1]
    if not (w["w_gate"][1] == w["w_up"][1] == (None if split is None else split + 1)):
        raise ValueError(f"SwiGLU splits disagree: {p['w_gate'].axes}, {p['w_down'].axes}")
    if split is None:
        return plain({k: t for k, (t, _, _) in w.items()}, x)
    return tp.sum_model(plain({k: t for k, (t, _, _) in w.items()}, tp.copy_model(x)))


def heads_proj(tp: TP, x: torch.Tensor, w_leaf: Local, eq: str, bias: Optional[Local] = None):
    """A per-head projection x [..., D] -> [..., H, k] by w [.., D, H, k]
    (`eq` its einsum). Returns (y, first head): this rank's H/m heads when
    the heads split over "model" (first head their index), else every
    head (None) — with a D-split weight (the fallback where the heads do
    not divide) the partial sums summed over "model". The bias [H, k] is
    added after the sum, as the reference adds it."""
    w, dm, idx = tp.weight(w_leaf)
    nd = len(w_leaf.shape)
    if dm == nd - 2:  # heads
        y = torch.einsum(eq, tp.copy_model(x), w)
        lo, _ = tp.chunk(w_leaf.shape[-2])
    elif dm == nd - 3:  # contracting D
        xd = tp.take(tp.copy_model(x), -1, w_leaf.shape[-3], idx)
        y = tp.sum_model(torch.einsum(eq, xd, w))
        lo = None
    elif dm is None:
        y, lo = torch.einsum(eq, x, w), None
    else:
        raise ValueError(f"a head projection split on dim {dm}: {w_leaf.axes}")
    if bias is not None:
        y = y + bias.t
    return y, lo


def gather_heads(tp: TP, y: torch.Tensor, lo: Optional[int], dim: int = 2) -> torch.Tensor:
    """Every head of a per-head tensor: this rank's heads gathered over
    "model" (`lo` not None), or `y` itself (every rank has them all)."""
    return y if lo is None else tp.gather_model(y, dim)


def heads_out(tp: TP, o: torch.Tensor, lo: Optional[int], wo: Local, eq: str) -> torch.Tensor:
    """The output projection of per-head o [..., H | H/m, k] by wo [H, k,
    D]: row-parallel over heads (this rank's heads, summed over "model"),
    column-parallel over D where the heads do not divide (gathered), or
    whole. `lo` says which heads o holds (None: all)."""
    w, dm, idx = tp.weight(wo)
    h = wo.shape[-3]
    if dm == len(wo.shape) - 3:
        first, n = tp.chunk(h)
        if lo is None:  # every head here: take this rank's
            o = tp.copy_model(o).narrow(-2, first, n)
        elif lo != first:
            raise ValueError(f"heads from {lo}, wo's from {first}")
        return tp.sum_model(torch.einsum(eq, o, w))
    if lo is not None:
        raise ValueError(f"{o.shape[-2]} local heads but wo holds all {h}: {wo.axes}")
    if dm is None:
        return torch.einsum(eq, o, w)
    return tp.gather_cols(torch.einsum(eq, tp.copy_model(o), w), wo.shape[-1], idx)
