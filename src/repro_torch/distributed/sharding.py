"""Parameter / activation / cache sharding rules for the production mesh
(port of repro/distributed/sharding.py: `_named_rule` :38, `_generic_rule`
:125, `param_pspec` :142, `tree_pspecs` :164, `dp_axes` :177,
`batch_pspec` :182, `cache_pspec(s)` :186, `tiered_pspec(s)` :225,
`opt_state_pspecs` :262, `report_replicated` :272).

Mesh axes: ("data", "model") on one pod, ("pod", "data", "model") across
pods. The batch shards over (pod, data). Parameters shard over "model"
(heads, the expert dim, the vocab) and, for archs above the FSDP
threshold, also over "data" (ZeRO-3 style storage).

The rules are pure functions of a leaf's path, its shape and the mesh's
axis sizes, with a generic fallback: named overrides pin the
semantically right axis; the fallback shards the largest divisible dim
over "model" and the next over "data". Dims that do not divide the axis
stay replicated, so every (arch x mesh) cell has a layout.

A spec is a tuple with one entry per dim: None, an axis name, or a tuple
of names (one tensor dim over several mesh dims, major first), so it
compares equal to the reference's PartitionSpec entry by entry. A mesh is
anything that gives {axis name: size}: a dict, an object whose `.shape`
is one, or a `DeviceMesh` (whose `.shape` is a tuple beside its
`mesh_dim_names`). `placements` maps a spec onto DTensor placements and
`shard_tree` stores a tree as DTensors; `use_mesh` makes a mesh the
active one for the model code's data-parallel, expert-parallel and
sequence-parallel branches (JAX's `with mesh:`).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import leaves_with_path, unflatten

Params = Any
Spec = Tuple

# FSDP (shard params over "data" too) above this many parameters
FSDP_THRESHOLD = 8e9


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh of any of the accepted kinds."""
    if isinstance(mesh, dict):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _divisible(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0


def _named_rule(path: str, shape: tuple, mesh, fsdp: bool):
    """A list of axis names (or None) per dim, or None if no rule."""
    ms = _axis_size(mesh, "model")
    ds = _axis_size(mesh, "data")

    def ax(dim, name):
        n = ms if name == "model" else ds
        return name if _divisible(dim, n) else None

    last = path.split("/")[-1]
    nd = len(shape)

    if last == "table":  # embedding [V, D]
        if _divisible(shape[0], ms):
            return [ax(shape[0], "model"), ax(shape[1], "data") if fsdp else None]
        # odd vocab (seamless 256206, granite-moe 49155): shard D instead
        return [None, ax(shape[1], "model")]
    if last == "w" and "head" in path:  # [D, V]
        if _divisible(shape[1], ms):
            return [ax(shape[0], "data") if fsdp else None, ax(shape[1], "model")]
        return [ax(shape[0], "model"), None]
    if last in ("wq", "wk", "wv"):  # [.., D, H|KV, hd]
        h_ax = ax(shape[-2], "model")
        d_ax = ax(shape[-3], "data") if fsdp else None
        if h_ax is None:
            # heads don't divide the model axis (24 heads, MQA kv=1):
            # shard the contracting D dim instead
            if fsdp and _divisible(shape[-3], ms * ds):
                d_ax = ("data", "model")
            elif _divisible(shape[-3], ms):
                d_ax = "model" if not fsdp else d_ax
        return [None] * (nd - 3) + [d_ax, h_ax, None]
    if last == "wo":  # [.., H, hd, D]
        h_ax = ax(shape[-3], "model")
        d_ax = ax(shape[-1], "data") if fsdp else None
        if h_ax is None:
            if fsdp and _divisible(shape[-1], ms * ds):
                d_ax = ("data", "model")
            elif _divisible(shape[-1], ms):
                d_ax = "model" if not fsdp else d_ax
        return [None] * (nd - 3) + [h_ax, None, d_ax]
    if last in ("bq", "bk", "bv"):  # [H, hd]
        return [None] * (nd - 2) + [ax(shape[-2], "model"), None]
    if last == "wkv_a":  # [.., D, r+rope]
        return [None] * (nd - 2) + [
            ax(shape[-2], "data") if fsdp else None, ax(shape[-1], "model")]
    if last == "wkv_b":  # [.., r, H, k]
        return [None] * (nd - 3) + [
            ax(shape[-3], "data") if fsdp else None, ax(shape[-2], "model"), None]
    if last in ("w_gate", "w_up") and nd >= 3 and "shared" not in path:
        # routed experts [.., E, D, F]: EP over model, FSDP over D
        e_ax = ax(shape[-3], "model")
        return [None] * (nd - 3) + [
            e_ax, ax(shape[-2], "data") if fsdp else None,
            ax(shape[-1], "model") if e_ax is None else None]
    if last == "w_down" and nd >= 3 and "shared" not in path:
        # [.., E, F, D]
        e_ax = ax(shape[-3], "model")
        return [None] * (nd - 3) + [
            e_ax, ax(shape[-2], "model") if e_ax is None else None,
            ax(shape[-1], "data") if fsdp else None]
    if last in ("w_gate", "w_up") and nd >= 2:  # dense / shared MLP [.., D, F]
        return [None] * (nd - 2) + [
            ax(shape[-2], "data") if fsdp else None, ax(shape[-1], "model")]
    if last == "w_down" and nd >= 2:  # [.., F, D]
        return [None] * (nd - 2) + [
            ax(shape[-2], "model"), ax(shape[-1], "data") if fsdp else None]
    if last == "router":  # [.., D, E]: contracting-dim sharded (E is small)
        return [None] * (nd - 2) + [ax(shape[-2], "model"), None]
    if last == "in_proj":  # mamba [.., D, 2Di]
        return [None] * (nd - 2) + [
            ax(shape[-2], "data") if fsdp else None, ax(shape[-1], "model")]
    if last == "out_proj":  # [.., Di, D]
        return [None] * (nd - 2) + [
            ax(shape[-2], "model"), ax(shape[-1], "data") if fsdp else None]
    if last in ("conv_w",):  # [.., k, Di]
        return [None] * (nd - 1) + [ax(shape[-1], "model")]
    if last in ("conv_b", "dt_bias", "D"):  # [.., Di]
        return [None] * (nd - 1) + [ax(shape[-1], "model")]
    if last == "x_proj":  # [.., Di, e]
        return [None] * (nd - 2) + [ax(shape[-2], "model"), None]
    if last == "dt_proj":  # [.., dtr, Di]
        return [None] * (nd - 2) + [None, ax(shape[-1], "model")]
    if last == "A_log":  # [.., Di, N]
        return [None] * (nd - 2) + [ax(shape[-2], "model"), None]
    if last == "scale":  # norms
        return [None] * nd
    return None


def _generic_rule(shape: tuple, mesh, fsdp: bool, skip_leading: int):
    ms, ds = _axis_size(mesh, "model"), _axis_size(mesh, "data")
    spec: list = [None] * len(shape)
    order = sorted(range(skip_leading, len(shape)), key=lambda i: -shape[i])
    for i in order:
        if spec[i] is None and _divisible(shape[i], ms):
            spec[i] = "model"
            break
    if fsdp:
        for i in order:
            if spec[i] is None and _divisible(shape[i], ds):
                spec[i] = "data"
                break
    return spec


def param_pspec(path: str, shape: tuple, mesh, fsdp: bool) -> Spec:
    if len(shape) == 0:
        return ()
    # stacked params carry a leading scan-group dim: never shard it
    stacked = "stack" in path
    rule = _named_rule(path, shape, mesh, fsdp)
    if rule is None:
        rule = _generic_rule(shape, mesh, fsdp, 1 if stacked else 0)
        if not stacked and len(shape) == 1:
            rule = [None]
    return tuple(rule)


def path_str(path: tuple) -> str:
    """A leaf's tree path as the rules read it ("stack/slot0/mixer/wq")."""
    return "/".join(str(k) for k in path)


def _specs(tree, fn):
    flat = [fn(path_str(path), tuple(leaf.shape)) for path, leaf in leaves_with_path(tree)]
    return unflatten(tree, flat)


def tree_pspecs(tree, mesh, cfg: Optional[ModelConfig] = None, fsdp=None):
    """The spec tree of a params-like tree."""
    if fsdp is None:
        fsdp = cfg is not None and cfg.param_count() >= FSDP_THRESHOLD
    return _specs(tree, lambda path, shape: param_pspec(path, shape, mesh, fsdp))


# ------------------------------------------------------------- activations
def dp_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def dp_size(mesh) -> int:
    dp = dp_axes(mesh)
    return int(np.prod([_axis_size(mesh, a) for a in (dp if isinstance(dp, tuple) else (dp,))
                        if a]))


def batch_pspec(mesh, ndim: int) -> Spec:
    return (dp_axes(mesh), *([None] * (ndim - 1)))


def cache_pspec(path: str, shape: tuple, mesh) -> Spec:
    """Decode caches: batch over the DP axes, sequence over "model"."""
    dp = dp_axes(mesh)
    ms = _axis_size(mesh, "model")
    last = path.split("/")[-1]
    off = 1 if "stack" in path else 0
    nd = len(shape)
    spec: list = [None] * nd
    bdim = off  # batch dim position
    if nd > bdim and shape[bdim] % dp_size(mesh) == 0:
        spec[bdim] = dp
    if last in ("k", "v", "ckv", "krope", "ck", "cv") and nd > bdim + 1:
        if _divisible(shape[bdim + 1], ms):
            spec[bdim + 1] = "model"
    elif last in ("ssm", "conv", "C", "n", "m", "c", "h") and nd > bdim + 1:
        # recurrent states: shard the inner (channel) dim over model
        for i in range(bdim + 1, nd):
            if _divisible(shape[i], ms):
                spec[i] = "model"
                break
    return tuple(spec)


def cache_pspecs(cache_tree, mesh):
    return _specs(cache_tree, lambda path, shape: cache_pspec(path, shape, mesh))


# ------------------------------------------------------------ tiered MoE
def tiered_pspec(path: str, shape: tuple, mesh) -> Spec:
    """hot: replicated; warm: striped (F over model); cold: localized
    (expert dim over data x model)."""
    sizes = mesh_shape(mesh)
    off = 1 if "stack" in path else 0
    nd = len(shape)
    spec: list = [None] * nd
    ms = _axis_size(mesh, "model")
    if "/hot" in path or path.endswith("hot"):
        pass  # replicated
    elif "/warm" in path or path.endswith("warm"):
        # [.., n, 3, D, F] -> F over model
        if nd >= off + 4 and _divisible(shape[-1], ms):
            spec[-1] = "model"
    elif "/cold" in path or path.endswith("cold"):
        # localized: each cold expert homed on one data row, F striped
        # within the row; the whole (data x model) mesh first for big pools
        n = shape[off]
        full = tuple(a for a in ("data", "model") if a in sizes)
        full_size = int(np.prod([sizes[a] for a in full]))
        if _divisible(n, full_size):
            spec[off] = full
        elif _divisible(n, _axis_size(mesh, "data")):
            spec[off] = "data"
            if nd >= off + 4 and _divisible(shape[-1], ms):
                spec[-1] = "model"
        elif nd >= off + 4 and _divisible(shape[-1], ms):
            spec[-1] = "model"
    return tuple(spec)


def tiered_pspecs(tiered_tree, mesh):
    return _specs(tiered_tree, lambda path, shape: tiered_pspec(path, shape, mesh))


def opt_state_pspecs(opt_state, params_pspecs):
    """Optimizer moments inherit the parameter specs (ZeRO)."""
    return {k: (params_pspecs if k in ("m", "v", "ef") else ()) for k in opt_state}


def report_replicated(params, mesh, cfg=None, min_bytes: int = 1 << 24):
    """(path, shape) of every large fully replicated leaf (a rule's
    escape), sized at 2 bytes an element as the reference sizes them."""
    specs = spec_leaves(tree_pspecs(params, mesh, cfg))
    out = []
    for path, leaf in leaves_with_path(params):
        spec = specs[path]
        if all(s is None for s in spec) and int(np.prod(leaf.shape)) * 2 >= min_bytes:
            out.append((path_str(path), tuple(leaf.shape)))
    return out


def _spec_leaves(specs, path=()):
    """(path, spec) of a spec tree: a spec is a tuple leaf, not a node."""
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from _spec_leaves(specs[k], path + (k,))
    else:
        yield path, specs


def spec_leaves(specs) -> dict:
    """{path: spec} of a spec tree."""
    return dict(_spec_leaves(specs))


def shard_shape(shape: tuple, spec: Spec, mesh) -> tuple:
    """A leaf's per-device shape under `spec` (every sharded dim divides)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        n = _entry_size(entry, mesh)
        if out[i] % n:
            raise ValueError(f"dim {i} of {shape} does not divide over {entry} ({n})")
        out[i] //= n
    return tuple(out)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _entry_size(entry, mesh) -> int:
    return int(np.prod([_axis_size(mesh, a) for a in _entry_axes(entry)]))


def replicas_of(places, mesh) -> int:
    """How many devices hold each element of a DTensor placed as `places`."""
    sizes = list(mesh_shape(mesh).values())
    return int(np.prod([n for n, pl in zip(sizes, places) if not pl.is_shard()]))


# ------------------------------------------------- DTensor placements
def placements(spec: Spec, mesh) -> list:
    """DTensor placements (one per mesh dim, in mesh order) of `spec`: a
    mesh dim named in a spec entry shards that tensor dim, else the leaf
    is replicated over it. An entry naming several mesh dims splits its
    tensor dim over them major first, which is DTensor's nesting of
    placements in mesh order, so the names must come in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def local_chunk(full: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's piece of `full` under `places` (a view): each sharded
    mesh dim, in mesh order, splits the piece along its tensor dim into
    equal parts and keeps the part at this rank's coordinate."""
    coord = mesh.get_coordinate()
    sizes = list(mesh_shape(mesh).values())
    out = full
    for i, pl in enumerate(places):
        if not pl.is_shard():
            continue
        d, n = pl.dim, sizes[i]
        if out.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(full.shape)} is split unevenly over {n}")
        step = out.shape[d] // n
        out = out.narrow(d, coord[i] * step, step)
    return out


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def distribute(full: torch.Tensor, mesh, places):
    """`full` (the same on every rank) stored as a DTensor: each rank
    keeps a copy of its own chunk, with no communication."""
    from torch.distributed.tensor import DTensor

    full = full.to(mesh.device_type)
    local = local_chunk(full, mesh, places).contiguous()
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=full.shape, stride=_contiguous_stride(full.shape))


def shard_tree(tree, mesh, specs):
    """Every leaf of `tree` stored as a DTensor with its spec's placements."""
    by_path = spec_leaves(specs)
    flat = [distribute(leaf, mesh, placements(by_path[path], mesh))
            for path, leaf in leaves_with_path(tree)]
    return unflatten(tree, flat)


def shard_cache(cache, mesh):
    """A decode cache stored as DTensors under `cache_pspecs`: each rank
    keeps its rows (DP axes) and its key shard ("model")."""
    return shard_tree(cache, mesh, cache_pspecs(cache, mesh))


def shard_tiered(tiered, mesh):
    """Tier states stored as DTensors under `tiered_pspecs`: hot
    replicated, warm striped over F, cold homed over data x model."""
    return shard_tree(tiered, mesh, tiered_pspecs(tiered, mesh))


def sharded_zeros(like, specs, mesh, device):
    """Zeros shaped as the (meta) tree `like`, stored as DTensors under
    `specs`: each rank allocates only its own shard."""
    from torch.distributed.tensor import DTensor

    by_path = spec_leaves(specs)
    flat = []
    for path, leaf in leaves_with_path(like):
        spec = by_path[path]
        local = torch.zeros(shard_shape(tuple(leaf.shape), spec, mesh), dtype=leaf.dtype,
                            device=device)
        flat.append(DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                                       shape=leaf.shape,
                                       stride=_contiguous_stride(tuple(leaf.shape))))
    return unflatten(like, flat)


class NamedSharding:
    """A mesh and a spec: where `restore` puts a leaf (the reference's
    jax.sharding.NamedSharding)."""

    def __init__(self, mesh, spec: Spec):
        self.mesh, self.spec = mesh, tuple(spec)

    def place(self, full: torch.Tensor):
        return distribute(full, self.mesh, placements(self.spec, self.mesh))


def named_shardings(mesh, specs):
    """A spec tree (dicts of spec tuples) as a tree of `NamedSharding`s."""
    if isinstance(specs, dict):
        return {k: named_shardings(mesh, v) for k, v in specs.items()}
    return NamedSharding(mesh, specs)


# ------------------------------------------------------------ the active mesh
_ACTIVE = None  # the DeviceMesh model code runs on, or None (one device)
_ACTIVE_BATCH = None  # its global batch's rows (None: they split over the DP axes)


@contextlib.contextmanager
def use_mesh(mesh, batch: Optional[int] = None):
    """Run the model code on `mesh`: its batch rows split over the DP
    axes (or, for a global `batch` that does not divide them, whole on
    every DP shard), so the MoE's global dispatch, aux loss and counts
    exchange what they need over them, and the expert- and sequence-
    parallel hints (models/moe.py, models/attention.py) find their groups
    here."""
    global _ACTIVE, _ACTIVE_BATCH
    prev, _ACTIVE, _ACTIVE_BATCH = (_ACTIVE, _ACTIVE_BATCH), mesh, batch
    try:
        yield mesh
    finally:
        _ACTIVE, _ACTIVE_BATCH = prev


def active_mesh():
    return _ACTIVE


def active_batch() -> Optional[int]:
    """The active mesh's global batch rows, as `use_mesh` was given them."""
    return _ACTIVE_BATCH


def axis_group(mesh, axes) -> Tuple[Any, int, int]:
    """(process group, size, this rank's index) over the mesh dims `axes`
    (one name or several, major first): the ranks that share every other
    coordinate with this one, in mesh order. Kept on the mesh, so each is
    looked up once; groups over several dims are made on every rank in the
    same order."""
    import torch.distributed as dist

    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    cache = mesh.__dict__.setdefault("_axis_groups", {})
    if axes in cache:
        return cache[axes]
    names = list(mesh.mesh_dim_names)
    sizes = mesh_shape(mesh)
    size = int(np.prod([sizes[a] for a in axes]))
    coord = mesh.get_coordinate()
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[names.index(a)]
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        # numpy, not torch ops: a fake-tensor trace may hold the mesh
        ranks = mesh.mesh.numpy().transpose(*rest, *dims).reshape(-1, size)
        group = None
        for row in ranks.tolist():
            g = dist.new_group(row)
            if dist.get_rank() in row:
                group = g
    cache[axes] = (group, size, idx)
    return cache[axes]


def rows_split(mesh, batch: int) -> bool:
    """Whether a global batch of `batch` rows splits over the mesh's DP
    axes; where it does not, every DP shard holds and computes all of them
    (the reference's dry-run replicates such a batch, `cache_pspec` its
    cache's batch dim)."""
    return batch % dp_size(mesh) == 0


def dp_group(mesh, batch: Optional[int] = None) -> Tuple[Any, int, int]:
    """(group, size, row-shard index) over the mesh's DP axes; (None, 1, 0)
    without DP axes or for a global `batch` that does not split over them
    (every shard holds the whole batch: nothing is exchanged over DP)."""
    dp = dp_axes(mesh)
    if dp is None or (batch is not None and not rows_split(mesh, batch)):
        return None, 1, 0
    return axis_group(mesh, dp)


def shard_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows (dim 0) of a global batch leaf: the batch splits
    over the DP axes, pod-major, or stays whole on every DP shard where it
    does not divide them."""
    _, n, idx = dp_group(mesh, x.shape[0])
    step = x.shape[0] // n
    return x[idx * step:(idx + 1) * step]
