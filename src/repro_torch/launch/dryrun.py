"""Per-device memory, FLOPs and collective bytes of every (arch x shape x
mesh) cell under the production sharding rules (port of
repro/launch/dryrun.py).

For each cell this builds the cell's state on the meta device (shapes
and dtypes, nothing allocated), applies the specs of
distributed/sharding.py on the 16 x 16 single-pod or 2 x 16 x 16
multi-pod mesh shape, and counts each device's bytes: params, AdamW
moments and step (train cells), the batch, and the decode cache with the
tiered expert state and the stripped params (decode cells of MoE archs,
as the reference's `build_cell` :159-233 builds them). It also counts the
large leaves the rules leave replicated (`report_replicated`) and says
whether the state fits one 80 GB H100.

With `trace` (the CLI's default) it then runs the port's own step on a
fake world of the mesh's size, the torch counterpart of the reference's
AOT compile of a 512-device program: a "fake" process group (no
devices, collectives return at once) with its DeviceMesh, rank 0's
shards as fake tensors (shapes only) stored as DTensors, and the step
(the mesh train step, `prefill(..., mesh=)`, or the tiered
`decode_step(..., mesh=)`) run under
- `FlopCounterMode`: `cost.flops`, rank 0's FLOPs of matmuls and
  attention (mm / bmm / addmm / baddbmm / convolution / SDPA) only;
  elementwise work is not counted (the reference's HLO cost analysis
  counts every op, and its while loops once);
- `CollectiveCounter`: `collectives`, per kind the bytes of each
  collective's result (the reference sums the result shapes of the
  optimized HLO's collectives) and the counts;
- `MemTracker`: `memory.temp_size_in_bytes`, the peak of what the step
  allocates beside the state it is given (`argument_size_in_bytes`),
  minus its outputs.
A batch that does not split over the DP axes (long_500k's one row) is
whole on every DP rank, as the reference replicates it. xLSTM's prefill
steps its recurrences token by token, so its prefill_32k cells trace two
windows of the token loop (`WINDOW` tokens) and scale them to the cell's
S: every count there is affine in S (no attention, and a prefill's
regroups move weights at any S > 1), so the per-token part is the two
windows' difference over their step difference; the record says
`scaled`, and its temporaries are the larger window's. No `.hlo.zst`
artefacts: nothing is compiled.
JSON goes to `<out>/<arch>__<shape>__<mesh><tag>.json`, the reference's
naming.

  python -m repro_torch.launch.dryrun --arch deepseek-v2-236b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ALL_SHAPES, ASSIGNED, get_config, get_shape, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import (
    axis_group,
    cache_pspecs,
    dp_axes,
    dp_size,
    opt_state_pspecs,
    report_replicated,
    shard_shape,
    sharded_zeros,
    spec_leaves,
    tiered_pspecs,
    tree_pspecs,
)
from repro_torch.kernels import _launch as L
from repro_torch.kernels.backend import trace_kernel_route
from repro_torch.models.layers import make_generator, torch_dtype
from repro_torch.models.model import decode_step, init_params, prefill
from repro_torch.models.moe import moe_sharding_hints
from repro_torch.serving.engine import init_tiered_for_model, strip_expert_weights
from repro_torch.serving.kv_cache import cache_spec
from repro_torch.serving.tiered_moe import tier_sizes
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_step import make_train_step
from repro_torch.tree import leaves_with_path, tree_map

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
H100_BYTES = 80e9  # one H100's HBM
WINDOW = (32, 64)  # the token windows an xLSTM prefill cell traces and scales


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input of the cell (reference :53)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device="meta")
    if shape.kind == "train":
        specs = {"tokens": torch.empty(b, s, **i32), "labels": torch.empty(b, s, **i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": torch.empty(b, s, **i32)}
    else:  # decode: one new token against a seq_len cache
        specs = {"tokens": torch.empty(b, 1, **i32)}
    if cfg.encdec is not None:
        specs["frames"] = torch.empty(b, cfg.encdec.frontend_frames, cfg.d_model,
                                      dtype=torch_dtype(cfg.param_dtype), device="meta")
    return specs


def batch_specs(specs, mesh, batch: int):
    """The batch's specs: rows over the DP axes when they divide (reference
    `_batch_specs_sharded` :74, without sequence parallelism)."""
    bspec = dp_axes(mesh) if batch % dp_size(mesh) == 0 else None
    return {k: (bspec, *([None] * (v.dim() - 1))) for k, v in specs.items()}


def device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of `tree` under the spec tree `specs`."""
    by_path = spec_leaves(specs)
    return sum(int(np.prod(shard_shape(tuple(leaf.shape), by_path[path], mesh)))
               * leaf.element_size() for path, leaf in leaves_with_path(tree))


def cell_state(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Dict[str, Any]:
    """{part: (meta tree, spec tree)} of the state one cell holds."""
    params = init_params(0, cfg, device="meta")
    specs = tree_pspecs(params, mesh, cfg)
    batch = input_specs(cfg, shape)
    out = {"batch": (batch, batch_specs(batch, mesh, shape.global_batch))}
    if shape.kind == "train":
        opt = adamw_init(params)
        out["params"] = (params, specs)
        out["opt"] = (opt, opt_state_pspecs(opt, specs))
    elif shape.kind == "prefill":
        out["params"] = (params, specs)
    else:
        cache = cache_spec(cfg, shape.global_batch, shape.seq_len)
        out["cache"] = (cache, cache_pspecs(cache, mesh))
        if cfg.moe is not None:
            tiered = init_tiered_for_model(make_generator(1, "meta"), cfg, tier_sizes(cfg))
            out["tiered"] = (tiered, tiered_pspecs(tiered, mesh))
            params = strip_expert_weights(params, cfg)
            specs = tree_pspecs(params, mesh, cfg)
        out["params"] = (params, specs)
    return out


# ------------------------------------------------------------- the trace
# c10d op -> the reference's collective kind (its COLLECTIVES, plus the
# broadcast that sends a scan group held by one rank)
KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
}
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def collective_kind(op) -> Optional[str]:
    """The kind of a c10d op (an OpOverload or its packet), or None."""
    name = str(op).split(".")[1] if str(op).startswith("c10d.") else None
    return KINDS.get(name)


class CollectiveCounter:
    """A dispatch mode that counts every c10d collective and sums the bytes
    of its result, per kind; `report()` is the JSON `collectives` entry
    (the reference's keys, bytes per kind and the total `count`, with
    `counts` per kind beside them); `calls` lists each call."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kind = collective_kind(func)
                if kind is not None:
                    # the result: the reduced tensors (all-reduce, broadcast),
                    # else the output operand; either is args[0]
                    n = _nbytes(args[0])
                    counter.bytes[kind] += n
                    counter.counts[kind] += 1
                    dims = tuple(args[0].shape) if isinstance(args[0], torch.Tensor) else None
                    counter.calls.append((kind, dims, n))
                return func(*args, **(kwargs or {}))

        self.mode = _Mode()
        self.bytes = {k: 0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}
        self.calls = []  # (kind, result shape or None (a list), result bytes) of each call

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def report(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {k: float(v) for k, v in self.bytes.items()}
        out["count"] = sum(self.counts.values())
        out["counts"] = dict(self.counts)
        return out


@contextlib.contextmanager
def fake_world(dims: Dict[str, int]):
    """A "fake" process group of the mesh's size (this process is rank 0;
    collectives return at once) and its CPU DeviceMesh."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh

    if dist.is_initialized():
        raise RuntimeError("a fake world needs a process without a process group")
    n = int(np.prod(list(dims.values())))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        mesh = make_mesh(tuple(dims.values()), tuple(dims), "cpu")
        # every group over mesh dims made now: under FakeTensorMode the
        # mesh's rank tensor cannot be read
        names = list(dims)
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(names, r):
                axis_group(mesh, axes)
        yield mesh
    finally:
        dist.destroy_process_group()


def _likes(cfg: ModelConfig, kind: str, batch: int, seq: int, sizes=None,
           tiered_prefill: bool = False, pad_cold_to=None) -> Dict[str, Any]:
    """The meta trees of a cell's step inputs: params (stripped where the
    experts live in tiers), AdamW state (train), tier states (a MoE
    decode, or a prefill through the tiers) and the cache (decode)."""
    params = init_params(0, cfg, device="meta")
    out: Dict[str, Any] = {"params": params}
    if kind == "train":
        out["opt"] = adamw_init(params)
    elif kind == "decode":
        out["cache"] = cache_spec(cfg, batch, seq)
    if cfg.moe is not None and (kind == "decode" or (kind == "prefill" and tiered_prefill)):
        out["tiered"] = init_tiered_for_model(make_generator(1, "meta"), cfg,
                                              sizes or tier_sizes(cfg), pad_cold_to=pad_cold_to)
        out["params"] = strip_expert_weights(params, cfg)
    return out


def _step(cfg: ModelConfig, kind: str, batch: int, seq: int, mesh, likes, device,
          cold_capacity_frac: float = 0.25, cache_len=None):
    """(thunk, inputs): one cell's step on `mesh` (None: one device), its
    inputs zeros shaped as `likes` (fake under FakeTensorMode): rank 0's
    shards as DTensors on a mesh."""
    dp = 1 if mesh is None else dp_size(mesh)
    if batch % dp and kind == "train":
        raise ValueError(f"a batch of {batch} rows does not split over {dp} DP shards")

    def place(part, spec_fn):
        like = likes[part]
        if mesh is None:
            return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), like)
        return sharded_zeros(like, spec_fn(like), mesh, device)

    def param_specs(like):
        return tree_pspecs(like, mesh, cfg)

    i32 = dict(dtype=torch.int32, device=device)
    p = place("params", param_specs)
    if kind == "train":
        o = place("opt", lambda like: opt_state_pspecs(like, param_specs(likes["params"])))
        b = {"tokens": torch.zeros(batch, seq, **i32), "labels": torch.zeros(batch, seq, **i32)}
        if cfg.encdec is not None:
            b["frames"] = torch.zeros(batch, cfg.encdec.frontend_frames, cfg.d_model,
                                      dtype=torch_dtype(cfg.param_dtype), device=device)
        step = make_train_step(cfg, mesh=mesh)

        def train():
            # the reference's dry-run sets the MoE hints for every cell:
            # each "model" rank keeps its E/m routed experts
            with moe_sharding_hints(enable=mesh is not None):
                return step(p, o, b)

        return train, [p, o, b]
    rows = batch // dp if batch % dp == 0 else batch  # else whole on every DP rank
    tiered = None if "tiered" not in likes else place(
        "tiered", lambda like: tiered_pspecs(like, mesh))
    if kind == "prefill":
        toks = torch.zeros(rows, seq, **i32)
        frames = None if cfg.encdec is None else torch.zeros(
            rows, cfg.encdec.frontend_frames, cfg.d_model, dtype=torch_dtype(cfg.param_dtype),
            device=device)
        return (lambda: prefill(p, cfg, toks, cache_len, tiered=tiered,
                                cold_capacity_frac=cold_capacity_frac, frames=frames, mesh=mesh,
                                batch=None if mesh is None else batch)), \
            [p, tiered, toks, frames]
    cache = place("cache", lambda like: cache_pspecs(like, mesh))
    toks = torch.zeros(rows, 1, **i32)
    return (lambda: decode_step(p, cfg, toks, cache, seq - 1, tiered=tiered,
                                cold_capacity_frac=cold_capacity_frac, mesh=mesh)), \
        [p, tiered, cache, toks]


def _local_tensors(tree) -> list:
    """Every tensor of a tree (lists and tuples too), a DTensor's local one."""
    from torch.distributed.tensor import DTensor

    out = []
    for _, t in leaves_with_path(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            out.append(t)
    return out


def trace_cell(cfg: ModelConfig, kind: str, batch: int, seq: int,
               dims: Optional[Dict[str, int]] = None, sizes=None,
               cold_capacity_frac: float = 0.25, tiered_prefill: bool = False, cache_len=None,
               pad_cold_to=None) -> Dict[str, Any]:
    """Rank 0's FLOPs, collectives and memory of one step (`kind` train,
    prefill or decode; `batch` global rows of `seq` tokens, the decode
    cache `seq` long; a prefill's `cache_len` slots, through the tiers
    with `tiered_prefill`) on a fake world of the mesh `dims` ({axis: size}),
    or on one device when `dims` is None. Every tensor is a fake one:
    nothing is allocated and nothing runs. The route is the card's
    (kernels/backend.py `trace_kernel_route`): each kernel launch stands
    in as its output and its FLOPs, not as the plain version the CPU would
    run, whose temporaries the kernel never makes (moe_gemm's gathers each
    row tile's weights in fp32)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.time()
    likes = _likes(cfg, kind, batch, seq, sizes, tiered_prefill, pad_cold_to)
    world = fake_world(dims) if dims is not None else contextlib.nullcontext(None)
    with world as mesh, FakeTensorMode(), torch.no_grad() if kind != "train" else \
            contextlib.nullcontext():
        run, inputs = _step(cfg, kind, batch, seq, mesh, likes, "cpu", cold_capacity_frac,
                            cache_len)
        args = _local_tensors(inputs)
        flops, coll, mem = FlopCounterMode(display=False), CollectiveCounter(), MemTracker()
        mem.track_external(*args)
        kernel_flops = L.TRACE_FLOPS["flops"]
        with trace_kernel_route(), flops, coll, mem:
            out = run()
        kernel_flops = L.TRACE_FLOPS["flops"] - kernel_flops
        # the device's: meta tensors (the cache's shape tree) hold no memory
        peak = sum(v["Total"] for dev, v in mem.get_tracker_snapshot("peak").items()
                   if dev.type == args[0].device.type)
        arg_bytes = sum(_nbytes(t) for t in args)
        seen = {id(t) for t in args}
        out_bytes = sum(_nbytes(t) for t in _local_tensors(out) if id(t) not in seen)
    return {
        "cost": {"flops": float(flops.get_total_flops() + kernel_flops),
                 "kernel_flops": float(kernel_flops),
                 "flops_counted": "rank 0's matmuls and attention (FlopCounterMode) and "
                                  "expert kernels (2 M K N a GEMM)"},
        "collectives": coll.report(),
        "memory": {"argument_size_in_bytes": float(arg_bytes),
                   "output_size_in_bytes": float(out_bytes),
                   "temp_size_in_bytes": float(peak - arg_bytes),
                   "peak_bytes": float(peak)},
        "trace_s": round(time.time() - t0, 2),
    }


def windowed(cfg: ModelConfig, kind: str, seq: int) -> bool:
    """Whether a cell traces `WINDOW` and scales: an xLSTM prefill longer
    than the windows (a Python step a token on every layer)."""
    return cfg.xlstm is not None and kind == "prefill" and seq > WINDOW[1]


def trace_scaled(cfg: ModelConfig, kind: str, batch: int, seq: int, dims=None,
                 window=WINDOW) -> Dict[str, Any]:
    """`trace_cell` of a prefill whose every count is affine in the tokens
    (a recurrent arch's), at the two `window` lengths, scaled to `seq`: v =
    v(w0) + (seq - w0) (v(w1) - v(w0)) / (w1 - w0) for the FLOPs and each
    kind's collective bytes and counts; memory is the w1 window's."""
    if cfg.xlstm is None:  # attention (or a Mamba chunk's scan) is not affine in S
        raise ValueError(f"{cfg.name}'s counts are not affine in the tokens")
    w0, w1 = window
    a, b = (trace_cell(cfg, kind, batch, w, dims) for w in (w0, w1))

    def scale(x, y):
        if isinstance(x, dict):
            return {k: scale(x[k], y[k]) for k in x}
        if isinstance(x, str):
            return x
        v = x + (seq - w0) * (y - x) / (w1 - w0)
        return type(x)(v) if isinstance(x, int) else v

    return {"cost": scale(a["cost"], b["cost"]),
            "collectives": scale(a["collectives"], b["collectives"]),
            "memory": b["memory"],
            "scaled": {"from_steps": [w0, w1], "to_steps": seq,
                       "memory": f"the {w1}-token window's"},
            "trace_s": round(a["trace_s"] + b["trace_s"], 2)}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str | None = None,
             tag: str = "", trace: bool = False) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = shape_applicable(cfg, shape)
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        result["skipped"] = why
        return result
    mesh = MESHES[mesh_kind]
    state = cell_state(cfg, shape, mesh)
    per_device = {part: device_bytes(tree, specs, mesh) for part, (tree, specs) in state.items()}
    total = sum(per_device.values())
    replicated = report_replicated(state["params"][0], mesh, cfg)
    result.update(
        n_devices=int(np.prod(list(mesh.values()))), bytes_per_device=per_device,
        state_bytes_per_device=total, replicated_large_leaves=len(replicated),
        state_fits_h100_80gb=total <= H100_BYTES,
    )
    line = (f"[dryrun] {arch} x {shape_name} x {mesh_kind}: "
            + " ".join(f"{k}={v / 1e9:.3f}GB" for k, v in per_device.items())
            + f" replicated={len(replicated)} fits_80GB={total <= H100_BYTES}")
    if trace:
        tracer = trace_scaled if windowed(cfg, shape.kind, shape.seq_len) else trace_cell
        traced = tracer(cfg, shape.kind, shape.global_batch, shape.seq_len, mesh)
        result.update(traced)
        line += (f" flops={traced['cost']['flops']:.3e} coll_bytes="
                 f"{sum(v for k, v in traced['collectives'].items() if k in COLLECTIVES):.3e}"
                 f" temp={traced['memory']['temp_size_in_bytes'] / 1e9:.3f}GB"
                 f" ({traced['trace_s']}s{', scaled' if 'scaled' in traced else ''})")
    print(line, flush=True)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{mesh_kind}{tag}.json".replace("/", "_")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--no-trace", action="store_true",
                    help="state bytes only: no fake-world trace of the step")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = ([s.name for s in ALL_SHAPES] if (args.all or args.shape is None)
              else [args.shape])
    return [run_cell(arch, shape, mk, args.out, args.tag, trace=not args.no_trace)
            for arch in archs for shape in shapes for mk in meshes]


if __name__ == "__main__":
    main()
