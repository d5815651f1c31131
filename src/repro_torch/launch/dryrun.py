"""Per-device memory of every (arch x shape x mesh) cell under the
production sharding rules (port of what repro/launch/dryrun.py reports
that the rules decide).

For each cell this builds the cell's state on the meta device (shapes
and dtypes, nothing allocated), applies the specs of
distributed/sharding.py on the abstract 16 x 16 single-pod or 2 x 16 x 16
multi-pod mesh shape (no process group, no device), and counts each
device's bytes: params, AdamW moments and step (train cells), the batch,
and the decode cache with the tiered expert state and the stripped
params (decode cells of MoE archs, as the reference's `build_cell`
:159-233 builds them). It also counts the large leaves the rules leave
replicated (`report_replicated`) and says whether the state fits one
80 GB H100. JSON goes to `<out>/<arch>__<shape>__<mesh><tag>.json`, the
reference's naming.

Not ported, because torch has no counterpart to AOT-compiling a
512-device XLA program: HLO `cost_analysis` FLOPs and bytes,
`memory_analysis` temporaries (so the state bytes here exclude
activations and workspace), per-collective bytes from the optimized HLO,
and the `.hlo.zst` artefacts benchmarks/roofline.py reads.

  python -m repro_torch.launch.dryrun --arch deepseek-v2-236b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import ALL_SHAPES, ASSIGNED, get_config, get_shape, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import (
    cache_pspecs,
    dp_axes,
    dp_size,
    opt_state_pspecs,
    report_replicated,
    shard_shape,
    spec_leaves,
    tiered_pspecs,
    tree_pspecs,
)
from repro_torch.models.layers import make_generator, torch_dtype
from repro_torch.models.model import init_params
from repro_torch.serving.engine import init_tiered_for_model, strip_expert_weights
from repro_torch.serving.kv_cache import cache_spec
from repro_torch.serving.tiered_moe import tier_sizes
from repro_torch.training.optimizer import adamw_init
from repro_torch.tree import leaves_with_path

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
H100_BYTES = 80e9  # one H100's HBM


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


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str | None = None,
             tag: str = "") -> Dict[str, Any]:
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
    print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: "
          + " ".join(f"{k}={v / 1e9:.3f}GB" for k, v in per_device.items())
          + f" replicated={len(replicated)} fits_80GB={total <= H100_BYTES}")
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
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = ([s.name for s in ALL_SHAPES] if (args.all or args.shape is None)
              else [args.shape])
    return [run_cell(arch, shape, mk, args.out, args.tag)
            for arch in archs for shape in shapes for mk in meshes]


if __name__ == "__main__":
    main()
