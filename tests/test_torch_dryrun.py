"""The port's dry-run memory report (repro_torch/launch/dryrun.py) against
the reference's own specs: for every applicable (ASSIGNED arch x shape)
cell on the single-pod and multi-pod mesh shapes, each part's bytes per
device (params, AdamW state, batch, decode cache, tiered experts) equal
what the reference's specs imply for its `jax.eval_shape` trees (each
leaf's bytes over the product of the axis sizes its spec names), built
as the reference's `build_cell` builds them; no compile. Then the
port's dry-run CLI on one cell."""
import json

import jax
import numpy as np
import pytest

import repro.distributed.sharding as jsh
from repro.configs import ALL_SHAPES, ASSIGNED, get_config, shape_applicable
from repro.models.model import init_cache, init_params
from repro.serving.engine import init_tiered_for_model, strip_expert_weights
from repro.serving.tiered_moe import tier_sizes
from repro.training.optimizer import adamw_init
from repro_torch.launch import dryrun


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _bytes(tree, specs, mesh):
    leaves = jax.tree_util.tree_leaves(tree)
    flat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(flat)
    total = 0
    for leaf, spec in zip(leaves, flat):
        n = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                n *= mesh.shape[a] if a else 1
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // n
    return total


def _reference_cell(cfg, shape, mesh):
    """{part: bytes per device} from the reference's trees and specs."""
    params = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
    specs = jsh.tree_pspecs(params, mesh, cfg)
    b, s = shape.global_batch, shape.seq_len
    i32 = jax.numpy.int32
    batch = {"tokens": jax.ShapeDtypeStruct((b, s if shape.kind != "decode" else 1), i32)}
    if shape.kind == "train":
        batch["labels"] = jax.ShapeDtypeStruct((b, s), i32)
    if cfg.encdec is not None:
        batch["frames"] = jax.ShapeDtypeStruct((b, cfg.encdec.frontend_frames, cfg.d_model),
                                               jax.numpy.dtype(cfg.param_dtype))
    dp = jsh.dp_axes(mesh)
    dp_n = int(np.prod([mesh.shape[a] for a in (dp if isinstance(dp, tuple) else (dp,))]))
    bspec = dp if b % dp_n == 0 else None
    bspecs = {k: jax.sharding.PartitionSpec(bspec, *([None] * (len(v.shape) - 1)))
              for k, v in batch.items()}
    out = {"batch": _bytes(batch, bspecs, mesh)}
    if shape.kind == "train":
        opt = jax.eval_shape(lambda: adamw_init(params))
        out["params"] = _bytes(params, specs, mesh)
        out["opt"] = _bytes(opt, jsh.opt_state_pspecs(opt, specs), mesh)
    elif shape.kind == "prefill":
        out["params"] = _bytes(params, specs, mesh)
    else:
        cache = jax.eval_shape(lambda: init_cache(cfg, b, s))
        out["cache"] = _bytes(cache, jsh.cache_pspecs(cache, mesh), mesh)
        if cfg.moe is not None:
            tiered = jax.eval_shape(
                lambda: init_tiered_for_model(jax.random.PRNGKey(1), cfg, tier_sizes(cfg)))
            out["tiered"] = _bytes(tiered, jsh.tiered_pspecs(tiered, mesh), mesh)
            params = strip_expert_weights(params, cfg)
            specs = jsh.tree_pspecs(params, mesh, cfg)
        out["params"] = _bytes(params, specs, mesh)
    return out


@pytest.mark.parametrize("arch", ASSIGNED)
def test_bytes_per_device_equal_reference_specs(arch):
    cfg = get_config(arch)
    n_cells = 0
    for shape in ALL_SHAPES:
        ok, _ = shape_applicable(cfg, shape)
        got_single = dryrun.run_cell(arch, shape.name, "single")
        if not ok:
            assert "skipped" in got_single
            continue
        for kind, mesh in dryrun.MESHES.items():
            got = dryrun.run_cell(arch, shape.name, kind)
            want = _reference_cell(cfg, shape, FakeMesh(mesh))
            assert got["bytes_per_device"] == want, (shape.name, kind)
            assert got["state_bytes_per_device"] == sum(want.values())
            assert got["state_fits_h100_80gb"] == (sum(want.values()) <= 80e9)
            n_cells += 1
    assert n_cells >= 4


def test_dryrun_cli_writes_one_cell(tmp_path):
    dryrun.main(["--arch", "deepseek-v2-236b", "--shape", "decode_32k", "--mesh", "both",
                 "--out", str(tmp_path)])
    for kind in ("single", "multi"):
        res = json.loads((tmp_path / f"deepseek-v2-236b__decode_32k__{kind}.json").read_text())
        assert res["n_devices"] == (256 if kind == "single" else 512)
        assert set(res["bytes_per_device"]) == {"batch", "cache", "tiered", "params"}
        assert res["replicated_large_leaves"] == 0
