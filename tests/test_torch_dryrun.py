"""The port's dry-run memory report (repro_torch/launch/dryrun.py) against
the reference's own specs: for every applicable (ASSIGNED arch x shape)
cell on the single-pod and multi-pod mesh shapes, each part's bytes per
device (params, AdamW state, batch, decode cache, tiered experts) equal
what the reference's specs imply for its `jax.eval_shape` trees (each
leaf's bytes over the product of the axis sizes its spec names), built
as the reference's `build_cell` builds them; no compile. Then the
port's dry-run CLI on one cell (bytes), its fake-world trace of smoke
cells (granite and jamba decode, seamless prefill) against a real 4-rank
gloo run of each, every assigned arch's serving cells traced on a fake
mesh (none is left untraced), xLSTM's windowed prefill trace against a
full one, and the CLI's trace of one production cell on 256 fake
ranks."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

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


# ------------------------------------------------- the fake-world trace
@pytest.fixture(scope="module")
def gloo_cells(tmp_path_factory):
    """The smoke cells' collectives in a real 4-rank gloo run on (2, 2)
    (tests/torch_mesh_serve_worker.py, mode "dryrun"), by cell name."""
    import torch_mesh_serve_worker as worker

    out = worker.spawn_world(tmp_path_factory.mktemp("dryrun_cell"), "dryrun", 180)
    return out["dryrun_cells"]


def _assert_same_collectives(traced, gloo_cell):
    coll = traced["collectives"]
    for kind in dryrun.COLLECTIVES:
        assert coll["counts"][kind] == gloo_cell["comm_debug_counts"].get(kind, 0), kind
        assert coll["counts"][kind] == gloo_cell["counter"]["counts"][kind], kind
        assert coll[kind] == gloo_cell["counter"][kind], kind


def test_fake_trace_matches_gloo_run_and_divides_flops(gloo_cells):
    """The fake-world trace of the smoke decode cell on (2, 2) records the
    kinds, counts and bytes of collectives that CommDebugMode and the
    CollectiveCounter record in the real run; its FLOPs are the unsharded
    trace's divided as the specs say: by 4 (rows over data; heads, keys,
    the router's D, warm F, cold slots and vocab over model) but the hot
    tier's, replicated over model, by 2 (rows only)."""
    import torch_mesh_serve_worker as worker
    from repro_torch.serving.tiered_moe import TierSizes

    c = worker.DRYRUN_CELLS["granite"]
    cfg = worker.port_cfg(c["arch"])
    sizes = TierSizes(*c["sizes"])
    traced = dryrun.trace_cell(cfg, "decode", c["batch"], c["seq"], {"data": 2, "model": 2},
                               sizes=sizes)
    _assert_same_collectives(traced, gloo_cells["granite"])
    coll = traced["collectives"]
    assert coll["counts"]["all-reduce"] and coll["counts"]["reduce-scatter"]
    whole = dryrun.trace_cell(cfg, "decode", c["batch"], c["seq"], None, sizes=sizes)
    assert whole["collectives"]["count"] == 0
    # the hot tier's plain expert FFN: three [n_hot, B, D] x [D, F] products a layer
    hot = cfg.n_layers * 6 * sizes.n_hot * c["batch"] * cfg.d_model * cfg.moe.d_expert
    want = (whole["cost"]["flops"] - hot) / 4 + hot / 2
    assert traced["cost"]["flops"] == want, (traced["cost"]["flops"], want)
    mem = traced["memory"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0


def test_fake_train_trace_matches_gloo_run_and_splits_flops(gloo_cells):
    """granite-moe's smoke train cell (forward, backward and AdamW of the
    mesh step) on a fake (2, 2) world records the collectives (kinds,
    counts, bytes) of a real gloo run of the same step, and its rank's
    FLOPs are at most 0.3 of the unsharded step's: rows over "data" and
    every split matmul over "model" halve them twice (about 0.25; the
    router's fp32 logits and the norms stay whole per row)."""
    import torch_mesh_serve_worker as worker

    c = worker.DRYRUN_CELLS["granite_train"]
    cfg = worker.port_cfg(c["arch"])
    traced = dryrun.trace_cell(cfg, "train", c["batch"], c["seq"], {"data": 2, "model": 2})
    _assert_same_collectives(traced, gloo_cells["granite_train"])
    assert traced["collectives"]["counts"]["all-reduce"] > 0
    whole = dryrun.trace_cell(cfg, "train", c["batch"], c["seq"], None)
    assert whole["collectives"]["count"] == 0
    ratio = traced["cost"]["flops"] / whole["cost"]["flops"]
    assert 0 < ratio <= 0.3, ratio
    assert traced["memory"]["temp_size_in_bytes"] < whole["memory"]["temp_size_in_bytes"]


def test_dryrun_cli_traces_granite_decode_on_256_ranks(tmp_path):
    """The CLI's default trace of one cell on the single-pod mesh: a fake
    world of 256 ranks, within 60 s."""
    root = Path(__file__).resolve().parents[1]
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "granite-moe-1b-a400m",
         "--shape", "decode_32k", "--mesh", "single", "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert time.time() - t0 < 60
    res = json.loads((tmp_path / "granite-moe-1b-a400m__decode_32k__single.json").read_text())
    assert res["n_devices"] == 256
    assert res["cost"]["flops"] > 0
    coll = res["collectives"]
    assert coll["count"] > 0 and coll["reduce-scatter"] > 0 and coll["all-gather"] > 0
    assert res["memory"]["argument_size_in_bytes"] == res["state_bytes_per_device"]
    assert res["memory"]["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("name", ["jamba", "seamless"])
def test_fake_trace_matches_gloo_run_of_recurrent_and_encdec_cells(gloo_cells, name):
    """jamba's smoke decode cell (Mamba's regroup all-to-alls and x_proj
    sums, tiered MoE) and seamless's smoke prefill cell (the encoder,
    cross K/V resharded to frames): the fake-world trace on (2, 2) records
    the collectives of a real gloo run of the same step, kind by kind."""
    import torch_mesh_serve_worker as worker
    from repro_torch.serving.tiered_moe import TierSizes

    c = worker.DRYRUN_CELLS[name]
    sizes = None if c["sizes"] is None else TierSizes(*c["sizes"])
    traced = dryrun.trace_cell(worker.port_cfg(c["arch"]), c["kind"], c["batch"], c["seq"],
                               {"data": 2, "model": 2}, sizes=sizes)
    _assert_same_collectives(traced, gloo_cells[name])
    assert traced["collectives"]["counts"]["all-to-all"] > 0
    assert traced["cost"]["flops"] > 0 and traced["memory"]["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_serving_cell_traces(arch):
    """No serving cell is left untraced: every assigned arch's prefill and
    decode (the smoke config, fp32) trace on a fake (2, 2) world, and so
    does a decode of one row, which stays whole on both DP ranks (the
    long_500k cells' batch of 1)."""
    import torch_mesh_serve_worker as worker

    assert not hasattr(dryrun, "untraced_reason")
    cfg = worker.port_cfg(arch)
    two = {"data": 2, "model": 2}
    for kind, batch in (("prefill", 4), ("decode", 4), ("decode", 1)):
        res = dryrun.trace_cell(cfg, kind, batch, 8, two)
        assert res["cost"]["flops"] > 0, (kind, batch)
        assert res["collectives"]["count"] > 0, (kind, batch)


def test_windowed_xlstm_prefill_equals_full_trace():
    """xLSTM's prefill cells trace two windows of the token loop and scale
    them to S: at a small S the scaled FLOPs, collective bytes and counts
    equal a full trace's."""
    import torch_mesh_serve_worker as worker

    cfg = worker.port_cfg("xlstm-125m")
    two = {"data": 2, "model": 2}
    full = dryrun.trace_cell(cfg, "prefill", 4, 24, two)
    scaled = dryrun.trace_scaled(cfg, "prefill", 4, 24, two, window=(8, 16))
    assert scaled["cost"] == full["cost"]
    assert scaled["collectives"] == full["collectives"]
    assert scaled["scaled"]["from_steps"] == [8, 16] and scaled["scaled"]["to_steps"] == 24
    assert dryrun.windowed(get_config("xlstm-125m"), "prefill", 32768)
    assert not dryrun.windowed(get_config("jamba-v0.1-52b"), "prefill", 32768)
