"""The port's serving functions on a device mesh against the JAX package's
single program. One world of 4 gloo ranks (tests/torch_mesh_serve_worker.py,
torch and the port only) runs every case once; it joins through a file in
this test's temp dir, every collective times out after 60 s, and the whole
world must finish within DEADLINE_S or the test fails with the ranks' logs.

Each case of the worker's CASES runs on (2, 2), (1, 4) and the (2, 1, 2)
multi-pod mesh (as it names them): the port's mesh `prefill` of the rank's
rows of 4 prompts, then 4 mesh `decode_step`s, against the reference's
`prefill` / `decode_step(..., tiered=)` on the whole batch with the same
params and tiers. The ten archs at fp32 smoke configs: the dense five
keep their published G (query heads 6, 6, 10 do not divide a 4-wide
"model" axis; granite-20b is MQA, once more with FSDP storage), granite-
moe and deepseek with tier states whose cold pool is homed over data x
model, or over data with F striped, a cold tier that drops at capacity
(its drops held to the global order across the DP shards), and the flat
expert-parallel MoE at its capacity factor; jamba (Mamba channel-
parallel, tiered MoE), xlstm-125m with its mLSTM state split over heads
and, with 2 heads on (1, 4), along the key index, and seamless-m4t (the
encoder over the rows' 16 frames, cross K/V split over frames, a vocab
that does not divide 4). A batch of 1 on (2, 2) (granite-moe, jamba)
stays whole on both DP ranks. Tokens are equal; logits, caches (the
recurrent states and cross K/V too) and the global expert counts within
1e-5 of the reference's largest element (MLA within 1e-4, as
tests/test_seq_parallel.py), counts exactly. No all-gather of a decode
step has the size of a cache leaf (the rank's rows, every key or
channel; sLSTM's h aside: each step's h @ r needs the whole h) or of a
tier buffer."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_serve_worker as worker
from repro.checkpoint import save as jax_save
from repro.configs import get_config, reduce_for_smoke
from repro.models import model as jmodel
from repro.serving.engine import moe_slot_names, strip_expert_weights
from repro.serving.tiered_moe import TierSizes, init_tiered_state

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import keep_groups  # noqa: E402

WORLD = 4
DEADLINE_S = 180  # a hang guard: the world takes ~22 s on an idle 8-core host
TOL, MLA_TOL = 1e-5, 1e-4


def jax_cfg(arch, config=()):
    cfg = reduce_for_smoke(get_config(arch))
    if arch in worker.DENSE:
        return keep_groups(cfg, get_config(arch))
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                               moe_backend="ref", **dict(config))


def jax_tiered(cfg, sizes, pad, key):
    """The reference's `init_tiered_for_model` with the cold pool padded to
    `pad` (its own pads to 16)."""
    layers, slots, n_groups = moe_slot_names(cfg)
    sizes = TierSizes(*sizes)
    out = {}
    for name in layers:
        key, k = jax.random.split(key)
        out[name] = init_tiered_state(k, cfg, sizes, pad)
    if slots:
        def one_group(k):
            ks = jax.random.split(k, len(slots))
            return {s: init_tiered_state(ks[i], cfg, sizes, pad) for i, s in enumerate(slots)}

        key, k = jax.random.split(key)
        out["stack"] = jax.vmap(one_group)(jax.random.split(k, n_groups))
    return jax.tree.map(np.asarray, out)


_PARAMS = {}


def arch_params(cfg):
    """The reference's seeded params of a config, made once."""
    if cfg not in _PARAMS:
        params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), cfg))
        if cfg.qkv_bias:  # zeros at init: give the biases values to carry
            rng = np.random.default_rng(1)
            for k in ("bq", "bk", "bv"):
                leaf = params["stack"]["slot0"]["mixer"][k]
                params["stack"]["slot0"]["mixer"][k] = rng.normal(size=leaf.shape).astype(
                    np.float32) * 0.5
        _PARAMS[cfg] = params
    return _PARAMS[cfg]


def case_state(case):
    cfg = jax_cfg(case.arch, case.config)
    state = {"params": arch_params(cfg)}
    if case.sizes is not None:
        state["tiered"] = jax_tiered(cfg, case.sizes, case.pad, jax.random.PRNGKey(1))
    return cfg, state


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    io = tmp_path_factory.mktemp("mesh_serve")
    states = {}
    for name, case in worker.CASES.items():
        states[name] = case_state(case)
        jax_save(str(io / name.replace("/", "_")), 0, states[name][1])
    out = worker.spawn_world(io, "serve", DEADLINE_S, WORLD)
    return states, out, out.pop("arrays")


_REFERENCE = {}


def reference(name, states):
    """The reference's one program on the whole batch, greedy: (prefill
    logits, cache), then per decode step (tokens fed, logits, counts), and
    the final cache."""
    if name in _REFERENCE:
        return _REFERENCE[name]
    case = worker.CASES[name]
    cfg, state = states[name]
    params, tiered = state["params"], state.get("tiered")
    if tiered is not None:
        params = strip_expert_weights(params, cfg)
    first = worker.B - case.batch
    toks, lens = (a[first:] for a in worker.prompts(cfg.vocab_size))
    mask = (np.arange(worker.S)[None, :] < lens[:, None]) if case.masked else None
    kw = dict(tiered=None if tiered is None else jax.tree.map(jnp.asarray, tiered),
              cold_capacity_frac=case.frac)
    p = jax.tree.map(jnp.asarray, params)
    batch = {"tokens": jnp.asarray(toks)}
    frames = worker.frames(cfg)
    if frames is not None:
        batch["frames"] = jnp.asarray(frames[first:])
    logits, cache = jmodel.prefill(p, cfg, batch, worker.CACHE,
                                   token_mask=None if mask is None else jnp.asarray(mask),
                                   **kw)
    out = {"prefill_logits": np.asarray(logits), "prefill_cache": jax.tree.map(np.asarray, cache)}
    pos = lens if case.masked else np.full(case.batch, worker.S, np.int32)
    tok = np.asarray(logits).argmax(-1)[:, None].astype(np.int32)
    steps = []
    for step in range(worker.DECODE_STEPS):
        logits, cache, counts = jmodel.decode_step(p, cfg, jnp.asarray(tok), cache,
                                                   jnp.asarray(pos + step), **kw)
        steps.append((tok, np.asarray(logits), np.asarray(counts)))
        tok = np.asarray(logits).argmax(-1)[:, None].astype(np.int32)
    out["steps"] = steps
    out["decode_cache"] = jax.tree.map(np.asarray, cache)
    _REFERENCE[name] = out
    return out


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield "|".join(prefix), tree


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


RUNS = [(name, m) for name, case in worker.CASES.items() for m in case.meshes]


@pytest.mark.parametrize("name,mesh", RUNS, ids=[f"{n}@{m}" for n, m in RUNS])
def test_mesh_prefill_and_decode_match_reference(world, name, mesh):
    states, out, arrays = world
    ref = reference(name, states)
    key = f"{name}@{mesh}"
    tol = MLA_TOL if "deepseek" in name else TOL
    assert _rel(arrays[f"{key}/prefill_logits"], ref["prefill_logits"]) < tol
    for what in ("prefill_cache", "decode_cache"):
        for path, want in _flat(ref[what]):
            got = arrays[f"{key}/{what}/{path}"]
            assert got.shape == want.shape, (what, path)
            assert _rel(got, want) < tol, (what, path, _rel(got, want))
    for i, (tok, logits, counts) in enumerate(ref["steps"]):
        np.testing.assert_array_equal(arrays[f"{key}/tokens"][i], tok, err_msg=f"step {i}")
        assert _rel(arrays[f"{key}/decode_logits"][i], logits) < tol, i
        np.testing.assert_array_equal(arrays[f"{key}/counts"][i], counts, err_msg=f"step {i}")
    gathers = out["gathers"][key]
    assert gathers["cache_or_tier"] == [], gathers


def test_cold_tier_drops_at_capacity(world):
    """The drop case's cold experts receive more assignments than the
    cold capacity: at the prefill (32 tokens) and at a decode step."""
    states, _, _ = world
    case = worker.CASES["granite-moe/drops"]
    cfg, state = states["granite-moe/drops"]
    tier = state["tiered"]["stack"]["slot0"]["expert_tier"][0]
    cold = tier == 2
    ref = reference("granite-moe/drops", states)
    k = cfg.moe.top_k
    cap = max(k, int(worker.B * case.frac + 0.999))
    over = [int(np.max(np.where(cold, counts, 0).max(-1))) > cap
            for _, _, counts in ref["steps"]]
    assert any(over), (cap, [c.tolist() for _, _, c in ref["steps"]])


def test_mesh_train_step_takes_stacks_split_over_layers(world):
    """The rules split a stacked dense MLP [L, D, F] over its layers when L
    divides "model" (read as experts); the mesh train step gathers such a
    stack along the layer dim before taking its scan groups: its loss and
    gradients equal the unsharded step's (the worker compares the port with
    itself; the unsharded step is held to the reference elsewhere)."""
    _, out, _ = world
    assert out["train_stacked_split_err"] < 1e-5
