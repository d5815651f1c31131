"""Model-level parity of the PyTorch port against the JAX package on
bridged weights and the same seeded numpy inputs: layers, the tiered
MoE runtime, migrations, and the paged decode / chunk prefill entry
points of the granite smoke config.

All comparisons run at fp32 (the reference's own token-identity
regime); tolerances allow fp32 summation-order differences only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.configs import get_config, reduce_for_smoke
from repro.models import layers as jlayers
from repro.models.model import decode_step_paged as jax_decode_step_paged
from repro.models.model import init_params as jax_init_params
from repro.models.model import prefill_paged as jax_prefill_paged
from repro.serving.engine import fill_tiers_from_params as jax_fill_tiers
from repro.serving.kv_cache import cache_bytes as jax_cache_bytes
from repro.serving.engine import init_tiered_for_model as jax_init_tiered
from repro.serving.paged_kv import init_paged_cache as jax_init_paged_cache
from repro.serving.tiered_moe import apply_migrations as jax_apply_migrations
from repro.serving.tiered_moe import tiered_moe_forward as jax_tiered_moe_forward
from repro_torch.bridge import to_torch
from repro_torch.models import layers as tlayers
from repro_torch.models.model import decode_step_paged, init_params, prefill_paged
from repro_torch.serving.engine import fill_tiers_from_params, init_tiered_for_model
from repro_torch.serving.kv_cache import cache_bytes
from repro_torch.serving.paged_kv import init_paged_cache
from repro_torch.serving.tiered_moe import (
    TierSizes,
    apply_migrations,
    tier_sizes,
    tiered_moe_forward,
)

ARCH = "granite-moe-1b-a400m"
ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]
ATOL = RTOL = 1e-5


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


_SMOKE = {}


def _smoke(arch):
    """(JAX config, port config, host (params, tiered)) of an fp32 smoke
    config, built once per arch."""
    if arch not in _SMOKE:
        jcfg = _f32(reduce_for_smoke(get_config(arch)))
        tcfg = _f32(tcfgs.reduce_for_smoke(tcfgs.get_config(arch)))
        params = jax_init_params(jax.random.PRNGKey(0), jcfg)
        sizes = TierSizes(2, 2, 4)
        tiered = jax_fill_tiers(params, jax_init_tiered(jax.random.PRNGKey(1), jcfg, sizes),
                                jcfg)
        _SMOKE[arch] = jcfg, tcfg, jax.tree.map(np.asarray, (params, tiered))
    return _SMOKE[arch]


@pytest.fixture(scope="module")
def smoke():
    return _smoke(ARCH)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 1000, size=(2, 5)).astype(np.int32)
    _close(tlayers.rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x), 1e-5),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5))
    _close(tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), 1e4),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), atol=1e-4)
    _close(tlayers.rope_frequencies(16, 1e4), jlayers.rope_frequencies(16, 1e4))


def _moe_inputs(smoke, s):
    jcfg, tcfg, (params, tiered) = smoke
    p = jax.tree.map(lambda a: a[0], params["stack"]["slot0"]["ffn"])
    st = jax.tree.map(lambda a: a[0], tiered["stack"]["slot0"])
    x = np.random.default_rng(s).normal(size=(3, s, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, st, x


@pytest.mark.parametrize("s,frac,masked", [
    (1, 1.0, False),  # decode buffers: the GEMV path
    (1, 1.0, True),   # dead decode rows excluded from dispatch and counts
    (6, 1.0, True),   # prefill buffers: the grouped GEMM path, pad tokens
    (6, 0.25, False),  # cold tier below dropless capacity: drops match
])
def test_tiered_moe_forward_matches(smoke, s, frac, masked):
    jcfg, tcfg, p, st, x = _moe_inputs(smoke, s)
    mask = None
    if masked:
        mask = np.ones((3, s), bool)
        mask[1, :] = False
        mask[2, s // 2:] = False
    jy, jc = jax_tiered_moe_forward(p, st, jcfg, jnp.asarray(x), cold_capacity_frac=frac,
                                    token_mask=None if mask is None else jnp.asarray(mask))
    ty, tc = tiered_moe_forward(to_torch(p), to_torch(st), tcfg, torch.tensor(x),
                                cold_capacity_frac=frac,
                                token_mask=None if mask is None else torch.tensor(mask))
    _close(ty, jy)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_apply_migrations_matches(smoke):
    """Swaps between all tier pairs, a no-op row, and a move into an empty
    cold padding slot (the reference's occupant-0 rule)."""
    jcfg, tcfg, p, st, x = _moe_inputs(smoke, 1)
    plan = np.array([
        [0, 0, 0, 2, 1],   # hot expert 0 <-> cold slot 1
        [5, 2, 1, 1, 0],   # cold expert 5 <-> warm slot 0
        [-1, 0, 0, 0, 0],  # no-op
        [3, 1, 1, 2, 9],   # warm expert 3 -> empty cold padding slot 9
    ], np.int32)
    want = jax.tree.map(np.asarray, jax_apply_migrations(st, jnp.asarray(plan)))
    got = apply_migrations(to_torch(st), plan)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    # the migrated state still serves the same function as the reference's
    jy, _ = jax_tiered_moe_forward(p, want, jcfg, jnp.asarray(x), cold_capacity_frac=1.0)
    ty, _ = tiered_moe_forward(to_torch(p), got, tcfg, torch.tensor(x), cold_capacity_frac=1.0)
    _close(ty, jy)


def _pool_leaves(pools, prefix=""):
    """(path, array) of every pool leaf, block axis moved first."""
    for k, v in pools.items():
        if isinstance(v, dict):
            yield from _pool_leaves(v, f"{prefix}{k}/")
        else:
            a = np.asarray(v.float().numpy() if isinstance(v, torch.Tensor) else v)
            yield prefix + k, np.moveaxis(a, 1, 0) if prefix.startswith("stack") else a


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_logits_match(arch):
    """A chunk prefill then a decode step through the paged pools, on
    bridged smoke weights: logits allclose, argmax identical, pools
    written identically (pad rows go to the trash block). deepseek adds
    MLA latent pools, a dense first layer and shared experts."""
    jcfg, tcfg, (params, tiered) = _smoke(arch)
    rng = np.random.default_rng(4)
    bs, nb, n_blocks = 4, 4, 12
    pools, states = jax_init_paged_cache(jcfg, 3, n_blocks, bs)
    tables = rng.permutation(n_blocks)[: 3 * nb].reshape(3, nb).astype(np.int32)
    toks = rng.integers(0, jcfg.vocab_size, size=(3, 8)).astype(np.int32)
    lens = np.array([8, 5, 3], np.int32)
    past = np.zeros(3, np.int32)
    mask = np.arange(8)[None, :] < lens[:, None]
    jl, jpools, _ = jax_prefill_paged(params, jcfg, {"tokens": jnp.asarray(toks)}, pools,
                                      jnp.asarray(tables), jnp.asarray(past),
                                      jnp.asarray(mask), tiered=tiered,
                                      cold_capacity_frac=1.0)
    tpools, tstates = init_paged_cache(tcfg, 3, n_blocks, bs, device="cpu")
    tp, tt = to_torch(params), to_torch(tiered)
    tl, tpools, _ = prefill_paged(tp, tcfg, torch.tensor(toks), tpools, torch.tensor(tables),
                               torch.tensor(past), torch.tensor(mask), tiered=tt,
                               cold_capacity_frac=1.0)
    _close(tl, jl, atol=1e-4)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))
    # every block of every pool but the trash (pads write there, in any order)
    want_pools = dict(_pool_leaves(jpools))
    got_pools = dict(_pool_leaves(tpools))
    assert sorted(got_pools) == sorted(want_pools)
    for path, want in want_pools.items():
        _close(torch.tensor(got_pools[path][:n_blocks]), want[:n_blocks], atol=1e-4)

    # one decode step at each row's next position; row 2 is dead
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    pos = lens.copy()
    live = np.array([True, True, False])
    dtab = tables.copy()
    dtab[~live] = n_blocks  # dead rows: all-trash table
    jd, _, _, jc = jax_decode_step_paged(params, jcfg, jnp.asarray(nxt), jpools, states,
                                         jnp.asarray(dtab), jnp.asarray(pos), tiered=tiered,
                                         cold_capacity_frac=1.0, token_mask=jnp.asarray(live))
    td, _, _, tc = decode_step_paged(tp, tcfg, torch.tensor(nxt), tpools, tstates,
                                     torch.tensor(dtab), torch.tensor(pos), tiered=tt,
                                     cold_capacity_frac=1.0, token_mask=torch.tensor(live))
    _close(td[:2], np.asarray(jd)[:2], atol=1e-4)
    np.testing.assert_array_equal(td[:2].argmax(-1).numpy(), np.asarray(jd)[:2].argmax(-1))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_init_params_and_tiers_keep_the_jax_tree(smoke):
    """Seeded port init: same tree paths and shapes as the JAX init, the
    same tier split, and experts copied into their tier slots."""
    jcfg, tcfg, (params, tiered) = smoke

    def shapes(tree, pre=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, f"{pre}{k}/"))
            else:
                out[pre + k] = tuple(v.shape)
        return out

    tp = init_params(0, tcfg, device="cpu")
    assert shapes(tp) == shapes(params)
    again = init_params(0, tcfg, device="cpu")
    assert torch.equal(tp["stack"]["slot0"]["mixer"]["wq"], again["stack"]["slot0"]["mixer"]["wq"])
    sizes = tier_sizes(tcfg)
    from repro.serving.tiered_moe import tier_sizes as jax_tier_sizes

    assert tuple(sizes) == tuple(jax_tier_sizes(jcfg, n_chips=1))
    assert cache_bytes(tcfg, 4, 16) == jax_cache_bytes(jcfg, 4, 16)
    tt = fill_tiers_from_params(tp, init_tiered_for_model(torch.Generator().manual_seed(1),
                                                          tcfg, sizes), tcfg)
    assert shapes(tt) == shapes(jax.tree.map(np.asarray, jax_init_tiered(
        jax.random.PRNGKey(1), jcfg, sizes)))
    ffn = tp["stack"]["slot0"]["ffn"]
    st = tt["stack"]["slot0"]
    e = int(sizes.n_hot)  # first warm expert, warm slot 0
    assert torch.equal(st["warm"][0, 0, 0], ffn["w_gate"][0, e])
    assert torch.equal(st["warm"][0, 0, 2], ffn["w_down"][0, e].T)
