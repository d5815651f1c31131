"""MLA paged serving of the PyTorch port against the JAX package, on the
same seeded numpy inputs and bridged deepseek-v2-236b smoke weights:

- the plain version of the MLA paged-attention kernel against the JAX
  Pallas kernel `paged_prefill_mla` / `paged_decode_mla` in interpret
  mode (fp32 and bf16 pools, uneven past_len, a dead row, an all-pad row);
- the model's `mla_decode_paged` / `mla_prefill_paged`;
- the MLA cache layout: pool shapes, `cache_bytes`, and the tier split
  that the reclaimed KV bytes feed.

Tolerance 2e-5 everywhere (the JAX package's own for this kernel): the
kernel math is fp32 on both sides, bf16 pools included (both read the
same bf16 values as fp32, and P is never rounded), so only the order of
fp32 sums differs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.configs import get_config, reduce_for_smoke
from repro.kernels.paged_attention import paged_decode_mla as jax_paged_decode_mla
from repro.kernels.paged_attention import paged_prefill_mla as jax_paged_prefill_mla
from repro.models import attention as jattn
from repro.models.model import init_params as jax_init_params
from repro.serving.kv_cache import cache_bytes as jax_cache_bytes
from repro.serving.paged_kv import PagedKVCache as JaxPagedKVCache
from repro.serving.paged_kv import init_paged_cache as jax_init_paged_cache
from repro.serving.tiered_moe import tier_sizes as jax_tier_sizes
from repro_torch.bridge import to_torch
from repro_torch.kernels.paged_attention import (
    paged_decode_mla,
    paged_decode_mla_ref,
    paged_prefill_mla,
)
from repro_torch.models import attention as tattn
from repro_torch.models.model import init_params
from repro_torch.serving.kv_cache import cache_bytes
from repro_torch.serving.paged_kv import PagedKVCache, init_paged_cache
from repro_torch.serving.tiered_moe import tier_sizes

ARCH = "deepseek-v2-236b"
TOL = 2e-5
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pool(a: np.ndarray, dt: str):
    """The same pool as a JAX array and a torch tensor of dtype dt."""
    return jnp.asarray(a, JDT[dt]), torch.tensor(a, dtype=torch.float32).to(TDT[dt])


# ------------------------------------------------------------- kernel
def _mla_case(seed, b, c, h, r, rd, bs, nb, dead=(), all_pad=()):
    rng = np.random.default_rng(seed)
    n_blocks = b * nb + 3
    tables = rng.permutation(n_blocks)[: b * nb].reshape(b, nb).astype(np.int32)
    past = rng.integers(0, nb * bs - c + 1, size=b).astype(np.int32)
    lengths = rng.integers(1, c + 1, size=b).astype(np.int32)
    for row in dead:  # dead decode row: all-trash table
        tables[row] = n_blocks
        lengths[row] = 0
    for row in all_pad:  # all-pad prefill row
        lengths[row] = 0
    ql = rng.normal(size=(b, c, h, r)).astype(np.float32)
    qr = rng.normal(size=(b, c, h, rd)).astype(np.float32)
    pc = rng.normal(size=(n_blocks + 1, bs, r))
    pr = rng.normal(size=(n_blocks + 1, bs, rd))
    return ql, qr, pc, pr, tables, past, lengths


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,b,c,h,bs,nb", [
    (0, 3, 5, 4, 4, 4),   # uneven past, one all-pad row
    (1, 2, 8, 2, 2, 8),   # chunk wider than a block
    (2, 4, 3, 3, 8, 2),   # odd head count, wide blocks
])
def test_paged_prefill_mla_plain_matches_pallas(dt, seed, b, c, h, bs, nb):
    ql, qr, pc, pr, tables, past, lengths = _mla_case(
        seed, b, c, h, r=32, rd=8, bs=bs, nb=nb, all_pad=(b - 1,))
    scale = (16 + 8) ** -0.5
    jc, tc = _pool(pc, dt)
    jr, tr = _pool(pr, dt)
    want = jax_paged_prefill_mla(jnp.asarray(ql), jnp.asarray(qr), jc, jr,
                                 jnp.asarray(tables), jnp.asarray(past),
                                 jnp.asarray(lengths), scale=scale, interpret=True)
    got = paged_prefill_mla(torch.tensor(ql), torch.tensor(qr), tc, tr,
                            torch.tensor(tables), torch.tensor(past),
                            torch.tensor(lengths), scale=scale)
    assert got.dtype == torch.float32 and got.shape == ql.shape
    assert np.isfinite(_np(got)).all()  # the all-pad row too
    real = np.arange(c)[None, :] < lengths[:, None]  # pad queries are discarded
    np.testing.assert_allclose(_np(got)[real], _np(want)[real], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_decode_mla_chunk_of_one_and_dead_rows(dt):
    """Decode is the chunk-of-1 prefill; a dead row (all-trash table)
    still gives a finite output; live rows match the Pallas kernel."""
    ql, qr, pc, pr, tables, past, _ = _mla_case(5, 4, 1, 4, r=32, rd=8, bs=4, nb=4,
                                                dead=(2,))
    scale = 0.2
    jc, tc = _pool(pc, dt)
    jr, tr = _pool(pr, dt)
    tq, trq = torch.tensor(ql[:, 0]), torch.tensor(qr[:, 0])
    tt, tp = torch.tensor(tables), torch.tensor(past)
    dec = paged_decode_mla(tq, trq, tc, tr, tt, tp, scale=scale)
    chunk = paged_prefill_mla(tq[:, None], trq[:, None], tc, tr, tt, tp,
                              torch.ones_like(tp), scale=scale)[:, 0]
    torch.testing.assert_close(dec, chunk, rtol=0, atol=0)
    torch.testing.assert_close(dec, paged_decode_mla_ref(tq, trq, tc, tr, tt, tp,
                                                         scale=scale), rtol=0, atol=0)
    assert torch.isfinite(dec).all()
    want = jax_paged_decode_mla(jnp.asarray(ql[:, 0]), jnp.asarray(qr[:, 0]), jc, jr,
                                jnp.asarray(tables), jnp.asarray(past), scale=scale,
                                interpret=True)
    live = np.array([True, True, False, True])
    np.testing.assert_allclose(_np(dec)[live], _np(want)[live], atol=TOL, rtol=TOL)


# -------------------------------------------------------------- model
@pytest.fixture(scope="module")
def smoke():
    jcfg = _f32(reduce_for_smoke(get_config(ARCH)))
    tcfg = _f32(tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH)))
    p = jax.tree.map(np.asarray, jattn.init_mla(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, p


def _latent_pools(rng, cfg, n_blocks, bs):
    m = cfg.mla
    return (rng.normal(size=(n_blocks + 1, bs, m.kv_lora_rank)).astype(np.float32),
            rng.normal(size=(n_blocks + 1, bs, m.qk_rope_head_dim)).astype(np.float32))


def test_mla_decode_paged_matches_jax(smoke):
    """One decode token per row against bridged MLA weights: output and
    both written pools (the new token's latent and rope key) agree."""
    jcfg, tcfg, p = smoke
    rng = np.random.default_rng(6)
    b, bs, nb = 3, 4, 3
    n_blocks = b * nb
    tables = rng.permutation(n_blocks).reshape(b, nb).astype(np.int32)
    x = rng.normal(size=(b, 1, jcfg.d_model)).astype(np.float32)
    pc, pr = _latent_pools(rng, jcfg, n_blocks, bs)
    pos = np.asarray([2, 10, 7], np.int32)
    jo, jpc, jpr = jattn.mla_decode_paged(p, jcfg, jnp.asarray(x), jnp.asarray(pc),
                                          jnp.asarray(pr), jnp.asarray(tables),
                                          jnp.asarray(pos), backend="pallas")
    to, tpc, tpr = tattn.mla_decode_paged(to_torch(p), tcfg, torch.tensor(x),
                                          torch.tensor(pc), torch.tensor(pr),
                                          torch.tensor(tables), torch.tensor(pos))
    np.testing.assert_allclose(_np(to), _np(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(tpc), _np(jpc), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(tpr), _np(jpr), atol=TOL, rtol=TOL)


def test_mla_prefill_paged_matches_jax(smoke):
    """A right-padded chunk over a cached prefix (uneven past_len, one
    all-pad row): real tokens' outputs and every non-trash pool block
    agree (pads write to the trash block)."""
    jcfg, tcfg, p = smoke
    rng = np.random.default_rng(7)
    b, c, bs, nb = 3, 6, 4, 5
    n_blocks = b * nb
    tables = rng.permutation(n_blocks).reshape(b, nb).astype(np.int32)
    x = rng.normal(size=(b, c, jcfg.d_model)).astype(np.float32)
    pc, pr = _latent_pools(rng, jcfg, n_blocks, bs)
    past = np.asarray([0, 9, 5], np.int32)
    lens = np.asarray([6, 3, 0], np.int32)
    mask = np.arange(c)[None, :] < lens[:, None]
    positions = (past[:, None] + np.arange(c)[None, :]).astype(np.int32)
    jo, jpc, jpr = jattn.mla_prefill_paged(
        p, jcfg, jnp.asarray(x), jnp.asarray(pc), jnp.asarray(pr), jnp.asarray(tables),
        jnp.asarray(past), jnp.asarray(positions), jnp.asarray(mask), backend="pallas")
    to, tpc, tpr = tattn.mla_prefill_paged(
        to_torch(p), tcfg, torch.tensor(x), torch.tensor(pc), torch.tensor(pr),
        torch.tensor(tables), torch.tensor(past), torch.tensor(positions),
        torch.tensor(mask))
    np.testing.assert_allclose(_np(to)[mask], _np(jo)[mask], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(tpc)[:n_blocks], _np(jpc)[:n_blocks], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(tpr)[:n_blocks], _np(jpr)[:n_blocks], atol=TOL, rtol=TOL)


# ------------------------------------------------------- cache layout
def _shapes(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{pre}{k}/"))
        else:
            out[pre + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_mla_pools_and_cache_bytes_match_jax(param_dtype):
    """Latent pools ckv [N+1, bs, r] / krope [N+1, bs, rd] per MLA layer in
    the param dtype, and the contiguous byte count the paged pool is
    compared with, equal the reference's."""
    jcfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), param_dtype=param_dtype)
    tcfg = dataclasses.replace(tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH)),
                               param_dtype=param_dtype)
    jpools, _ = jax_init_paged_cache(jcfg, 3, 10, 4)
    assert _shapes(init_paged_cache(tcfg, 3, 10, 4, device="cpu")[0]) == _shapes(
        jax.tree.map(np.asarray, jpools))
    for batch, seq in ((4, 16), (8, 72)):
        assert cache_bytes(tcfg, batch, seq) == jax_cache_bytes(jcfg, batch, seq)
    # the full config too (the JAX side is an abstract shape walk)
    full_j = dataclasses.replace(get_config(ARCH), param_dtype=param_dtype)
    full_t = dataclasses.replace(tcfgs.get_config(ARCH), param_dtype=param_dtype)
    assert cache_bytes(full_t, 8, 72) == jax_cache_bytes(full_j, 8, 72)


@pytest.mark.parametrize("cache_len,n_blocks", [(24, None), (64, 20)])
def test_mla_reclaimed_bytes_give_the_jax_tier_split(cache_len, n_blocks):
    """The paged cache's reclaimed bytes and the tier split they buy
    equal the reference engine's, at the smoke size and (through the same
    byte counts) at deepseek's full width."""
    jcfg = reduce_for_smoke(get_config(ARCH))
    tcfg = tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH))
    jkv = JaxPagedKVCache(jcfg, 4, cache_len, block_size=4, n_blocks=n_blocks)
    tkv = PagedKVCache(tcfg, 4, cache_len, block_size=4, n_blocks=n_blocks, device="cpu")
    assert tkv.paged_bytes() == jkv.paged_bytes()
    rec = tkv.reclaimed_bytes(cache_len)
    assert rec == jkv.reclaimed_bytes(cache_len)
    assert tuple(tier_sizes(tcfg, reclaimed_kv_bytes=rec)) == tuple(
        jax_tier_sizes(jcfg, n_chips=1, reclaimed_kv_bytes=rec))
    full_j, full_t = get_config(ARCH), tcfgs.get_config(ARCH)
    for reclaimed in (0, jax_cache_bytes(full_j, 8, 72)):
        assert tuple(tier_sizes(full_t, reclaimed_kv_bytes=reclaimed)) == tuple(
            jax_tier_sizes(full_j, n_chips=1, reclaimed_kv_bytes=reclaimed))


def test_deepseek_params_keep_the_jax_tree():
    """Seeded port init of the deepseek smoke config: the dense first
    layer, the MLA mixers and the shared experts under the JAX tree
    paths, with the JAX shapes and dtypes."""
    jcfg = _f32(reduce_for_smoke(get_config(ARCH)))
    tcfg = _f32(tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH)))
    want = _shapes(jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), jcfg)))
    got = _shapes(init_params(0, tcfg, device="cpu"))
    assert got == want
    # 4 smoke layers form one scan group: slot0 is the dense layer
    assert got["stack/slot0/ffn/w_gate"][0] == (1, 64, 128)
    assert "stack/slot1/ffn/shared/w_gate" in got and "stack/slot1/mixer/wkv_b" in got
