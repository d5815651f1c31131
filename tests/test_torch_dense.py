"""The dense model family of the PyTorch port against the JAX package:
llama3.2-3b, phi4-mini-3.8b, qwen2.5-32b, chameleon-34b and granite-20b,
each at an fp32 smoke config that keeps its published query heads per KV
head (G = 3, 3, 5, 8 and 48: granite-20b stays MQA) and its `qkv_bias`,
`tie_embeddings` and `rope_theta`, on weights bridged from the
reference's `init_params` (qwen's zero-initialised QKV biases replaced
by seeded random ones in both) and the same seeded numpy tokens.

Held within atol 1e-5 / rtol 1e-4 (fp32: the same products summed in
another order): `forward_train` logits; a masked `prefill` and two
`decode_step`s; two `prefill_paged` chunks, the second after a past,
then a `decode_step_paged`, over block tables scattered in the pool.
Greedy tokens are equal throughout. Below the model, the paged GQA
kernel's plain version is held to the JAX Pallas kernel at each new
(Kv, G) pair in tests/test_torch_kernels.py. The smoke configs come
from chip_smoke.py's `keep_groups`, which the card's dense phase uses.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.configs import get_config, reduce_for_smoke
from repro.models import model as jmodel
from repro.serving.paged_kv import init_paged_cache as jax_init_paged_cache
from repro_torch.bridge import to_torch
from repro_torch.models import model as tmodel
from repro_torch.serving.paged_kv import init_paged_cache

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import keep_groups  # noqa: E402

DENSE = ("llama3.2-3b", "phi4-mini-3.8b", "qwen2.5-32b", "chameleon-34b", "granite-20b")
ATOL, RTOL = 1e-5, 1e-4
B, S = 3, 12


_SMOKE = {}


def _smoke(arch):
    """(JAX config, port config, host params) of `arch`, built once."""
    if arch not in _SMOKE:
        jcfg = keep_groups(reduce_for_smoke(get_config(arch)), get_config(arch))
        tcfg = keep_groups(tcfgs.reduce_for_smoke(tcfgs.get_config(arch)),
                           tcfgs.get_config(arch))
        params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg))
        if jcfg.qkv_bias:  # zeros at init: give the biases values to carry
            rng = np.random.default_rng(1)
            for k in ("bq", "bk", "bv"):
                leaf = params["stack"]["slot0"]["mixer"][k]
                params["stack"]["slot0"]["mixer"][k] = (
                    rng.normal(size=leaf.shape).astype(np.float32) * 0.5)
        _SMOKE[arch] = jcfg, tcfg, params
    return _SMOKE[arch]


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL, err_msg=what)


def _same_tokens(got, want, what):
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1),
                                  err_msg=what)


def _tokens(cfg, s=S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def test_smoke_configs_keep_the_published_groups():
    for arch in DENSE:
        jcfg, tcfg, params = _smoke(arch)
        pub = tcfgs.get_config(arch)
        assert tcfg.n_heads // tcfg.n_kv_heads == pub.n_heads // pub.n_kv_heads
        assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.resolved_head_dim) == (
            jcfg.n_heads, jcfg.n_kv_heads, jcfg.resolved_head_dim)
        assert (tcfg.qkv_bias, tcfg.tie_embeddings, tcfg.rope_theta) == (
            pub.qkv_bias, pub.tie_embeddings, pub.rope_theta)
        assert ("head" in params) != pub.tie_embeddings
        assert tcfg.moe is None and tcfg.family in ("dense", "vlm")
    assert _smoke("granite-20b")[1].n_kv_heads == 1  # MQA


@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_logits_match(arch):
    jcfg, tcfg, params = _smoke(arch)
    toks = _tokens(jcfg)
    want, _, _ = jmodel.forward_train(params, jcfg, {"tokens": jnp.asarray(toks)})
    got, _, _ = tmodel.forward_train(to_torch(params), tcfg, {"tokens": torch.tensor(toks)})
    _close(got, want, f"{arch} forward_train")


@pytest.mark.parametrize("arch", DENSE)
def test_masked_prefill_and_decode_match(arch):
    """Rows right-padded to S (12, 7 and 4 real tokens), then two greedy
    decode steps at each row's own position."""
    jcfg, tcfg, params = _smoke(arch)
    toks = _tokens(jcfg, seed=1)
    lens = np.array([S, 7, 4], np.int32)
    mask = np.arange(S)[None, :] < lens[:, None]
    tp = to_torch(params)
    jl, jc = jmodel.prefill(params, jcfg, {"tokens": jnp.asarray(toks)}, cache_len=S + 2,
                            token_mask=jnp.asarray(mask))
    tl, tc = tmodel.prefill(tp, tcfg, torch.tensor(toks), cache_len=S + 2,
                            token_mask=torch.tensor(mask))
    _close(tl, jl, f"{arch} prefill")
    _same_tokens(tl, jl, f"{arch} prefill")
    pos = lens.copy()
    for step in range(2):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc, _ = jmodel.decode_step(params, jcfg, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl, tc, _ = tmodel.decode_step(tp, tcfg, torch.tensor(nxt), tc, torch.tensor(pos))
        _close(tl, jl, f"{arch} decode step {step}")
        _same_tokens(tl, jl, f"{arch} decode step {step}")
        pos = pos + 1


@pytest.mark.parametrize("arch", DENSE)
def test_paged_chunks_and_decode_match(arch):
    """Two prefill chunks through the paged pools (the second at past_len
    8 for the rows that filled the first), then one decode step; tables
    are a random permutation of the pool's blocks, pads write the trash
    block."""
    jcfg, tcfg, params = _smoke(arch)
    rng = np.random.default_rng(2)
    bs, nb = 4, 6
    n_blocks = B * nb
    tables = rng.permutation(n_blocks).reshape(B, nb).astype(np.int32)
    toks = _tokens(jcfg, s=16, seed=2)
    first = np.array([8, 8, 5], np.int32)  # the first chunk's real tokens a row
    second = np.array([8, 3, 0], np.int32)
    jpools, jstates = jax_init_paged_cache(jcfg, B, n_blocks, bs)
    tpools, tstates = init_paged_cache(tcfg, B, n_blocks, bs, device="cpu")
    tp = to_torch(params)
    past = np.zeros(B, np.int32)
    for i, lens in enumerate((first, second)):
        chunk = toks[:, 8 * i:8 * i + 8]
        mask = np.arange(8)[None, :] < lens[:, None]
        jl, jpools, _ = jmodel.prefill_paged(params, jcfg, {"tokens": jnp.asarray(chunk)},
                                             jpools, jnp.asarray(tables), jnp.asarray(past),
                                             jnp.asarray(mask))
        tl, tpools, _ = tmodel.prefill_paged(tp, tcfg, torch.tensor(chunk), tpools,
                                             torch.tensor(tables), torch.tensor(past),
                                             torch.tensor(mask))
        live = lens > 0  # an all-pad row's logits are discarded
        _close(tl[live], np.asarray(jl)[live], f"{arch} chunk {i}")
        _same_tokens(tl[live], np.asarray(jl)[live], f"{arch} chunk {i}")
        if i == 0:
            last = jl
        else:
            last = np.where(live[:, None], np.asarray(jl), np.asarray(last))
        past = past + lens
    nxt = np.asarray(last).argmax(-1).astype(np.int32)[:, None]
    jd, _, _, _ = jmodel.decode_step_paged(params, jcfg, jnp.asarray(nxt), jpools, jstates,
                                           jnp.asarray(tables), jnp.asarray(past))
    td, _, _, _ = tmodel.decode_step_paged(tp, tcfg, torch.tensor(nxt), tpools, tstates,
                                           torch.tensor(tables), torch.tensor(past))
    _close(td, jd, f"{arch} paged decode")
    _same_tokens(td, jd, f"{arch} paged decode")
