"""Parity of the port's xLSTM blocks (repro_torch/models/xlstm.py) and of
the model functions over them with the JAX package, on bridged weights
and the same seeded numpy inputs, at the xlstm-125m smoke widths
(d_model 64, 4 heads, mLSTM d_inner 128, sLSTM FFN 256; 4 layers m, s,
m, s).

Tolerances, fp32: module outputs and states within 1e-5 (abs + rel),
model logits and states within 1e-5 too. Both packages run the same
sequential recurrence step by step; they differ only in the einsums'
summation order. The stabilizer m starts at -inf and stays -inf on an
all-pad row, in both packages (compared as equal infinities).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.configs import get_config, reduce_for_smoke
from repro.models import model as jm
from repro.models import xlstm as jxl
from repro.serving.paged_kv import init_paged_cache as jax_init_paged_cache
from repro_torch.bridge import to_torch
from repro_torch.models import model as tm
from repro_torch.models import xlstm as txl
from repro_torch.serving.paged_kv import init_paged_cache

ARCH = "xlstm-125m"
TOL = dict(atol=1e-5, rtol=1e-5)
BLOCKS = {"mlstm": (jxl.init_mlstm, jxl.mlstm_forward, jxl.mlstm_decode,
                    txl.mlstm_forward, txl.mlstm_decode),
          "slstm": (jxl.init_slstm, jxl.slstm_forward, jxl.slstm_decode,
                    txl.slstm_forward, txl.slstm_decode)}


def _cfgs():
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    return (dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **f32),
            dataclasses.replace(tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH)), **f32))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def _close_tree(got, want):
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        if isinstance(g, dict):
            _close_tree(g, want[key])
        else:
            _close(g, want[key])


@pytest.fixture(scope="module", params=list(BLOCKS))
def block(request):
    jcfg, tcfg = _cfgs()
    init = BLOCKS[request.param][0]
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(2), jcfg))
    return (request.param, jcfg, tcfg, p, to_torch(p)) + BLOCKS[request.param][1:]


@pytest.mark.parametrize("masked", [False, True])
def test_forward_and_state_match_jax(block, masked):
    _, jcfg, tcfg, p, tp, jfwd, _, tfwd, _ = block
    rng = np.random.default_rng(masked)
    s = 9
    x = rng.normal(size=(3, s, jcfg.d_model)).astype(np.float32)
    mask = np.arange(s)[None, :] < np.array([9, 4, 0])[:, None] if masked else None
    jy, jst = jfwd(p, jcfg, jnp.asarray(x), return_state=True,
                   token_mask=None if mask is None else jnp.asarray(mask))
    ty, tst = tfwd(tp, tcfg, torch.tensor(x), return_state=True,
                   token_mask=None if mask is None else torch.tensor(mask))
    real = np.ones((3, s), bool) if mask is None else mask
    _close(ty[torch.tensor(real)], np.asarray(jy)[real])
    _close_tree(tst, jst)
    if masked:  # the all-pad row keeps the init state: m at -inf
        assert torch.isneginf(tst["m"][2]).all()
    plain = tfwd(tp, tcfg, torch.tensor(x))  # return_state=False
    _close(plain[torch.tensor(real)], np.asarray(jy)[real])


def test_padded_rows_equal_unpadded(block):
    _, _, tcfg, _, tp, _, _, tfwd, _ = block
    rng = np.random.default_rng(3)
    s, lens = 8, [8, 5, 1]
    x = torch.tensor(rng.normal(size=(3, s, tcfg.d_model)).astype(np.float32))
    mask = torch.tensor(np.arange(s)[None, :] < np.array(lens)[:, None])
    y, st = tfwd(tp, tcfg, x, return_state=True, token_mask=mask)
    for r, n in enumerate(lens):
        yr, sr = tfwd(tp, tcfg, x[r:r + 1, :n], return_state=True)
        _close(y[r, :n], yr[0].numpy())
        for key in st:
            _close(st[key][r], sr[key][0].numpy())


def test_decode_continues_prefill(block):
    _, jcfg, tcfg, p, tp, jfwd, jdec, tfwd, tdec = block
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    full = tfwd(tp, tcfg, torch.tensor(x))
    _, st = tfwd(tp, tcfg, torch.tensor(x[:, :6]), return_state=True)
    _, jst = jfwd(p, jcfg, jnp.asarray(x[:, :6]), return_state=True)
    for t in range(6, 9):
        y, st = tdec(tp, tcfg, torch.tensor(x[:, t:t + 1]), st)
        jy, jst = jdec(p, jcfg, jnp.asarray(x[:, t:t + 1]), jst)
        _close(y, jy)
        _close(y[:, 0], full[:, t].numpy())
        _close_tree(st, jst)


# ------------------------------------------------------------ model level
@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, params, to_torch(params)


def _inputs(vocab):
    rng = np.random.default_rng(8)
    toks = rng.integers(0, vocab, size=(3, 8)).astype(np.int32)
    lens = np.array([8, 5, 2], np.int32)
    return toks, lens, np.arange(8)[None, :] < lens[:, None]


def test_prefill_and_decode_step_match_jax(model):
    """The contiguous path: masked prefill, then 3 greedy decode steps:
    logits and every layer's state match, tokens identical."""
    jcfg, tcfg, params, tp = model
    toks, lens, mask = _inputs(jcfg.vocab_size)
    jl, jcache = jm.prefill(params, jcfg, {"tokens": jnp.asarray(toks)}, cache_len=12,
                            token_mask=jnp.asarray(mask))
    tl, tcache = tm.prefill(tp, tcfg, torch.tensor(toks), cache_len=12,
                            token_mask=torch.tensor(mask))
    _close(tl, jl)
    _close_tree(tcache, jax.tree.map(np.asarray, jcache))
    pos = lens.copy()
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt[:, 0])
        jl, jcache, _ = jm.decode_step(params, jcfg, jnp.asarray(nxt), jcache,
                                       jnp.asarray(pos))
        tl, tcache, tc = tm.decode_step(tp, tcfg, torch.tensor(nxt), tcache, torch.tensor(pos))
        _close(tl, jl)
        assert tuple(tc.shape) == (tcfg.n_layers, 1) and not tc.any()  # no MoE
        pos = pos + 1
    _close_tree(tcache, jax.tree.map(np.asarray, jcache))


def test_prefill_paged_and_decode_step_paged_match_jax(model):
    """The paged path: no pools (xLSTM has no attention), the rows' states
    returned by `prefill_paged` and advanced by `decode_step_paged`; they
    and the logits match the reference's, and the tokens equal the
    contiguous path's."""
    jcfg, tcfg, params, tp = model
    toks, lens, mask = _inputs(jcfg.vocab_size)
    jpools, _ = jax_init_paged_cache(jcfg, 3, 12, 4)
    tpools, _ = init_paged_cache(tcfg, 3, 12, 4, device="cpu")
    assert all(not leaf for leaf in tpools["stack"].values())
    tables = np.arange(12, dtype=np.int32).reshape(3, 4)
    past = np.zeros(3, np.int32)
    jl, jpools, jst = jm.prefill_paged(params, jcfg, {"tokens": jnp.asarray(toks)}, jpools,
                                       jnp.asarray(tables), jnp.asarray(past),
                                       jnp.asarray(mask))
    tl, tpools, tst = tm.prefill_paged(tp, tcfg, torch.tensor(toks), tpools,
                                       torch.tensor(tables), torch.tensor(past),
                                       torch.tensor(mask))
    _close(tl, jl)
    _close_tree(tst, jax.tree.map(np.asarray, jst))
    _, tcache = tm.prefill(tp, tcfg, torch.tensor(toks), token_mask=torch.tensor(mask))
    pos = lens.copy()
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt[:, 0])
        jl, jpools, jst, _ = jm.decode_step_paged(params, jcfg, jnp.asarray(nxt), jpools, jst,
                                                  jnp.asarray(tables), jnp.asarray(pos))
        tl, _, tst, _ = tm.decode_step_paged(tp, tcfg, torch.tensor(nxt), tpools, tst,
                                             torch.tensor(tables), torch.tensor(pos))
        cl, tcache, _ = tm.decode_step(tp, tcfg, torch.tensor(nxt), tcache, torch.tensor(pos))
        _close(tl, jl)
        assert torch.equal(tl, cl)  # the same plain functions on the same shapes
        pos = pos + 1
    _close_tree(tst, jax.tree.map(np.asarray, jst))


def test_slot_state_starts_at_the_reference_init(model):
    """The paged layout's per-slot state is the reference's: same keys and
    shapes, zeros and m at -inf (a zeroing path must not initialise it)."""
    jcfg, tcfg, _, _ = model
    _, jst = jax_init_paged_cache(jcfg, 5, 8, 4)
    _, tst = init_paged_cache(tcfg, 5, 8, 4, device="cpu")
    _close_tree(tst, jax.tree.map(np.asarray, jst))
    assert torch.isneginf(tst["stack"]["slot0"]["state"]["m"]).all()
    assert torch.isneginf(tst["stack"]["slot1"]["state"]["m"]).all()


def test_decode_verify_raises_for_a_recurrent_arch(model):
    _, tcfg, _, tp = model
    toks = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="attention-only"):
        tm.decode_verify(tp, tcfg, toks, tm.init_cache(tcfg, 2, 4), torch.zeros((2, 2)),
                         torch.zeros(2, dtype=torch.int32), torch.ones((2, 3), dtype=bool))
