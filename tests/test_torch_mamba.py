"""Parity of the port's Mamba block (repro_torch/models/mamba.py) with the
JAX package's (repro/models/mamba.py) on bridged weights and the same
seeded numpy inputs, at the jamba smoke widths (d_model 64, d_inner 128,
d_state 8, d_conv 4).

Tolerances, fp32: outputs and states within 1e-5 (abs + rel). Both
packages run the same operations in the same order up to the einsums'
summation order (d_inner, d_state and the projections' widths): the
chunk scan repeats `jax.lax.associative_scan`'s odd/even recursion, and
its b_cum equals JAX's bitwise; its a_cum too, except where XLA on the
CPU flushes a product below fp32's smallest normal to zero.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.configs import get_config, reduce_for_smoke
from repro.models import mamba as jmb
from repro_torch.bridge import to_torch
from repro_torch.models import mamba as tmb

ARCH = "jamba-v0.1-52b"
TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), param_dtype=dtype,
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH)),
                               param_dtype=dtype, compute_dtype=dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = _cfgs()
    p = jax.tree.map(np.asarray, jmb.init_mamba(jax.random.PRNGKey(4), jcfg))
    return jcfg, tcfg, p, to_torch(p)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def _x(rng, b, s, d):
    return rng.normal(size=(b, s, d)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 64, 128])
def test_assoc_scan_repeats_jax_associative_scan(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0, 1, size=(2, n, 3, 4)).astype(np.float32)
    b = rng.normal(size=(2, n, 3, 4)).astype(np.float32)
    ja, jb = jax.lax.associative_scan(
        lambda lhs, rhs: (lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, tb = tmb._assoc_scan(torch.tensor(a), torch.tensor(b))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # XLA flushes subnormal products to zero on the CPU; torch keeps them
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                               atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("s", [12, 256])  # 256: two 128-token chunks
@pytest.mark.parametrize("masked", [False, True])
def test_forward_and_state_match_jax(smoke, s, masked):
    jcfg, tcfg, p, tp = smoke
    rng = np.random.default_rng(s + masked)
    x = _x(rng, 3, s, jcfg.d_model)
    mask = None
    if masked:
        mask = np.arange(s)[None, :] < np.array([s, s - 5, 2])[:, None]
    jy, jst = jmb.mamba_forward(p, jcfg, jnp.asarray(x), return_state=True,
                                token_mask=None if mask is None else jnp.asarray(mask))
    ty, tst = tmb.mamba_forward(tp, tcfg, torch.tensor(x), return_state=True,
                                token_mask=None if mask is None else torch.tensor(mask))
    real = np.ones((3, s), bool) if mask is None else mask  # pad outputs: unspecified
    _close(ty[torch.tensor(real)], np.asarray(jy)[real])
    assert tst["ssm"].dtype == torch.float32 and tst["ssm"].shape == (3, 128, 8)
    assert tst["conv"].shape == (3, 3, 128)
    for key in ("ssm", "conv"):
        _close(tst[key], jst[key])
    plain = tmb.mamba_forward(tp, tcfg, torch.tensor(x))  # return_state=False
    _close(plain[torch.tensor(real)], np.asarray(jy)[real])


def test_padded_rows_equal_unpadded(smoke):
    """A right-padded row's output at its real tokens and its final
    {ssm, conv} equal an unpadded forward of its prefix, long rows and
    rows shorter than the conv window (2 tokens) alike."""
    jcfg, tcfg, _, tp = smoke
    rng = np.random.default_rng(11)
    s, lens = 16, [16, 9, 2]
    x = _x(rng, 3, s, jcfg.d_model)
    mask = torch.tensor(np.arange(s)[None, :] < np.array(lens)[:, None])
    y, st = tmb.mamba_forward(tp, tcfg, torch.tensor(x), return_state=True, token_mask=mask)
    for r, n in enumerate(lens):
        yr, sr = tmb.mamba_forward(tp, tcfg, torch.tensor(x[r:r + 1, :n]), return_state=True)
        _close(y[r, :n], yr[0].numpy())
        for key in ("ssm", "conv"):
            _close(st[key][r], sr[key][0].numpy())


def test_decode_continues_prefill(smoke):
    """Prefill 10 tokens, then 4 decode steps from the state: each step's
    output and the states equal the 14-token forward's, and equal the
    JAX `mamba_decode` from the same state."""
    jcfg, tcfg, p, tp = smoke
    rng = np.random.default_rng(5)
    x = _x(rng, 2, 14, jcfg.d_model)
    full = tmb.mamba_forward(tp, tcfg, torch.tensor(x))
    _, st = tmb.mamba_forward(tp, tcfg, torch.tensor(x[:, :10]), return_state=True)
    _, jst = jmb.mamba_forward(p, jcfg, jnp.asarray(x[:, :10]), return_state=True)
    for t in range(10, 14):
        y, st = tmb.mamba_decode(tp, tcfg, torch.tensor(x[:, t:t + 1]), st)
        jy, jst = jmb.mamba_decode(p, jcfg, jnp.asarray(x[:, t:t + 1]), jst)
        _close(y, jy)
        _close(y[:, 0], full[:, t].numpy())
        for key in ("ssm", "conv"):
            _close(st[key], jst[key])
    _, st14 = tmb.mamba_forward(tp, tcfg, torch.tensor(x), return_state=True)
    for key in ("ssm", "conv"):
        _close(st[key], st14[key].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_keeps_the_jax_tree_and_dtypes(dtype):
    """The port's params and init state have the reference's keys, shapes
    and dtypes: A_log and D fp32 under bf16 params, the SSM state fp32,
    the conv state in the parameter dtype; dt_bias -4.6, D 1, A_log
    log(1..N) (each package's log, an ulp apart)."""
    jcfg, tcfg = _cfgs(dtype)
    jp = jax.tree.map(np.asarray, jmb.init_mamba(jax.random.PRNGKey(0), jcfg))
    tp = tmb.init_mamba(torch.Generator().manual_seed(0), tcfg, lead=(2,))
    assert sorted(tp) == sorted(jp)
    for key, want in jp.items():
        got = to_torch({key: want})[key]
        assert tp[key].shape == (2, *want.shape) and tp[key].dtype == got.dtype, key
    for key in ("dt_bias", "D", "conv_b"):
        _close(tp[key][1], jp[key], atol=0, rtol=0)
    _close(tp["A_log"][1], jp["A_log"], atol=0, rtol=2e-7)  # log: within an ulp
    jst = jmb.mamba_init_state(jcfg, 3, jnp.dtype(dtype))
    tst = tmb.mamba_init_state(tcfg, 3, tp["in_proj"].dtype)
    for key in ("ssm", "conv"):
        assert tuple(tst[key].shape) == jst[key].shape
        assert tst[key].dtype == to_torch({"a": np.asarray(jst[key])})["a"].dtype
        assert not tst[key].any()
