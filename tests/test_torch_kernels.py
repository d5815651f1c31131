"""The port's plain PyTorch versions of the three serving kernels against
the JAX package's Pallas kernels, run in interpret mode on the CPU as
the JAX tests run them, on the same seeded numpy inputs. The CUDA
kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda_kernels.py and chip_smoke.py.

Tolerances: fp32 comparisons are tight (atol/rtol 1e-5; the same
products summed in another order). bf16 comparisons allow 2e-2: both
sides round the output (and P or h) to bf16, 8 mantissa bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.expert_gemv import cold_expert_ffn as jax_cold_expert_ffn
from repro.kernels.moe_gemm import grouped_expert_ffn as jax_grouped_expert_ffn
from repro.kernels.moe_gemm import moe_gemm as jax_moe_gemm
from repro.kernels.paged_attention import paged_decode_gqa as jax_paged_decode_gqa
from repro.kernels.paged_attention import paged_prefill_gqa as jax_paged_prefill_gqa
from repro_torch.kernels import backend
from repro_torch.kernels.backend import use_kernel
from repro_torch.kernels.expert_gemv import cold_expert_ffn
from repro_torch.kernels.moe_gemm import grouped_expert_ffn, moe_gemm
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.kernels.paged_attention import (
    paged_decode_gqa,
    paged_prefill_gqa,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dt: str):
    """The same numpy array as a JAX array and a torch tensor of dtype dt."""
    return jnp.asarray(a, JDT[dt]), torch.tensor(a, dtype=torch.float32).to(TDT[dt])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ----------------------------------------------------------- attention
def _attention_case(seed, b, c, kv, g, hd, bs, nb, dead=(), all_pad=()):
    rng = np.random.default_rng(seed)
    n_blocks = b * nb + 3
    tables = rng.permutation(n_blocks)[: b * nb].reshape(b, nb).astype(np.int32)
    past = rng.integers(0, (nb * bs) - c + 1, size=b).astype(np.int32)
    lengths = rng.integers(1, c + 1, size=b).astype(np.int32)
    for r in dead:  # dead decode row: all-trash table
        tables[r] = n_blocks
        lengths[r] = 0
    for r in all_pad:  # all-pad prefill row
        lengths[r] = 0
    q = rng.normal(size=(b, c, kv, g, hd))
    pk = rng.normal(size=(n_blocks + 1, bs, kv, hd))
    pv = rng.normal(size=(n_blocks + 1, bs, kv, hd))
    return q, pk, pv, tables, past, lengths


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,b,c,g,bs,nb", [
    (0, 3, 4, 2, 4, 4),
    (1, 2, 8, 1, 2, 8),
    (2, 4, 3, 2, 8, 2),
])
def test_paged_prefill_plain_matches_pallas(dt, seed, b, c, g, bs, nb):
    q, pk, pv, tables, past, lengths = _attention_case(
        seed, b, c, kv=2, g=g, hd=16, bs=bs, nb=nb, all_pad=(b - 1,))
    jq, tq = _both(q, dt)
    jk, tk = _both(pk, dt)
    jv, tv = _both(pv, dt)
    want = jax_paged_prefill_gqa(jq, jk, jv, jnp.asarray(tables), jnp.asarray(past),
                                 jnp.asarray(lengths), interpret=True)
    got = paged_prefill_gqa(tq, tk, tv, torch.tensor(tables), torch.tensor(past),
                            torch.tensor(lengths))
    assert got.dtype == TDT[dt] and got.shape == q.shape
    assert np.isfinite(_np(got)).all()
    real = np.arange(c)[None, :] < lengths[:, None]  # pad queries are discarded
    np.testing.assert_allclose(_np(got)[real], _np(want)[real],
                               atol=TOL[dt], rtol=TOL[dt])


def test_paged_decode_chunk_of_one_and_dead_rows():
    """Decode is the chunk-of-1 prefill; a dead row (all-trash table)
    still gives a finite output."""
    q, pk, pv, tables, past, _ = _attention_case(5, 4, 1, kv=2, g=2, hd=16, bs=4,
                                                 nb=4, dead=(2,))
    tq, tk, tv = (torch.tensor(a, dtype=torch.float32) for a in (q, pk, pv))
    tt, tp = torch.tensor(tables), torch.tensor(past)
    dec = paged_decode_gqa(tq[:, 0], tk, tv, tt, tp)
    chunk = paged_prefill_gqa(tq, tk, tv, tt, tp, torch.ones_like(tp))[:, 0]
    torch.testing.assert_close(dec, chunk, rtol=0, atol=0)
    assert torch.isfinite(dec).all()
    want = jax_paged_decode_gqa(jnp.asarray(q[:, 0], jnp.float32), jnp.asarray(pk, jnp.float32),
                                jnp.asarray(pv, jnp.float32), jnp.asarray(tables),
                                jnp.asarray(past), interpret=True)
    live = np.array([True, True, False, True])
    np.testing.assert_allclose(_np(dec)[live], _np(want)[live], atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ moe_gemm
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_gemm_plain_matches_pallas_uneven_groups(dt):
    """Uneven expert groups: tile t of 128 rows uses expert te[t]."""
    rng = np.random.default_rng(10)
    te = np.array([0, 0, 2, 3, 3], np.int32)  # expert 1 has no rows
    x = rng.normal(size=(128 * len(te), 64))
    w = rng.normal(size=(4, 64, 256)) * 64 ** -0.5
    jx, tx = _both(x, dt)
    jw, tw = _both(w, dt)
    want = jax_moe_gemm(jx, jw, jnp.asarray(te), interpret=True)
    got = moe_gemm(tx, tw, torch.tensor(te))
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dt], rtol=TOL[dt])
    # two [E, K, N/2] panels read side by side equal the joined weight
    halves = (tw[..., :128], tw[..., 128:])
    torch.testing.assert_close(moe_gemm_ref(tx, halves, torch.tensor(te)), got)


@pytest.mark.parametrize("c", [5, 130])
def test_grouped_expert_ffn_matches_pallas(c):
    """Groups mapped to experts unevenly, C not a multiple of the tile,
    weights as views of a [n, 3, D, F] tier buffer (down transposed)."""
    rng = np.random.default_rng(11)
    d, f, n = 32, 96, 3
    buf = rng.normal(size=(n, 3, d, f)) * d ** -0.5
    h = rng.normal(size=(4, c, d))
    ge = np.array([2, 0, 2, 1], np.int32)
    want = jax_grouped_expert_ffn(
        jnp.asarray(h, jnp.float32), jnp.asarray(buf[:, 0], jnp.float32),
        jnp.asarray(buf[:, 1], jnp.float32),
        jnp.asarray(buf[:, 2].transpose(0, 2, 1), jnp.float32),
        jnp.asarray(ge), backend="pallas")
    tb = torch.tensor(buf, dtype=torch.float32)
    got = grouped_expert_ffn(torch.tensor(h, dtype=torch.float32), tb[:, 0], tb[:, 1],
                             tb[:, 2].transpose(1, 2), torch.tensor(ge))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


# --------------------------------------------------------- expert GEMV
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [64, 96])  # 96: F zero-padded to the panel
def test_cold_expert_ffn_matches_pallas(dt, f):
    rng = np.random.default_rng(12)
    e, t, d = 3, 4, 32
    x = rng.normal(size=(e, t, d))
    w1 = rng.normal(size=(e, d, f)) * d ** -0.5
    w3 = rng.normal(size=(e, d, f)) * d ** -0.5
    w2 = rng.normal(size=(e, f, d)) * f ** -0.5
    (jx, tx), (j1, t1), (j3, t3), (j2, t2) = (_both(a, dt) for a in (x, w1, w3, w2))
    want = jax_cold_expert_ffn(jx, j1, j3, j2, bf=64, backend="pallas")
    got = cold_expert_ffn(tx, t1, t3, t2)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dt], rtol=TOL[dt])


# ------------------------------------------------------ backend rule
def test_backend_rule_by_device(monkeypatch):
    cpu = torch.zeros(1)
    assert use_kernel("auto", cpu) is False
    assert use_kernel("ref", cpu) is False
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        use_kernel("cuda", cpu)
    with pytest.raises(ValueError, match="unknown"):
        use_kernel("pallas", cpu)
    # a card that is not Hopper raises instead of falling back
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "A100")
    with pytest.raises(RuntimeError, match="sm_80"):
        backend._check_card(torch.device("cuda"))
