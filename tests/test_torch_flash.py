"""Flash attention of the PyTorch port against the JAX package, on the
same seeded numpy inputs: the port's `mha` entry point (plain version on
the CPU) against the JAX `mha(backend="ref")` oracle and against the JAX
Pallas kernel `flash_attention` in interpret mode, causal and not, with
as many or fewer queries than keys (causal queries sit at the end).

Tolerances: fp32 2e-5 (the same products summed in another order); bf16
2e-2 (both sides round P and the output to bf16, 8 mantissa bits; the
JAX oracle also rounds the scores to bf16 before the softmax).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention import mha as jax_mha
from repro_torch.kernels.flash_attention import (
    attention_ref,
    flash_attention,
    mha,
    rounding_bound,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dt: str):
    return jnp.asarray(a, JDT[dt]), torch.tensor(a, dtype=torch.float32).to(TDT[dt])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(seed, b, sq, sk, h, dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, dh)), rng.normal(size=(b, sk, h, dh)),
            rng.normal(size=(b, sk, h, dh)))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,sq,sk,dh", [
    (1, 2, 64, 64, 32),
    (2, 3, 32, 96, 16),  # fewer queries than keys: queries at the end
])
def test_mha_plain_matches_jax_oracle(dt, causal, b, h, sq, sk, dh):
    q, k, v = _qkv(0, b, sq, sk, h, dh)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dt) for a in (q, k, v))
    want = jax_mha(jq, jk, jv, causal=causal, backend="ref")
    got = mha(tq, tk, tv, causal=causal)
    assert got.dtype == TDT[dt] and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk,bq,bk", [
    (True, 64, 64, 32, 32),
    (True, 32, 128, 32, 64),
    (False, 64, 96, 32, 32),
])
def test_flash_attention_plain_matches_pallas(dt, causal, sq, sk, bq, bk):
    """The kernel-layout wrapper [BH, S, dh] against the Pallas kernel
    (interpret mode): the same blockwise online softmax, P rounded to
    the value dtype, fp32 sums."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(6, sq, 32))
    k = rng.normal(size=(6, sk, 32))
    v = rng.normal(size=(6, sk, 32))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dt) for a in (q, k, v))
    want = jax_flash_attention(jq, jk, jv, causal=causal, bq=bq, bk=bk, interpret=True)
    got = flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dt], rtol=TOL[dt])


def test_mha_layout_and_tile_arguments():
    """mha is attention_ref in the [B, S, H, hd] layout; bq / bk are
    accepted for call parity (any positive size gives the same result)."""
    q, k, v = (torch.tensor(a, dtype=torch.float32) for a in _qkv(2, 2, 24, 40, 3, 16))
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         causal=True).transpose(1, 2)
    torch.testing.assert_close(mha(q, k, v), want, rtol=0, atol=0)
    torch.testing.assert_close(mha(q, k, v, bq=7, bk=5, backend="ref"), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="tile sizes"):
        mha(q, k, v, bq=0)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        mha(q, k, v, backend="cuda")


def _online_softmax_bf16(q, k, v, causal, tile=32, drop_tile=None):
    """A flash kernel's arithmetic on the CPU: key tiles of `tile` (32 for
    the CUDA-core kernel, 128 for the tensor-core bf16 kernel), running
    max and sum in fp32, p = exp(s - running max) rounded to bf16 before
    PV, output acc / max(l, 1e-30) rounded to bf16. `drop_tile` skips the
    key tile starting there (a fault)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    bh, sq, dh = q.shape
    sk = k.shape[1]
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, dh)
    for t0 in range(0, sk, tile):
        if t0 == drop_tile:
            continue
        kpos = torch.arange(t0, min(t0 + tile, sk))[None, :]
        s = qf @ kf[:, t0:t0 + tile].transpose(1, 2) * dh ** -0.5
        if causal:
            s = torch.where(kpos <= qpos, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p, alpha = torch.exp(s - m_new), torch.exp(m - m_new)
        l, m = l * alpha + p.sum(-1, keepdim=True), m_new
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, t0:t0 + tile]
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("causal,sq,sk", [(True, 256, 256), (True, 40, 200), (False, 64, 96)])
def test_rounding_bound_holds_for_the_kernel_arithmetic(causal, sq, sk, tile):
    """`rounding_bound`, which the card holds the bf16 flash kernel to,
    covers the kernel's own rounding at either kernel's key-tile width
    and is tight enough that one skipped key tile (the last one walked)
    breaks it."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.tensor(rng.normal(size=(2, n, 64)), dtype=torch.bfloat16)
               for n in (sq, sk, sk))
    want = flash_attention(q, k, v, causal=causal)
    bound = rounding_bound(q[None], k[None], v[None], causal=causal)[0]
    err = (_online_softmax_bf16(q, k, v, causal, tile).float() - want.float()).abs()
    assert (err <= bound).all()
    dropped = _online_softmax_bf16(q, k, v, causal, tile, drop_tile=(sk - 1) // tile * tile)
    assert ((dropped.float() - want.float()).abs() > bound).any()
