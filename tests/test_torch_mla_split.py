"""The arithmetic of the bf16-pool MLA kernel (csrc/paged_attention_mla.cu)
on the CPU: q enters the tensor cores as three bf16 terms (all 24 bits of
fp32) and P as two (16 bits), each product of a term with a bf16 latent
is exact in fp32, and the sums are fp32. `paged_prefill_mla_split`
(kernels/paged_attention/ref.py) emulates that arithmetic; it is held to
the plain version at the card test's tolerance (1e-5) and to the JAX
Pallas kernel in interpret mode at the tolerance of
tests/test_torch_mla.py (2e-5). A one-term mutant (q and P rounded once
to bf16) misses 1e-5, which is why the split exists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_prefill_mla as jax_paged_prefill_mla
from repro_torch.kernels.paged_attention.kernel import MLA_CLUSTERS_PER_SM, key_splits
from repro_torch.kernels.paged_attention.ref import (
    paged_prefill_mla_ref,
    paged_prefill_mla_split,
    split_bf16,
)

TOL = 1e-5  # the card test's, tests/test_torch_cuda_kernels.py
JAX_TOL = 2e-5  # tests/test_torch_mla.py's
DEEPSEEK_SCALE = (128 + 64) ** -0.5


def _case(seed, b, c, h, r, rd, nb, bs=4):
    """Random fp32 queries and bf16 latent pools; row 1 dead (an
    all-trash table, length 0), the other rows random past / length."""
    rng = np.random.default_rng(seed)
    n_blocks = b * nb + 2
    tables = rng.permutation(n_blocks)[: b * nb].reshape(b, nb)
    tables[1] = n_blocks
    past = rng.integers(0, nb * bs - c + 1, size=b)
    lengths = rng.integers(1, c + 1, size=b)
    lengths[1] = 0
    return (rng.normal(size=(b, c, h, r)).astype(np.float32),
            rng.normal(size=(b, c, h, rd)).astype(np.float32),
            rng.normal(size=(n_blocks + 1, bs, r)), rng.normal(size=(n_blocks + 1, bs, rd)),
            tables.astype(np.int32), past.astype(np.int32), lengths.astype(np.int32))


def _torch(case):
    ql, qr, pc, pr, tables, past, lengths = case
    bf = lambda a: torch.tensor(a, dtype=torch.float32).to(torch.bfloat16)  # noqa: E731
    return (torch.tensor(ql), torch.tensor(qr), bf(pc), bf(pr), torch.tensor(tables),
            torch.tensor(past), torch.tensor(lengths))


def _err_over_tol(got, want, lengths, tol=TOL):
    real = torch.arange(got.shape[1])[None, :] < lengths[:, None]
    return float(((got - want).abs() / (tol + tol * want.abs()))[real].max())


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_split_bf16_recomposes_fp32(terms):
    """The terms sum to x within 2^(-8 terms) |x|: exactly with three."""
    rng = np.random.default_rng(terms)
    x = torch.tensor(rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, size=4096),
                     dtype=torch.float32)
    parts = split_bf16(x, terms)
    assert len(parts) == terms and all(t.dtype == torch.bfloat16 for t in parts)
    total = sum(t.double() for t in parts)
    if terms == 3:
        assert torch.equal(total, x.double())
    else:
        assert ((total - x.double()).abs() <= 2.0 ** (-8 * terms) * x.double().abs()).all()
        assert not torch.equal(total, x.double())


def test_split_term_products_are_exact_in_fp32():
    """Each term times a bf16 latent is exact in fp32 (8 x 8 significant
    bits), so the tensor cores' products lose nothing."""
    rng = np.random.default_rng(7)
    q = torch.tensor(rng.normal(size=(64, 576)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(576,)), dtype=torch.float32).to(torch.bfloat16)
    for part in split_bf16(q, 3):
        prod32 = part.float() * k.float()
        assert torch.equal(prod32.double(), part.double() * k.double())


@pytest.mark.parametrize("seed,b,c,h,r,rd,nb,scale", [
    (4, 4, 1, 16, 64, 16, 5, 0.1),   # the card test's widths: decode
    (5, 4, 5, 7, 64, 16, 5, 0.1),    # ragged heads
    (6, 4, 8, 40, 64, 16, 5, 0.1),   # ragged 64-row tiles
    (1, 2, 1, 128, 512, 64, 18, DEEPSEEK_SCALE),  # deepseek widths: decode
    (3, 2, 4, 128, 512, 64, 18, DEEPSEEK_SCALE),  # and a chunk
])
def test_split_emulation_matches_plain(seed, b, c, h, r, rd, nb, scale):
    args = _torch(_case(seed, b, c, h, r, rd, nb))
    got = paged_prefill_mla_split(*args, scale=scale)
    want = paged_prefill_mla_ref(*args, scale=scale)
    assert got.shape == want.shape and torch.isfinite(got).all()  # dead row too
    assert _err_over_tol(got, want, args[-1]) < 1.0


@pytest.mark.parametrize("seed,c,h,bs,nb", [(0, 5, 4, 4, 4), (2, 3, 3, 8, 2)])
def test_split_emulation_matches_pallas(seed, c, h, bs, nb):
    case = _case(seed, 3, c, h, 32, 8, nb, bs=bs)
    ql, qr, pc, pr, tables, past, lengths = case
    scale = (16 + 8) ** -0.5
    want = jax_paged_prefill_mla(
        jnp.asarray(ql), jnp.asarray(qr), jnp.asarray(pc, jnp.bfloat16),
        jnp.asarray(pr, jnp.bfloat16), jnp.asarray(tables), jnp.asarray(past),
        jnp.asarray(lengths), scale=scale, interpret=True)
    got = paged_prefill_mla_split(*_torch(case), scale=scale)
    real = np.arange(c)[None, :] < lengths[:, None]
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want, np.float32)[real],
                               atol=JAX_TOL, rtol=JAX_TOL)


@pytest.mark.parametrize("seed,b,c,h,r,rd,nb,scale", [
    (4, 4, 1, 16, 64, 16, 5, 0.1),
    (1, 2, 1, 128, 512, 64, 18, DEEPSEEK_SCALE),
])
def test_one_bf16_rounding_misses_the_tolerance(seed, b, c, h, r, rd, nb, scale):
    """The mutant a FlashMLA-style kernel would be: q and P rounded once."""
    args = _torch(_case(seed, b, c, h, r, rd, nb))
    want = paged_prefill_mla_ref(*args, scale=scale)
    once = paged_prefill_mla_split(*args, scale=scale, q_terms=1, p_terms=1)
    assert _err_over_tol(once, want, args[-1]) > 10.0


@pytest.mark.parametrize("clusters,key_tiles,want", [
    (8, 2, 1),      # decode B=4 as served: 72 keys, nothing to split
    (8, 64, 8),     # decode B=4 over 4096 keys: one wave of 128 CTAs
    (256, 2, 1),    # a prefill chunk fills the card on its own
    (1, 64, 32),    # one row tile: at least two key tiles a split
    (70, 64, 1),    # more clusters than one wave holds
])
def test_mla_splits(clusters, key_tiles, want):
    assert key_splits(clusters, key_tiles, 132, MLA_CLUSTERS_PER_SM) == want
