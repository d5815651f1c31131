"""The port's flat routed MoE (`moe_forward`, both dispatches) and
`grouped_expert_matmul` against the JAX package's, on the fp32 weights
of a smoke config's MoE layer (bridged) and the same seeded inputs.

Tolerances: fp32 sums in another order, rtol 1e-5, and atol 1e-5 times
the tensor's largest magnitude (at least 1): outputs and gradients are
sums whose terms cancel, so an element near 0 carries the rounding of
its largest terms. Expert counts are equal. The
gradient check covers the dropped assignments: a token whose every
assignment overflowed its expert gets no gradient from the expert
path, in either package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.configs import get_config, reduce_for_smoke
from repro.kernels.moe_gemm import grouped_expert_matmul as jax_grouped_expert_matmul
from repro.models.moe import init_moe as jax_init_moe
from repro.models.moe import moe_forward as jax_moe_forward
from repro_torch.bridge import to_torch
from repro_torch.kernels.moe_gemm import grouped_expert_matmul
from repro_torch.models.moe import moe_forward

ATOL = RTOL = 1e-5
B, S = 2, 16


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                               moe_backend="ref")


_SETUP = {}


def _setup(arch):
    """(JAX config, port config, host params of one MoE layer, x [B, S, D])."""
    if arch not in _SETUP:
        jcfg = _f32(reduce_for_smoke(get_config(arch)))
        tcfg = _f32(tcfgs.reduce_for_smoke(tcfgs.get_config(arch)))
        ffn = jax.tree.map(np.asarray, jax_init_moe(jax.random.PRNGKey(0), jcfg))
        x = np.random.default_rng(1).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
        _SETUP[arch] = jcfg, tcfg, ffn, x
    return _SETUP[arch]


def _mask():
    m = np.ones((B, S), bool)
    m[0, 11:] = False  # a right-padded row
    m[1, :3] = False  # masked tokens ahead of real ones
    return m


CASES = {  # name -> moe_forward keyword arguments (token_mask as a flag)
    "default": {},
    "drops": dict(capacity_factor=0.5),
    "full_capacity": dict(full_capacity=True),
    "masked": dict(full_capacity=True, token_mask=True),
    "masked_drops": dict(capacity_factor=0.5, token_mask=True),
}


def _run(fwd, lib, p, cfg, x, kw, mask):
    kw = dict(kw)
    if kw.pop("token_mask", False):
        kw["token_mask"] = lib(mask)
    return fwd(p, cfg, x, **kw)


@pytest.mark.parametrize("arch,case", [("granite-moe-1b-a400m", c) for c in CASES]
                         + [("deepseek-v2-236b", "default")])
@pytest.mark.parametrize("grouped", [False, True])
def test_moe_forward_matches_reference(arch, grouped, case):
    """Output, aux loss and counts, then the gradient of
    sum(y * r) + aux with respect to x, the router and the expert
    weights (deepseek: shared experts beside the routed ones)."""
    jcfg, tcfg, ffn, x = _setup(arch)
    kw = dict(CASES[case], grouped=grouped)
    r = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jax_obj(p, xx):
        out = _run(jax_moe_forward, jnp.asarray, p, jcfg, xx, kw, _mask())
        return jnp.sum(out.y * r) + out.aux_loss, out

    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(jax_obj, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, ffn), jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in to_torch(ffn).items() if k != "shared"}
    if "shared" in ffn:
        tp["shared"] = {k: v.requires_grad_() for k, v in to_torch(ffn["shared"]).items()}
    tx = torch.tensor(x, requires_grad=True)
    out = _run(moe_forward, torch.as_tensor, tp, tcfg, tx, kw, _mask())
    _close(out.y.detach(), out_j.y, "y")
    np.testing.assert_allclose(out.aux_loss.item(), float(out_j.aux_loss), atol=ATOL, rtol=RTOL)
    assert out.expert_counts.dtype == torch.int32
    np.testing.assert_array_equal(out.expert_counts.numpy(), np.asarray(out_j.expert_counts))
    if CASES[case].get("token_mask"):
        assert int(out.expert_counts.sum()) == int(_mask().sum()) * tcfg.moe.top_k

    (torch.sum(out.y * torch.as_tensor(r)) + out.aux_loss).backward()
    grads = [("x", tx.grad, gx_j)] + [(k, tp[k].grad, gp_j[k])
                                      for k in ("router", "w_gate", "w_up", "w_down")]
    for name, got, want in grads:
        _close(got, want, name)


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, err_msg=name,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))


def test_capacity_drops_the_same_tokens():
    """At capacity factor 0.5 some tokens lose every assignment; those get
    y = 0 and no gradient, and they are the same tokens in both
    packages."""
    jcfg, tcfg, ffn, x = _setup("granite-moe-1b-a400m")
    out_j = jax_moe_forward(jax.tree.map(jnp.asarray, ffn), jcfg, jnp.asarray(x),
                            capacity_factor=0.5)
    tx = torch.tensor(x, requires_grad=True)
    out = moe_forward(to_torch(ffn), tcfg, tx, capacity_factor=0.5)
    dropped_j = np.all(np.asarray(out_j.y) == 0, axis=-1)
    dropped = (out.y == 0).all(-1)
    assert dropped_j.any()
    np.testing.assert_array_equal(dropped.numpy(), dropped_j)
    out.y.sum().backward()
    assert (tx.grad[dropped] == 0).all()


@pytest.mark.parametrize("backend", ["ref", "auto"])
def test_grouped_expert_matmul_matches_reference(backend):
    """backend="ref" is the group-size form; "auto" on a CPU tensor runs
    the padded route (sort, pad to bm, tile map, unsort) over moe_gemm's
    plain version."""
    rng = np.random.default_rng(3)
    t, d, f, e, bm = 50, 16, 24, 5, 8
    x = rng.normal(size=(t, d)).astype(np.float32)
    w = rng.normal(size=(e, d, f)).astype(np.float32)
    expert_of = rng.integers(0, e, t).astype(np.int32)
    cap = t + e * (bm - 1)
    want = jax_grouped_expert_matmul(jnp.asarray(x), jnp.asarray(expert_of), jnp.asarray(w),
                                     capacity=cap, bm=bm, backend="ref")
    got = grouped_expert_matmul(torch.tensor(x), torch.tensor(expert_of), torch.tensor(w),
                                capacity=cap, bm=bm, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.einsum("td,tdf->tf", x, w[expert_of]),
                               atol=ATOL, rtol=RTOL)


def test_flat_prefill_and_decode_match_reference():
    """Model-level prefill and decode steps of an MoE model without tiers
    (the reference's quickstart path): the flat MoE, dropless, the decode
    steps' experts as the GEMV's slots (its plain version here)."""
    from repro.models.model import decode_step as jax_decode_step
    from repro.models.model import init_params as jax_init_params
    from repro.models.model import prefill as jax_prefill
    from repro_torch.models.model import decode_step, prefill

    jcfg, tcfg, _, _ = _setup("granite-moe-1b-a400m")
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, 8)).astype(np.int32)
    logits_j, cache_j = jax_prefill(jax.tree.map(jnp.asarray, params), jcfg,
                                    {"tokens": jnp.asarray(toks)}, cache_len=12)
    tp = to_torch(params)
    logits, cache = prefill(tp, tcfg, torch.tensor(toks), cache_len=12)
    _close(logits, logits_j, "prefill logits")
    nxt = np.asarray(logits_j).argmax(-1).astype(np.int32)[:, None]
    for pos in range(8, 11):
        logits_j, cache_j, counts_j = jax_decode_step(
            jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(nxt), cache_j, pos)
        logits, cache, counts = decode_step(tp, tcfg, torch.tensor(nxt), cache, pos)
        _close(logits, logits_j, f"decode logits at {pos}")
        np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
        nxt = np.asarray(logits_j).argmax(-1).astype(np.int32)[:, None]
