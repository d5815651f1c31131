"""Training parity of the PyTorch port with the JAX package at smoke
size, on bridged fp32 weights and the same `SyntheticCorpus` batches:
`forward_train` (logits, aux loss, expert counts) on one config of each
mixer and FFN kind, and the train step (loss, ce, aux, counts, every
leaf's gradient, one AdamW step's params and moments) against the
reference's `make_train_step` with `moe_backend="ref"` (the reference
cannot differentiate its Pallas MoE kernel).

Tolerances: fp32 sums in another order (atol 1e-5, rtol 1e-4 on
logits, losses, gradients and moments). Params after one step: at step
1 the Adam update is g / (|g| + eps) = +-1 wherever |g| >> eps, so a
gradient that differs only in its rounding moves a param by at most 2 *
lr_1 = 6e-6 (lr 3e-4 over 100 warm-up steps); atol 1e-5, rtol 1e-5.
Under gradient compression (bf16, int8) a gradient element within
rounding error of a midpoint of the compression grid may land one step
q of that grid apart, and its moments with it: there at most 0.1% of
each leaf's elements (`FLIPS`) may be off (atol, rtol), each by at most
what such steps carry into it over the two steps (`_flip_bounds`), and
the optimizer alone, fed the same gradients, is held to 1e-6.
Expert counts are equal; batches are equal bitwise. At the configs' own
bf16, the dense llama3.2-3b's logits are held to k * 2^-8 * (|ref| +
row RMS), k = `K_BF16`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.configs import get_config, reduce_for_smoke
from repro.data.pipeline import SyntheticCorpus as JaxCorpus
from repro.models.model import forward_train as jax_forward_train
from repro.models.model import init_params as jax_init_params
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro.training.optimizer import adamw_update as jax_adamw_update
from repro.training.train_step import loss_fn as jax_loss_fn
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import to_torch
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.models.model import forward_train
from repro_torch.training import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    make_train_step,
    value_and_grad,
)
from repro_torch.tree import leaves_with_path

FORWARD_ARCHS = ["llama3.2-3b", "granite-moe-1b-a400m", "deepseek-v2-236b",
                 "jamba-v0.1-52b", "xlstm-125m"]
STEP_ARCHS = ["llama3.2-3b", "granite-moe-1b-a400m", "deepseek-v2-236b", "jamba-v0.1-52b"]
ATOL, RTOL = 1e-5, 1e-4
P_ATOL = P_RTOL = 1e-5
# bf16 roundings the logits of the 4-layer smoke model may differ by: the
# packages round each layer's residual updates (attention out, FFN out and
# the two adds) in other places, 4 a layer
K_BF16 = 16
FLIPS = 1e-3  # share of a leaf's compressed moments that may sit one grid step apart
BETA1, BETA2 = AdamWConfig().beta1, AdamWConfig().beta2
B, S = 4, 32


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


_SETUP = {}


def _setup(arch, fp32=True):
    """(JAX config, port config, host params, host batch) at smoke size."""
    key = (arch, fp32)
    if key not in _SETUP:
        jcfg = reduce_for_smoke(get_config(arch))
        tcfg = tcfgs.reduce_for_smoke(tcfgs.get_config(arch))
        if fp32:
            jcfg, tcfg = _f32(jcfg), _f32(tcfg)
        jcfg = dataclasses.replace(jcfg, moe_backend="ref")
        params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
        batch = JaxCorpus(jcfg.vocab_size, seed=0).batch(0, B, S)
        _SETUP[key] = jcfg, tcfg, params, batch
    return _SETUP[key]


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _by_path(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in kp): np.asarray(v)
            for kp, v in flat}


def _close_trees(got, want, atol, rtol, what, flips=None):
    """Every leaf of `got` within (atol, rtol) of `want`'s at its path.
    With `flips` = {path: bound}, up to FLIPS of a leaf's elements may be
    off that, each by at most its bound more."""
    want = _by_path(want)
    paths = [p for p, _ in leaves_with_path(got)]
    assert sorted(paths) == sorted(want), what
    for path, leaf in leaves_with_path(got):
        g, w = leaf.detach().float().numpy(), want[path].astype(np.float32)
        if flips is None:
            np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=f"{what} {path}")
            continue
        err, allowed = np.abs(g - w), atol + rtol * np.abs(w)
        off = err > allowed
        assert off.mean() <= FLIPS, f"{what} {path}: {int(off.sum())} of {off.size} off"
        over = err - allowed - flips[path]
        assert np.all(over <= 0), (f"{what} {path}: off by up to {float(err.max()):.3e}, "
                                   f"{float(over.max()):.3e} past one grid step's carry")


def _flip_bounds(v_ref, compression):
    """{part: {path: bound}}: how far a moment (or the int8 error residual)
    may sit from the reference's after two steps in which gradient
    elements landed a step of the compression grid apart. v_ref (the
    reference's v) bounds every step's compressed gradient at an element:
    v = (1 - b2)(b2 g1^2 + g2^2), so |g_t| <= G = sqrt(v / (b2 (1 - b2))).
    The grid step q: bf16, adjacent values at |g| <= G, 2^-7 G; int8, the
    leaf's scale, max |g| / 127 <= max G / 127. A step's flip: bf16, q at
    each step; int8, q at step 1 and 2q at step 2 (step 1's flip moves
    the error residual by up to q, which the second rounding carries).
    Then m moves by (1 - b1)(b1 n1 + n2) q, v by (1 - b2)(b2 n1 q (2G +
    n1 q) + n2 q (2G + n2 q)) (|a^2 - b^2| = |a - b| |a + b|), and the
    residual, in [-scale / 2, scale / 2] on both sides, by q."""
    n1, n2 = (1, 1) if compression == "bf16" else (1, 2)
    out = {"m": {}, "v": {}, "ef": {}}
    for path, v in _by_path(v_ref).items():
        g = np.sqrt(v.astype(np.float64) / (BETA2 * (1 - BETA2)))
        q = 2.0 ** -7 * g if compression == "bf16" else np.full_like(g, g.max() / 127)
        out["m"][path] = (1 - BETA1) * (BETA1 * n1 + n2) * q
        out["v"][path] = (1 - BETA2) * (BETA2 * n1 * q * (2 * g + n1 * q)
                                        + n2 * q * (2 * g + n2 * q))
        out["ef"][path] = q
    return out


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_train_matches_reference(arch):
    jcfg, tcfg, params, batch = _setup(arch)
    fwd = jax.jit(jax_forward_train, static_argnums=1)
    logits_j, aux_j, counts_j = fwd(_jnp(params), jcfg, _jnp(batch))
    with torch.no_grad():
        logits, aux, counts = forward_train(to_torch(params), tcfg, _torch_batch(batch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(aux_j), atol=ATOL, rtol=RTOL)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))


def test_forward_train_bf16_within_rounding():
    """llama3.2-3b's smoke config at its default bf16 params. A routed
    config at bf16 is held by tests/test_torch_bf16_parity.py with its
    router near-tie rule: here a near-tie can route a token to another
    expert and move its logits by far more than rounding."""
    jcfg, tcfg, params, batch = _setup("llama3.2-3b", fp32=False)
    assert tcfg.param_dtype == "bfloat16"
    want, _, _ = jax.jit(jax_forward_train, static_argnums=1)(_jnp(params), jcfg, _jnp(batch))
    with torch.no_grad():
        got, _, _ = forward_train(to_torch(params), tcfg, _torch_batch(batch))
    want = np.asarray(want.astype(jnp.float32))
    rms = np.sqrt(np.mean(want ** 2, axis=-1, keepdims=True))
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= K_BF16 * 2.0 ** -8 * (np.abs(want) + rms)), float(err.max())


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(arch):
    """Loss, ce, aux, counts and every leaf's gradient, then one AdamW
    step's params and moments. The reference's step is its
    `make_train_step` without microbatches: `value_and_grad(loss_fn)`
    then `adamw_update`, each jitted once here (one compile of the
    gradient instead of two)."""
    jcfg, tcfg, params, batch = _setup(arch)
    jp, jb = _jnp(params), _jnp(batch)
    (loss_j, m_j), grads_j = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True),
                                     static_argnums=1)(jp, jcfg, jb)
    tp, tb = to_torch(params), _torch_batch(batch)
    loss, metrics, grads = value_and_grad(tp, tcfg, tb)
    for got, want in ((loss, loss_j), (metrics["ce"], m_j["ce"]), (metrics["aux"], m_j["aux"])):
        np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(metrics["expert_counts"].numpy(),
                                  np.asarray(m_j["expert_counts"]))
    _close_trees(grads, grads_j, ATOL, RTOL, "grad")

    new_j, opt_j = jax.jit(jax_adamw_update)(jp, grads_j, jax_adamw_init(jp))
    new, opt, out = make_train_step(tcfg, AdamWConfig())(tp, adamw_init(tp), tb)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), atol=ATOL, rtol=RTOL)
    _close_trees(new, new_j, P_ATOL, P_RTOL, "param")
    _close_trees(opt["m"], opt_j["m"], ATOL, RTOL, "m")
    _close_trees(opt["v"], opt_j["v"], ATOL, RTOL, "v")
    assert int(opt["step"]) == int(opt_j["step"]) == 1
    # the step left its inputs as they were, as the reference's does
    _close_trees(tp, params, 0, 0, "input params")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("n_micro,compression", [(2, "none"), (1, "bf16"), (1, "int8_ef")])
def test_train_step_settings_match_reference(arch, n_micro, compression):
    """Microbatch accumulation and the compressed-gradient settings: two
    steps, params and every optimizer leaf (the int8 error residual
    included)."""
    jcfg, tcfg, params, batch = _setup(arch)
    jax_step = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(compression=compression),
                                           n_microbatches=n_micro))
    step = make_train_step(tcfg, AdamWConfig(compression=compression), n_microbatches=n_micro)
    jp = _jnp(params)
    jo = jax_adamw_init(jp, JaxAdamWConfig(compression=compression))
    tp = to_torch(params)
    to = adamw_init(tp, AdamWConfig(compression=compression))
    assert ("ef" in to) == (compression == "int8_ef") == ("ef" in jo)
    corpus = JaxCorpus(jcfg.vocab_size, seed=0)
    for i in range(2):
        raw = corpus.batch(i, B, S)
        jp, jo, out_j = jax_step(jp, jo, _jnp(raw))
        tp, to, out = step(tp, to, _torch_batch(raw))
        np.testing.assert_allclose(float(out["loss"]), float(out_j["loss"]), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(float(out["ce"]), float(out_j["ce"]), atol=ATOL, rtol=RTOL)
    _close_trees(tp, jp, P_ATOL, P_RTOL, "param")
    bounds = _flip_bounds(jo["v"], compression) if compression != "none" else {}
    for part in ("m", "v") + (("ef",) if compression == "int8_ef" else ()):
        _close_trees(to[part], jo[part], ATOL, RTOL, part, flips=bounds.get(part))


@pytest.mark.parametrize("compression", ["none", "bf16", "int8_ef"])
def test_adamw_update_matches_reference_on_the_same_grads(compression):
    """Two AdamW updates fed the same gradients in both packages: the
    fp32 tensor arithmetic of beta ** step, the bias correction, the
    clip, round-half-even int8 quantisation and the error residual."""
    rng = np.random.default_rng(0)
    params = {"b": {"w": rng.normal(size=(6, 5)), "u": rng.normal(size=3)},
              "a": rng.normal(size=(4, 7))}
    params = jax.tree.map(lambda x: x.astype(np.float32), params)
    # a global norm under grad_clip: the clip factor is exactly 1 on both
    # sides, whatever order the norm sums in
    grads = [jax.tree.map(lambda x: (rng.normal(size=x.shape) * 0.05).astype(np.float32),
                          params) for _ in range(2)]
    cfg = dict(lr=1e-2, warmup_steps=3, compression=compression)
    jp, jo = _jnp(params), jax_adamw_init(_jnp(params), JaxAdamWConfig(**cfg))
    tp, to = to_torch(params), adamw_init(to_torch(params), AdamWConfig(**cfg))
    for g in grads:
        jp, jo = jax_adamw_update(jp, _jnp(g), jo, JaxAdamWConfig(**cfg))
        tp, to = adamw_update(tp, to_torch(g), to, AdamWConfig(**cfg))
    assert int(to["step"]) == int(jo["step"]) == 2
    _close_trees(tp, jp, 1e-6, 1e-6, "param")
    for part in ("m", "v") + (("ef",) if compression == "int8_ef" else ()):
        _close_trees(to[part], jo[part], 1e-6, 1e-6, part)


def test_synthetic_corpus_batches_equal_bitwise():
    for seed, step, b, s, host, n_hosts in [(0, 0, 4, 32, 0, 1), (3, 5, 8, 16, 1, 2),
                                            (7, 123, 2, 64, 0, 1)]:
        got = SyntheticCorpus(1000, seed=seed).batch(step, b, s, host, n_hosts)
        want = JaxCorpus(1000, seed=seed).batch(step, b, s, host, n_hosts)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
