"""The encoder-decoder path of the PyTorch port (seamless-m4t-large-v2)
against the JAX package, on the smoke config (2 encoder layers, 4
decoder layers, 16 frames), weights bridged from the reference's
`init_params` and the same seeded numpy tokens and frames.

At fp32 params every result is held within 1e-5 (abs + rel): cross and
non-causal `gqa_forward`, `forward_train`, `prefill` (logits and every
cache leaf k / v / ck / cv, with and without a token mask), 4 greedy
decode steps (tokens equal), and two train steps (loss, gradients, AdamW
params and moments). Checkpoints are exchanged bitwise. At the config's
own bf16 the dtype of every output and cache leaf is the reference's and
the values are held to k roundings of bf16, k = K_BF16. Frames in another
dtype than the params make the reference's scanned layers raise a
TypeError (their carry would change dtype), and the port refuses them
the same way. The paged functions and the serving loop refuse the model
in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.configs import get_config, reduce_for_smoke
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving.loop import ServingLoop as JaxServingLoop
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro.training.optimizer import adamw_update as jax_adamw_update
from repro.training.train_step import loss_fn as jax_loss_fn
from repro_torch.bridge import to_torch
from repro_torch.checkpoint import restore, save
from repro_torch.launch import train as train_launch
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.serving.loop import ServingLoop
from repro_torch.serving.paged_kv import init_paged_cache
from repro_torch.training import AdamWConfig, adamw_init, adamw_update, value_and_grad
from repro_torch.tree import leaves_with_path, tree_map

ARCH = "seamless-m4t-large-v2"
TOL = 1e-5  # atol and rtol at fp32
# bf16 roundings the logits may differ by: the packages round each
# sublayer's output and each residual add in other places, 2 a sublayer:
# 2 encoder layers x 2 sublayers and 4 decoder layers x 3 (self, cross, FFN)
K_BF16 = 2 * (2 * 2 + 4 * 3)
B, S = 2, 8


def _cfgs(fp32=True):
    jcfg = reduce_for_smoke(get_config(ARCH))
    tcfg = tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH))
    if fp32:
        jcfg = dataclasses.replace(jcfg, param_dtype="float32", compute_dtype="float32")
        tcfg = dataclasses.replace(tcfg, param_dtype="float32", compute_dtype="float32")
    return jcfg, tcfg


_PARAMS = {}


def _params(fp32=True):
    """(JAX config, port config, host params) of the smoke config."""
    if fp32 not in _PARAMS:
        jcfg, tcfg = _cfgs(fp32)
        host = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg))
        _PARAMS[fp32] = jcfg, tcfg, host
    return _PARAMS[fp32]


def _inputs(cfg, s=S, seed=0):
    """Seeded tokens [B, s] int32 and frames [B, F, D] scaled as
    `add_frames` scales them, fp32."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    frames = (rng.standard_normal((B, cfg.encdec.frontend_frames, cfg.d_model))
              .astype(np.float32) * 0.02)
    return tokens, frames


def _jframes(frames, dt):
    return jnp.asarray(frames).astype(dt)


def _tframes(frames, dt):
    return torch.as_tensor(frames).to(dt)


def _by_path(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in kp): v for kp, v in flat}


def _close(got, want, what, atol=TOL, rtol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)),
                               atol=atol, rtol=rtol, err_msg=what)


def _close_trees(got, want, what, atol=TOL, rtol=TOL):
    want = _by_path(want)
    paths = [p for p, _ in leaves_with_path(got)]
    assert sorted(paths) == sorted(want), what
    for path, leaf in leaves_with_path(got):
        _close(leaf, want[path], f"{what} {path}", atol, rtol)


def _bf16_close(got, want, what):
    """Within K_BF16 roundings of bf16: |got - want| <= k 2^-8 (|want| +
    the row's RMS)."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    rms = np.sqrt(np.mean(want ** 2, axis=-1, keepdims=True))
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= K_BF16 * 2.0 ** -8 * (np.abs(want) + rms)), (what, float(err.max()))


@pytest.mark.parametrize("mode", ["cross", "cross_bias", "noncausal", "noncausal_masked"])
def test_gqa_forward_matches_reference(mode):
    """Cross attention (q projected, with its bias if any, no RoPE on q or
    the given K/V) and the encoder's non-causal self-attention."""
    jcfg, tcfg = _cfgs()
    if mode == "cross_bias":
        jcfg = dataclasses.replace(jcfg, qkv_bias=True)
        tcfg = dataclasses.replace(tcfg, qkv_bias=True)
    p = jax.tree.map(np.asarray, jattn.init_gqa(jax.random.PRNGKey(1), jcfg))
    if mode == "cross_bias":
        p = {**p, "bq": np.random.default_rng(2).standard_normal(p["bq"].shape)
             .astype(np.float32)}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    f, hd = jcfg.encdec.frontend_frames, jcfg.resolved_head_dim
    kw_j, kw_t = {}, {}
    if mode.startswith("cross"):
        k, v = (rng.standard_normal((B, f, jcfg.n_kv_heads, hd)).astype(np.float32)
                for _ in range(2))
        kw_j["kv_override"] = (jnp.asarray(k), jnp.asarray(v))
        kw_t["kv_override"] = (torch.as_tensor(k), torch.as_tensor(v))
    if mode == "noncausal_masked":
        mask = np.arange(S)[None] < np.array([[S], [5]])
        kw_j["token_mask"], kw_t["token_mask"] = jnp.asarray(mask), torch.as_tensor(mask)
    want, (wk, wv) = jattn.gqa_forward(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
                                       jnp.asarray(pos), causal=False, **kw_j)
    got, (gk, gv) = tattn.gqa_forward(to_torch(p), tcfg, torch.as_tensor(x),
                                      torch.as_tensor(pos), causal=False, **kw_t)
    _close(got, want, "out")
    _close(gk, wk, "k")
    _close(gv, wv, "v")


@pytest.mark.parametrize("fp32", [True, False])
def test_init_params_tree_equal(fp32):
    """The port's own init has the reference's tree: the encoder subtree,
    the cross leaves of every decoder layer, shapes and dtypes."""
    jcfg, tcfg, host = _params(fp32)
    got = tmodel.init_params(0, tcfg, device="cpu")
    want = _by_path(host)
    paths = dict(leaves_with_path(got))
    assert sorted(paths) == sorted(want)
    assert ("encoder", "stack", "slot0", "mixer", "wq") in paths
    assert ("stack", "slot0", "cross", "wk") in paths
    for path, leaf in paths.items():
        w = to_torch(want[path])
        assert leaf.shape == w.shape and leaf.dtype == w.dtype, path


@pytest.mark.parametrize("remat", [True, False])
def test_forward_train_matches_reference(remat):
    jcfg, tcfg, host = _params()
    tokens, frames = _inputs(jcfg)
    fwd = jax.jit(jmodel.forward_train, static_argnums=(1, 3))
    lj, aj, cj = fwd(jax.tree.map(jnp.asarray, host), jcfg,
                     {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}, remat)
    with torch.no_grad():
        lt, at, ct = tmodel.forward_train(to_torch(host), tcfg,
                                          {"tokens": torch.as_tensor(tokens),
                                           "frames": torch.as_tensor(frames)}, remat=remat)
    _close(lt, lj, "logits")
    assert float(at) == float(aj) == 0.0
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def _prefill_both(fp32, masked, cache_len=S + 4):
    jcfg, tcfg, host = _params(fp32)
    tokens, frames = _inputs(jcfg)
    dt = jnp.float32 if fp32 else jnp.bfloat16
    mask = np.arange(S)[None] < np.array([[S], [5]]) if masked else None
    jout = jax.jit(jmodel.prefill, static_argnums=(1, 3))(
        jax.tree.map(jnp.asarray, host), jcfg,
        {"tokens": jnp.asarray(tokens), "frames": _jframes(frames, dt)}, cache_len,
        token_mask=None if mask is None else jnp.asarray(mask))
    tp = to_torch(host)
    tout = tmodel.prefill(tp, tcfg, torch.as_tensor(tokens), cache_len,
                          token_mask=None if mask is None else torch.as_tensor(mask),
                          frames=_tframes(frames, tp["embed"]["table"].dtype))
    return jcfg, tcfg, host, tokens, jout, tout


@pytest.mark.parametrize("masked", [False, True])
def test_prefill_matches_reference(masked):
    """fp32 params and frames: the last real token's logits and every
    cache leaf (k, v, ck, cv), pad entries zeroed under the mask."""
    *_, (lj, cj), (lt, ct) = _prefill_both(True, masked)
    _close(lt, lj, "logits")
    _close_trees(ct, cj, "cache")
    assert set(ct["stack"]["slot0"]) == {"k", "v", "ck", "cv"}


@pytest.mark.parametrize("masked", [False, True])
def test_prefill_bf16_dtype_trail(masked):
    """The config's own bf16, frames in bf16: every cache leaf has the
    reference's dtype (bf16, ck / cv included), the cross K/V and logits
    are within K_BF16 roundings."""
    *_, (lj, cj), (lt, ct) = _prefill_both(False, masked)
    assert lt.dtype == torch.bfloat16 and str(lj.dtype) == "bfloat16"
    want = _by_path(cj)
    for path, leaf in leaves_with_path(ct):
        assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path
        _bf16_close(leaf, want[path], path)
    _bf16_close(lt, lj, "logits")


@pytest.mark.parametrize("params_dt,frames_dt", [("float32", "bfloat16"),
                                                 ("bfloat16", "float32")])
def test_mixed_frames_dtype_refused_as_reference(params_dt, frames_dt):
    """bf16 frames under fp32 params change the encoder scan's carry dtype
    in the reference, fp32 frames under bf16 params the decoder's (at the
    first cross attention): both raise a TypeError there, and the port
    refuses them alike, in training and in prefill."""
    jcfg, tcfg, host = _params(params_dt == "float32")
    tokens, frames = _inputs(jcfg)
    jbatch = {"tokens": jnp.asarray(tokens), "frames": _jframes(frames, getattr(jnp, frames_dt))}
    with pytest.raises(TypeError):
        jmodel.forward_train(jax.tree.map(jnp.asarray, host), jcfg, jbatch)
    with pytest.raises(TypeError):
        jmodel.prefill(jax.tree.map(jnp.asarray, host), jcfg, jbatch)
    tp, tfr = to_torch(host), _tframes(frames, getattr(torch, frames_dt))
    with pytest.raises(TypeError):
        tmodel.forward_train(tp, tcfg, {"tokens": torch.as_tensor(tokens), "frames": tfr})
    with pytest.raises(TypeError):
        tmodel.prefill(tp, tcfg, torch.as_tensor(tokens), frames=tfr)
    with pytest.raises(ValueError):  # no frames at all
        tmodel.prefill(tp, tcfg, torch.as_tensor(tokens))


def test_greedy_decode_matches_reference():
    """4 greedy decode steps after the unmasked prefill: equal tokens,
    logits and every cache leaf within 1e-5; the cross K/V are read from
    the cache, never rewritten. Then the reference's own property
    (tests/test_models.py): prefill(S) + decode(token S) equals the full
    forward at position S."""
    jcfg, tcfg, host, tokens, (lj, cj), (lt, ct) = _prefill_both(True, False)
    ck0 = ct["stack"]["slot0"]["ck"].clone()
    dec = jax.jit(jmodel.decode_step, static_argnums=1)
    jp, tp = jax.tree.map(jnp.asarray, host), to_torch(host)
    tok_j = jnp.argmax(lj, -1)[:, None].astype(jnp.int32)
    tok_t = torch.argmax(lt, -1)[:, None].to(torch.int32)
    for i in range(4):
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j), err_msg=f"step {i}")
        lj, cj, _ = dec(jp, jcfg, tok_j, cj, jnp.int32(S + i))
        lt, ct, _ = tmodel.decode_step(tp, tcfg, tok_t, ct, torch.tensor(S + i))
        _close(lt, lj, f"logits step {i}")
        tok_j = jnp.argmax(lj, -1)[:, None].astype(jnp.int32)
        tok_t = torch.argmax(lt, -1)[:, None].to(torch.int32)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    _close_trees(ct, cj, "cache after decode")
    assert torch.equal(ct["stack"]["slot0"]["ck"], ck0)

    _, frames = _inputs(jcfg)
    full_tokens = np.concatenate([tokens, np.asarray(tok_j)], axis=1)  # S + 1 tokens
    _, cache = tmodel.prefill(tp, tcfg, torch.as_tensor(tokens), S + 1,
                              frames=torch.as_tensor(frames))
    step, _, _ = tmodel.decode_step(tp, tcfg, torch.as_tensor(full_tokens[:, S:]), cache,
                                    torch.tensor(S))
    with torch.no_grad():
        full, _, _ = tmodel.forward_train(tp, tcfg, {"tokens": torch.as_tensor(full_tokens),
                                                     "frames": torch.as_tensor(frames)})
    torch.testing.assert_close(step, full[:, S], atol=TOL, rtol=TOL)


def test_two_train_steps_match_reference():
    """Loss, ce, every leaf's gradient (encoder and cross leaves
    included) and the AdamW state (params, m, v, step) after each of two
    steps with frames, at AdamW's defaults."""
    jcfg, tcfg, host = _params()
    grad_fn = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True), static_argnums=1)
    jp = jax.tree.map(jnp.asarray, host)
    jopt = jax_adamw_init(jp)
    tp = to_torch(host)
    topt = adamw_init(tp)
    for step in range(2):
        tokens, frames = _inputs(jcfg, s=S + 1, seed=10 + step)
        jb = {"tokens": jnp.asarray(tokens[:, :-1]), "labels": jnp.asarray(tokens[:, 1:]),
              "frames": jnp.asarray(frames)}
        tb = {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}
        (loss_j, m_j), grads_j = grad_fn(jp, jcfg, jb)
        loss_t, m_t, grads_t = value_and_grad(tp, tcfg, tb)
        _close(loss_t, loss_j, f"loss {step}")
        _close(m_t["ce"], m_j["ce"], f"ce {step}")
        _close_trees(grads_t, grads_j, f"grad {step}")
        assert float(grads_t["encoder"]["stack"]["slot0"]["mixer"]["wq"].abs().max()) > 0
        jp, jopt = jax.jit(jax_adamw_update)(jp, grads_j, jopt)
        tp, topt = adamw_update(tp, grads_t, topt, AdamWConfig())
        _close_trees(tp, jp, f"params {step}")
        _close_trees(topt, jopt, f"opt {step}")


def test_launch_train_runs_seamless():
    """`repro_torch.launch.train` on the CPU: `add_frames`' fp32 frames go to the
    model in the params' dtype (bf16), and the loss falls."""
    losses = train_launch.main(["--arch", ARCH, "--smoke", "--steps", "6", "--batch", "2",
                                "--seq", "16", "--device", "cpu", "--log-every", "100"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_checkpoints_exchanged_bitwise(tmp_path):
    """A bf16 train state of seamless (the encoder subtree and the cross
    leaves included) saved by either package restores in the other
    bitwise."""
    jcfg, _, host = _params(fp32=False)
    jp = jax.tree.map(jnp.asarray, host)
    opt = jax_adamw_init(jp)
    state = {"params": jp, "opt": {**opt, "m": jax.tree.map(lambda p: p.astype(jnp.float32)
                                                               * 0.5, jp)}}
    host_state = jax.tree.map(np.asarray, state)
    jax_save(str(tmp_path / "j"), 3, state)
    got = restore(str(tmp_path / "j"), 3, tree_map(torch.zeros_like, to_torch(host_state)))
    want = dict(leaves_with_path(to_torch(host_state)))
    assert ("params", "encoder", "final_norm", "scale") in want
    for path, leaf in leaves_with_path(got):
        assert leaf.dtype == want[path].dtype and torch.equal(leaf, want[path]), path
    save(str(tmp_path / "t"), 4, to_torch(host_state))
    back = jax_restore(str(tmp_path / "t"), 4, jax.tree.map(jnp.zeros_like, state))
    for (kp, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(back),
                               jax.tree_util.tree_leaves_with_path(state)):
        assert g.dtype == w.dtype, kp
        np.testing.assert_array_equal(np.asarray(g.astype(jnp.float32)),
                                      np.asarray(w.astype(jnp.float32)))


def test_paged_and_serving_refuse_encdec():
    """As the reference's: paged prefill and verify assert `encdec is
    None`, its serving loop drives routed-MoE archs only. The port's
    paged layout, paged decode, prefill and verify, and its loop (either
    cache layout) refuse the model."""
    jcfg, tcfg, host = _params()
    jp = jax.tree.map(jnp.asarray, host)
    with pytest.raises(AssertionError):
        jmodel.prefill_paged(jp, jcfg, {"tokens": jnp.zeros((1, 4), jnp.int32)}, {},
                             jnp.zeros((1, 2), jnp.int32), jnp.zeros((1,), jnp.int32),
                             jnp.ones((1, 4), bool))
    with pytest.raises(AssertionError):
        JaxServingLoop(jcfg, jp, batch_size=2, cache_len=16)
    tp = to_torch(host)
    t, row = torch.zeros((1, 4), dtype=torch.int32), torch.zeros((1,), dtype=torch.int32)
    tables, mask = torch.zeros((1, 2), dtype=torch.int32), torch.ones((1, 4), dtype=torch.bool)
    with pytest.raises(NotImplementedError):
        init_paged_cache(tcfg, 2, 8, 4, device="cpu")
    with pytest.raises(NotImplementedError):
        tmodel.prefill_paged(tp, tcfg, t, {}, tables, row, mask)
    with pytest.raises(NotImplementedError):
        tmodel.decode_verify(tp, tcfg, t, {}, tables, row, mask)
    with pytest.raises(NotImplementedError):
        tmodel.decode_step_paged(tp, tcfg, t[:, :1], {}, {}, tables, row)
    moe_cfg = dataclasses.replace(tcfg, moe=tcfgs.get_config("granite-moe-1b-a400m").moe)
    for layout in ("paged", "slots"):
        with pytest.raises((AssertionError, NotImplementedError)):
            ServingLoop(tcfg, tp, batch_size=2, cache_len=16, kv_layout=layout, device="cpu")
        with pytest.raises(NotImplementedError):
            ServingLoop(moe_cfg, tp, batch_size=2, cache_len=16, kv_layout=layout,
                        device="cpu")
