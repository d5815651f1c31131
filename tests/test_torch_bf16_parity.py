"""bf16 parity gate between the PyTorch port and the JAX package.

The granite (GQA), deepseek (MLA, a dense first layer, shared experts)
and jamba (Mamba + GQA + MoE) smoke configs at their default bf16
`param_dtype` and `compute_dtype`;
both packages get the same bridged params and tier state
(`repro_torch.bridge.to_torch`), on the CPU (the port's plain versions,
the JAX package's reference backends).

(a) Layer by layer. Every layer of one `prefill_paged` chunk, then of one
`decode_step_paged` step, runs in its two residual halves: the mixer half
x + attn(norm1(x)) and the FFN half x + ffn(norm2(x)). Each half of each
package gets the SAME bf16 input, the JAX run's (the JAX run's pools and
recurrent states too, for the decode step), so errors do not compound; its output is held to
its bound, and an MoE half's router scores and expert counts are
compared.

(b) End to end. Each package runs `prefill_paged` and two
`decode_step_paged` steps on its own pools (the decode tokens are the
JAX run's argmax, fed to both), and the logits are held to the composed
bound. Then, for an attention-only arch (a recurrent one refuses
`decode_verify`), each runs one speculative verify chunk of
width V = 4 over the JAX run's pools as the prefill left them (bridged to
the port, so the cache it reads is the same in both): each row's chunk
is [the JAX prefill's argmax, random drafts], V_r in 1..4 real tokens at
positions past the row's prompt (not block-aligned), and the logits at
every real position are held.

Tolerance. Per element, |port - jax| <= k * u * (|ref| + scale), with
u = 2^-8 (bf16's unit roundoff), ref the JAX value and scale the RMS of
ref's row (over d_model, or over the vocabulary, or over the experts).
k counts the bf16 roundings on the longer of the two code paths: each
rounding perturbs a value by at most u of itself, and an intermediate's
error reaches an output element through sums over the row (matmuls with
weights drawn at fan-in^-1/2, RMS norms), where it shows at the scale of
the row rather than of the element; a value that is itself the output
(the residual sum) errs against |ref|. Counted from the JAX code, the
longer path in every half (the port keeps scores and GEMV sums in fp32):
- GQA mixer half, 11: norm1; q, k, v projections; rope of q and k; the
  scores (bf16 einsum); P cast to bf16; P V; the wo projection; the
  residual sum.
- MLA mixer half, 8: norm1; q and kv_a projections; rope of q_rope and
  krope; the latent scores, softmax and values are fp32; o cast to bf16
  after the fp32 W_v expansion; wo; the residual sum.
- Mamba mixer half, 18: norm1; in_proj (x and z); the causal conv, tap
  by tap in bf16: 4 products, 3 sums and the bias; the SiLU cast; x_proj
  (dt, B and C); dt_proj; dt, abar, Bx, the scan and C h are fp32; y cast
  to bf16; the SiLU(z) cast; y * SiLU(z); out_proj; the residual sum. The
  same in a prefill chunk (from the zero state) and a decode step (from
  the JAX run's {ssm, conv}).
- MoE FFN half, 8 + top_k (+ 6 with shared experts): norm2; the router is
  fp32; each expert's gate, up, silu cast, gate * up, down; the routing
  weight cast and the weighted product; top_k - 1 sums of a token's
  contributions (the first lands on zero, exactly); the shared experts'
  gate, up, silu cast, product, down and their sum; the residual sum.
- Dense FFN half, 7: norm2; gate, up, silu cast, gate * up, down; the
  residual sum.
- Logits, 2: the final norm and the head.
End to end the halves compose: the prefill logits take k = K + 2, K the
sum over all halves of all layers; decode step j (1, 2) reads cache
entries that carry the earlier passes' errors, so k = (j + 1) * K + 2.
The verify chunk takes the prefill step's k = K + 2: the cache it reads
is common, so no earlier pass's error reaches it, and its position i
reads the chunk's own K/V of positions 0..i, computed in the same pass,
as a prefill chunk's positions do; a chunk wider than 1 runs the MoE on
the grouped path of a prefill chunk, whose halves K counts.
With K = 84 (granite smoke: 4 layers x (11 + 10)), 87 (deepseek) or 99
(jamba: 3 Mamba, 1 GQA, 2 dense, 2 MoE halves of 18, 11, 7 and 10),
k * u is 0.34-0.39 at the prefill step and 0.66-1.17 at the decode steps:
a worst-case sum of roundings that mostly do not line up. So (b) is a
precision gate at the prefill step only (a 25% error in the logits'
scale reads 0.61 of that bound); at a decode step the bound is as large
as a typical logit, and (b) catches a fault there through its routing
(below), not through the logits. The precision gate is (a), at k <= 24
(k * u <= 0.094).

Router near-ties. Router scores are compared before top-k, held to the
bound with k = 1: from the FFN half's common input, the router path
rounds once (norm2's output; the router product is fp32). Top-k expert
sets must agree for every token whose margin between its k-th and
(k+1)-th JAX score exceeds the sum of the two scores' bounds (twice the
router-score bound): a token inside that margin is a true near-tie, and
either choice is correct at bf16. Such tokens are excluded from that
half's output comparison and from its expert counts, printed, and a layer
where more than 1 in 16 of the real tokens are excluded fails. In (b)
rows are independent at dropless capacity (cold_capacity_frac=1.0), so
(b) holds the logits of every row that had no near-tie at any layer of
(a), and also leaves out a row whose end-to-end routing differed at a
token whose margin lies within the composed router bound at that layer
(the (a) checks hold the routing itself); it names every row it leaves
out, and fails if a routing difference falls outside the composed bound.
The verify chunk applies the same rule on its own: its tokens are not
(a)'s, so only its own routing differences leave a row out.

Mutants must fail the gate: rope positions shifted by one in the port
fail (a); the last real token's logits taken one token early fail (b)'s
prefill logits; the rope of the port's paged decode alone shifted by one
fails (b) (its routing diverges in nearly every row).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.tiered_moe as jtm
import repro_torch.configs as tcfgs
import repro_torch.models.attention as tattn
import repro_torch.serving.tiered_moe as ttm
from repro.configs import get_config, reduce_for_smoke
from repro.models import layers as jlayers
from repro.models import model as jm
from repro.serving.engine import fill_tiers_from_params as jax_fill_tiers
from repro.serving.engine import init_tiered_for_model as jax_init_tiered
from repro.serving.paged_kv import init_paged_cache as jax_init_paged_cache
from repro_torch.bridge import to_torch
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tm
from repro_torch.serving.paged_kv import init_paged_cache
from repro_torch.serving.tiered_moe import TierSizes

ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-236b", "jamba-v0.1-52b"]
U = 2.0 ** -8
K_MIXER = {"attn": 11, "mla": 8, "mamba": 18}
K_HEAD = 2
K_ROUTER = 1
W, S, BS = 64, 16, 4  # rows (the decode step's tokens), chunk width, block size


def k_ffn(cfg, ffn: str) -> int:
    if ffn == "dense":
        return 7
    mo = cfg.moe
    return 8 + mo.top_k + (6 if mo.n_shared else 0)


def _f32np(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a.float().numpy()


def _bound(ref, k):
    """k * u * (|ref| + RMS of ref's row)."""
    rms = np.sqrt((ref.astype(np.float64) ** 2).mean(-1, keepdims=True))
    return k * U * (np.abs(ref) + rms)


def _hold(what, got, ref, k, keep=None):
    """Assert |got - ref| <= the k-rounding bound on the rows `keep`
    selects (a bool mask over the leading dims); returns the worst
    error over its bound."""
    got, ref = _f32np(got), _f32np(ref)
    ratio = np.abs(got - ref) / _bound(ref, k)
    if keep is not None:
        ratio = ratio[keep]
    worst = float(ratio.max()) if ratio.size else 0.0
    assert worst <= 1.0, f"{what}: error {worst:.2f}x its bound (k={k}) exceeds its bound"
    return worst


class Recorder:
    """Router scores of each package in call order (the JAX one through a
    debug callback, so it also records inside the jitted scan)."""

    def __init__(self, monkeypatch):
        self.j, self.t = [], []
        jr, tr = jtm.router_topk, ttm.router_topk

        def jax_rec(logits, k):
            jax.debug.callback(lambda a: self.j.append(np.asarray(a)), logits, ordered=True)
            return jr(logits, k)

        def port_rec(logits, k):
            self.t.append(logits.detach().float().numpy().copy())
            return tr(logits, k)

        monkeypatch.setattr(jtm, "router_topk", jax_rec)
        monkeypatch.setattr(ttm, "router_topk", port_rec)

    def pop(self):
        jax.effects_barrier()
        return self.j.pop(0), self.t.pop(0)


def _topk_sets(s, k):
    return np.sort(np.argsort(-s, -1, kind="stable")[..., :k], -1)


def _near_ties(sj, k, kr):
    """Tokens whose k-th / (k+1)-th JAX score margin is within the sum of
    the two scores' kr-rounding bounds; and that margin in u * RMS."""
    order = np.argsort(-sj, -1, kind="stable")
    srt = np.take_along_axis(sj, order, -1)
    b = np.take_along_axis(_bound(sj, kr), order, -1)
    margin = srt[..., k - 1] - srt[..., k]
    rms = np.sqrt((sj.astype(np.float64) ** 2).mean(-1))
    return margin <= b[..., k - 1] + b[..., k], margin / (U * rms)


def _setup(arch):
    jcfg = reduce_for_smoke(get_config(arch))
    tcfg = tcfgs.reduce_for_smoke(tcfgs.get_config(arch))
    assert jcfg.param_dtype == tcfg.param_dtype == "bfloat16"
    assert jcfg.compute_dtype == tcfg.compute_dtype == "bfloat16"
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tiered = jax_fill_tiers(params, jax_init_tiered(jax.random.PRNGKey(1), jcfg,
                                                    TierSizes(2, 2, 4)), jcfg)
    params, tiered = jax.tree.map(np.asarray, (params, tiered))
    rng = np.random.default_rng(11)
    nb = -(-(S + 3) // BS)
    n_blocks = W * nb + 4
    tables = rng.permutation(n_blocks)[: W * nb].reshape(W, nb).astype(np.int32)
    toks = rng.integers(0, jcfg.vocab_size, size=(W, S)).astype(np.int32)
    lens = rng.integers(4, S + 1, size=W).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tiered=tiered, tp=to_torch(params),
                tt=to_torch(tiered), tables=tables, toks=toks, lens=lens, n_blocks=n_blocks)


def _layers(st):
    """(name, sig, JAX layer params, JAX tier state) in execution order."""
    cfg, params, tiered = st["jcfg"], st["params"], st["tiered"]
    unrolled, n_groups, period = jm.stack_plan(cfg)
    for li in unrolled:
        yield f"layer{li}", jm.layer_signature(cfg, li), params[f"layer{li}"], tiered.get(
            f"layer{li}")
    for g in range(n_groups):
        for j, sig in enumerate(period):
            s = f"slot{j}"
            ts = tiered["stack"].get(s) if "stack" in tiered else None
            yield (f"group{g}/{s}", sig, jax.tree.map(lambda a: a[g], params["stack"][s]),
                   None if ts is None else jax.tree.map(lambda a: a[g], ts))


def _layer_pools(st):
    pools, _ = jax_init_paged_cache(st["jcfg"], W, st["n_blocks"], BS)
    out = {}
    for name, *_ in _layers(st):
        if name.startswith("group"):
            g, s = name[5:].split("/")
            out[name] = jax.tree.map(lambda a: a[int(g)], pools["stack"][s])
        else:
            out[name] = pools[name]
    return out


def _ffn_half(st, rec, label, sig, jp, jts, x_mid, tmask, rows, worst):
    """Both packages' FFN half on the JAX input x_mid; returns the JAX
    output. Adds the rows with a near-tie to `rows` and the worst errors
    over their bounds to `worst`."""
    jcfg, tcfg = st["jcfg"], st["tcfg"]
    tp = to_torch(jp)
    h2j = jlayers.rmsnorm(jp["norm2"], jnp.asarray(x_mid), jcfg.norm_eps)
    h2t = tlayers.rmsnorm(tp["norm2"], to_torch(x_mid), tcfg.norm_eps)
    near = np.zeros(tmask.shape, bool)
    if sig[1] == "moe":
        yj, cj = jtm.tiered_moe_forward(jp["ffn"], jts, jcfg, h2j, cold_capacity_frac=1.0,
                                        token_mask=jnp.asarray(tmask))
        yt, ct = ttm.tiered_moe_forward(tp["ffn"], to_torch(jts), tcfg, h2t,
                                        cold_capacity_frac=1.0, token_mask=torch.tensor(tmask))
        sj, stt = rec.pop()
        sj, stt = sj.reshape(*tmask.shape, -1), stt.reshape(*tmask.shape, -1)
        r = _hold(f"{label} router scores", stt[tmask], sj[tmask], K_ROUTER)
        worst["router"] = max(worst.get("router", 0.0), r)
        k = jcfg.moe.top_k
        near, margin = _near_ties(sj, k, K_ROUTER)
        near &= tmask
        setj, sett = _topk_sets(sj, k), _topk_sets(stt, k)
        wrong = (setj != sett).any(-1) & tmask & ~near
        assert not wrong.any(), f"{label}: top-k differs off a near-tie at {np.argwhere(wrong)}"
        for pos in np.argwhere(near):
            print(f"near-tie {label} row {pos[0]} token {pos[1:]}: margin "
                  f"{margin[tuple(pos)]:.2f} u*rms")
        assert near.sum() * 16 <= tmask.sum(), (
            f"{label}: {near.sum()} of {tmask.sum()} tokens are near-ties (> 1/16)")
        e = jcfg.moe.n_experts
        tie_cnt = [np.bincount(s[near].ravel(), minlength=e) for s in (setj, sett)]
        np.testing.assert_array_equal(ct.numpy() - tie_cnt[1], np.asarray(cj) - tie_cnt[0],
                                      err_msg=f"{label} expert counts")
    else:
        yj, yt = jlayers.mlp(jp["ffn"], h2j), tlayers.mlp(tp["ffn"], h2t)
    xo_j = np.asarray(jnp.asarray(x_mid) + yj)
    xo_t = to_torch(x_mid) + yt
    r = _hold(f"{label} FFN half", xo_t, xo_j, k_ffn(jcfg, sig[1]), tmask & ~near)
    worst[sig[1]] = max(worst.get(sig[1], 0.0), r)
    rows.update(int(r) for r in np.argwhere(near)[:, 0])
    return xo_j


def layer_by_layer(st, rec):
    """(a): returns (the rows with a near-tie, the JAX decode tokens)."""
    jcfg, tcfg = st["jcfg"], st["tcfg"]
    tables, lens = st["tables"], st["lens"]
    mask = np.arange(S)[None, :] < lens[:, None]
    past = np.zeros(W, np.int32)
    positions = past[:, None] + np.arange(S, dtype=np.int32)[None, :]
    pools = _layer_pools(st)
    rows: set = set()
    worst: dict = {}
    x = np.asarray(jnp.take(st["params"]["embed"]["table"], jnp.asarray(st["toks"]), axis=0))
    for name, sig, jp, jts in _layers(st):
        label = f"prefill {name}"
        half = (sig[0], "none")
        xm_j, _, _, nc = jm.apply_layer(
            jcfg, half, jp, jnp.asarray(x), jnp.asarray(positions), mode="full",
            cache=pools[name], token_mask=jnp.asarray(mask), paged_tables=jnp.asarray(tables),
            paged_past_len=jnp.asarray(past))
        tpool = to_torch(jax.tree.map(np.asarray, pools[name]))
        tpool.update(tm.init_layer_state(tcfg, half, W))  # a recurrent layer's rows
        xm_t, _, _ = tm.apply_layer(
            tcfg, half, to_torch(jp), to_torch(x), torch.tensor(positions), cache=tpool,
            tables=torch.tensor(tables), past_len=torch.tensor(past),
            token_mask=torch.tensor(mask))
        pools[name] = nc
        r = _hold(f"{label} mixer half", xm_t, xm_j, K_MIXER[sig[0]], mask)
        worst[sig[0]] = max(worst.get(sig[0], 0.0), r)
        x = _ffn_half(st, rec, label, sig, jp, jts, np.asarray(xm_j), mask, rows, worst)
    last = np.clip(lens - 1, 0, None)
    logits = jm._logits(st["params"], jcfg, jnp.asarray(x[np.arange(W), last][:, None]))
    nxt = np.asarray(logits[:, 0]).astype(np.float32).argmax(-1).astype(np.int32)[:, None]

    x = np.asarray(jnp.take(st["params"]["embed"]["table"], jnp.asarray(nxt), axis=0))
    live = np.ones((W, 1), bool)
    for name, sig, jp, jts in _layers(st):
        label = f"decode {name}"
        half = (sig[0], "none")
        xm_j, _, _, _ = jm.apply_layer(
            jcfg, half, jp, jnp.asarray(x), jnp.asarray(lens[:, None]), mode="decode",
            cache=pools[name], pos=jnp.asarray(lens), paged_tables=jnp.asarray(tables),
            token_mask=jnp.asarray(live))
        tpool = to_torch(jax.tree.map(np.asarray, pools[name]))
        xm_t, _, _ = tm.apply_layer(
            tcfg, half, to_torch(jp), to_torch(x), torch.tensor(lens[:, None]), cache=tpool,
            tables=torch.tensor(tables), pos=torch.tensor(lens), token_mask=torch.tensor(live))
        r = _hold(f"{label} mixer half", xm_t, xm_j, K_MIXER[sig[0]], live)
        worst[sig[0]] = max(worst.get(sig[0], 0.0), r)
        x = _ffn_half(st, rec, label, sig, jp, jts, np.asarray(xm_j), live, rows, worst)
    print("layer by layer, worst error over bound:",
          {k: round(v, 3) for k, v in worst.items()})
    return rows, nxt


def _k_layers(st):
    return sum(K_MIXER[sig[0]] + k_ffn(st["jcfg"], sig[1]) for _, sig, _, _ in _layers(st))


def _routing_left_out(st, rec, label, tmask, k_before, held):
    """Pop one pass's router scores (every MoE layer, in order); returns
    the rows of `held` whose top-k set differed within the composed
    router bound (k_before roundings before the pass); fails on a
    difference outside it."""
    jcfg, flipped = st["jcfg"], set()
    for name, sig, *_ in _layers(st):
        if sig[1] == "moe":
            sj, stt = rec.pop()
            sj, stt = sj.reshape(*tmask.shape, -1), stt.reshape(*tmask.shape, -1)
            k = jcfg.moe.top_k
            near, _ = _near_ties(sj, k, k_before + K_MIXER[sig[0]] + K_ROUTER)
            keep = np.array([r not in flipped and held[r] for r in range(W)])
            diff = (_topk_sets(sj, k) != _topk_sets(stt, k)).any(-1) & tmask
            diff &= keep.reshape(-1, *[1] * (diff.ndim - 1))
            assert not (diff & ~near).any(), (
                f"{label} {name}: routing differs outside the composed bound")
            flipped.update(int(r) for r in np.argwhere(diff)[:, 0])
        k_before += K_MIXER[sig[0]] + k_ffn(jcfg, sig[1])
    return flipped


def verify_chunk(st, rec, jpools, first):
    """(b)'s verify chunk: `decode_verify` of each package over the JAX
    pools `jpools` (as the prefill left them), chunk [first, drafts];
    returns (rows held, worst error over the bound)."""
    jcfg, tcfg = st["jcfg"], st["tcfg"]
    rng = np.random.default_rng(12)
    vlen = rng.integers(1, 5, size=W).astype(np.int32)
    toks = rng.integers(0, jcfg.vocab_size, size=(W, 4)).astype(np.int32)
    toks[:, 0] = first[:, 0]
    vmask = np.arange(4)[None, :] < vlen[:, None]
    past = st["lens"]
    jl, _, _, _ = jm.decode_verify(st["params"], jcfg, jnp.asarray(toks), jpools,
                                   jnp.asarray(st["tables"]), jnp.asarray(past),
                                   jnp.asarray(vmask), tiered=st["tiered"],
                                   cold_capacity_frac=1.0)
    tl, _, _ = tm.decode_verify(st["tp"], tcfg, torch.tensor(toks),
                                to_torch(jax.tree.map(np.asarray, jpools)),
                                torch.tensor(st["tables"]), torch.tensor(past),
                                torch.tensor(vmask), tiered=st["tt"], cold_capacity_frac=1.0)
    flipped = _routing_left_out(st, rec, "verify", vmask, 0, np.ones(W, bool))
    keep = np.array([r not in flipped for r in range(W)])
    print(f"verify chunk: rows left out {sorted(flipped)}")
    assert keep.sum() * 16 >= W, f"only {keep.sum()} of {W} rows left to compare"
    worst = _hold("verify chunk logits", tl, jl, _k_layers(st) + K_HEAD,
                  keep[:, None] & vmask)
    return keep, worst


def end_to_end(st, rec, nxt, rows):
    """(b): logits of prefill_paged and two decode steps, each package on
    its own pools, then the verify chunk; returns the rows compared."""
    jcfg, tcfg = st["jcfg"], st["tcfg"]
    tables, lens = st["tables"], st["lens"]
    mask = np.arange(S)[None, :] < lens[:, None]
    past = np.zeros(W, np.int32)
    jpools, _ = jax_init_paged_cache(jcfg, W, st["n_blocks"], BS)
    tpools, _ = init_paged_cache(tcfg, W, st["n_blocks"], BS, device="cpu")
    jl, jpools, jstates = jm.prefill_paged(
        st["params"], jcfg, {"tokens": jnp.asarray(st["toks"])}, jpools, jnp.asarray(tables),
        jnp.asarray(past), jnp.asarray(mask), tiered=st["tiered"], cold_capacity_frac=1.0)
    jpools_prefill, first = jpools, nxt
    tl, _, tstates = tm.prefill_paged(
        st["tp"], tcfg, torch.tensor(st["toks"]), tpools, torch.tensor(tables),
        torch.tensor(past), torch.tensor(mask), tiered=st["tt"], cold_capacity_frac=1.0)
    logits = [(tl, jl)]
    tmasks = [mask]
    pos, live = lens.copy(), np.ones(W, bool)
    for _ in range(2):
        jl, jpools, jstates, _ = jm.decode_step_paged(
            st["params"], jcfg, jnp.asarray(nxt), jpools, jstates, jnp.asarray(tables),
            jnp.asarray(pos), tiered=st["tiered"], cold_capacity_frac=1.0,
            token_mask=jnp.asarray(live))
        tl, _, _, _ = tm.decode_step_paged(
            st["tp"], tcfg, torch.tensor(nxt), tpools, tstates, torch.tensor(tables),
            torch.tensor(pos), tiered=st["tt"], cold_capacity_frac=1.0,
            token_mask=torch.tensor(live))
        logits.append((tl, jl))
        tmasks.append(live[:, None])
        nxt = np.asarray(jl).astype(np.float32).argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1
    # a routing difference within the composed router bound leaves its row
    # out from there on (the row's later layers legitimately diverge)
    k_all = _k_layers(st)
    flipped = set()
    for step, tmask in enumerate(tmasks):
        held = np.array([r not in rows | flipped for r in range(W)])
        flipped |= _routing_left_out(st, rec, f"step {step}", tmask, step * k_all, held)
    left_out = sorted(rows | flipped)
    print(f"end to end: rows left out {left_out} (near-ties in (a): {sorted(rows)}, "
          f"routing differed end to end: {sorted(flipped)})")
    keep = np.array([r not in left_out for r in range(W)])
    # not vacuous: at least 1 row in 16 is held end to end
    assert keep.sum() * 16 >= W, f"only {keep.sum()} of {W} rows left to compare"
    worst = []
    for step, (tl, jl) in enumerate(logits):
        k = (step + 1) * k_all + K_HEAD
        worst.append((round(k * U, 3), _hold(f"step {step} logits", tl, jl, k, keep)))
    if not tm.is_recurrent(tcfg):
        _, w = verify_chunk(st, rec, jpools_prefill, first)
        worst.append((round((k_all + K_HEAD) * U, 3), w))
    return keep, worst


def run_gate(arch, monkeypatch):
    st = _setup(arch)
    rec = Recorder(monkeypatch)
    rows, nxt = layer_by_layer(st, rec)
    assert not rec.j and not rec.t
    keep, worst = end_to_end(st, rec, nxt, rows)
    print(f"{arch}: {keep.sum()} of {W} rows held end to end, (k * u, worst error over "
          f"bound) per step {[(ku, round(w, 3)) for ku, w in worst]}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_port_within_derived_rounding_bounds(arch, monkeypatch):
    run_gate(arch, monkeypatch)


def test_bf16_gate_catches_a_rope_shift(monkeypatch):
    """The port's rope positions shifted by one: the prefill chunk is
    blind to it (q and k shift together, scores depend on the offset
    only), the decode step against the JAX run's cache is not."""
    rope = tattn.apply_rope
    monkeypatch.setattr(tattn, "apply_rope", lambda x, pos, theta: rope(x, pos + 1, theta))
    st = _setup("granite-moe-1b-a400m")
    with pytest.raises(AssertionError, match="exceeds its bound"):
        layer_by_layer(st, Recorder(monkeypatch))


def _last_real_one_early(x, token_mask):
    last = torch.clamp(token_mask.sum(-1) - 2, min=0)
    return x[torch.arange(x.shape[0]), last][:, None]


def _decode_rope_shift(decode_paged):
    rope = tattn.apply_rope

    def shifted(*args):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tattn, "apply_rope", lambda x, pos, theta: rope(x, pos + 1, theta))
            return decode_paged(*args)
    return shifted


END_TO_END_MUTANTS = {
    # which token's logits a prefill returns: (a) computes its own
    "last-real-token-one-early": (lambda: (tm, "_last_real", _last_real_one_early),
                                  "step 0 logits.*exceeds its bound"),
    # the decode step's query and new key rotated one position late
    "paged-decode-rope-shift": (
        lambda: (tm, "MIXERS", dict(tm.MIXERS, attn=tm.MIXERS["attn"]._replace(
            decode_paged=_decode_rope_shift(tm.MIXERS["attn"].decode_paged)))),
        "rows left to compare"),
}


@pytest.mark.parametrize("mutant", sorted(END_TO_END_MUTANTS))
def test_bf16_end_to_end_gate_catches(mutant, monkeypatch):
    """(a) runs on the port as it is (its near-tie rows and decode
    tokens), then (b) on the mutant, which (a) cannot see."""
    st = _setup("granite-moe-1b-a400m")
    rec = Recorder(monkeypatch)
    rows, nxt = layer_by_layer(st, rec)
    patch, match = END_TO_END_MUTANTS[mutant]
    monkeypatch.setattr(*patch())
    with pytest.raises(AssertionError, match=match):
        end_to_end(st, rec, nxt, rows)
