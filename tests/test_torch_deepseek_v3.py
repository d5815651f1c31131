"""DeepSeek-V3 in the port (`configs/deepseek_v3_671b.py`): the noaux_tc
router, YaRN, q-LoRA MLA with the latent norms, dense leading layers, and
an expert layer that holds a share of the routed experts.

CPU: the router against a line-by-line transcription of the published
gate on hand-built scores; YaRN's frequencies and softmax scale against
their closed form; the port against the benchmark's plain float32
reference (`bench/reference/deepseek_v3.py`, on the benchmark's weights)
through the contiguous prefill and through ServingLoop's paged prefill
and decode; the shares of a layer adding up to the uncut layer; the
spans, the loop's pick counters and the mesh paths' refusal. Card
(skipped without a CUDA device): a replayed decode graph of the V3
router equals the eager call bitwise. Imports nothing of JAX, so on the
machine with the card:

  python -m pytest -q --noconftest tests/test_torch_deepseek_v3.py
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "bench"))

import system  # noqa: E402  (bench/system.py)
import weights  # noqa: E402
from reference import deepseek_v3 as ref  # noqa: E402
from reference.layers import fp8_operands  # noqa: E402
from reference.model import logits_at  # noqa: E402
from spec import dims_of  # noqa: E402

import repro_torch.obs.trace as obs_trace  # noqa: E402
import repro_torch.serving.tiered_moe as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import refuse_on_mesh  # noqa: E402
from repro_torch.configs.deepseek_v3_671b import CONFIG, reduced  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.layers import rope_frequencies  # noqa: E402
from repro_torch.models.model import init_params, layer_signature, prefill, stack_plan  # noqa: E402
from repro_torch.models.moe import (  # noqa: E402
    held_ids,
    moe_forward,
    moe_forward_mesh,
    route,
    router_noaux_tc,
)
from repro_torch.serving.batching import Request  # noqa: E402
from repro_torch.serving.engine import _fill_one  # noqa: E402
from repro_torch.serving.loop import ServingLoop  # noqa: E402
from repro_torch.serving.tiered_moe import (  # noqa: E402
    DECODE_GRAPHS,
    TierSizes,
    init_tiered_state,
    tiered_moe_forward,
    tiered_moe_forward_mesh,
)

SEED = 2**31 + 4321
# the benchmark's configuration-file keys at smoke widths: 16 routed
# experts in 4 groups of 4 (2 kept), top-4, one shared, one dense layer
TINY = {
    "name": "tiny-v3", "model_type": "deepseek_v3", "num_hidden_layers": 3,
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
    "intermediate_size": 96, "vocab_size": 256, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "first_k_dense_replace": 1, "moe_layer_freq": 1, "q_lora_rank": 24,
    "n_routed_experts": 16, "num_experts_per_tok": 4, "moe_intermediate_size": 32,
    "n_shared_experts": 1, "norm_topk_prob": True, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "n_group": 4,
    "topk_group": 2, "topk_method": "noaux_tc", "scoring_func": "sigmoid",
    "routed_scaling_factor": 2.5, "num_nextn_predict_layers": 0,
    "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 1, "mscale_all_dim": 1},
    "served_dtype": "float32",
}


def _tiny(held=None):
    return dims_of(dict(TINY, **({"held_experts": held} if held else {})))


# ------------------------------------------------------------- routing
def _gate_transcribed(logits, bias, n_group, topk_group, k, scale):
    """DeepSeek-V3's MoEGate (topk_method noaux_tc, scoring sigmoid,
    norm_topk_prob) one token at a time in plain Python: [{expert:
    weight}] per token."""
    out = []
    for row in logits.tolist():
        scores = [1.0 / (1.0 + math.exp(-v)) for v in row]
        choice = [s + b for s, b in zip(scores, bias.tolist())]
        per = len(row) // n_group
        group_scores = [sum(sorted(choice[g * per:(g + 1) * per], reverse=True)[:2])
                        for g in range(n_group)]
        kept = sorted(range(n_group), key=lambda g: -group_scores[g])[:topk_group]
        candidates = [e for e in range(len(row)) if e // per in kept]
        ids = sorted(candidates, key=lambda e: -choice[e])[:k]
        total = sum(scores[e] for e in ids)
        out.append({e: scores[e] / total * scale for e in ids})
    return out


def _hand_scores():
    """32 experts in 8 groups of 4 (4 kept), top-8. Token 0: expert 3 has
    the highest score of all, but its group's second is the lowest, so
    the group limit drops it. Token 1: seven experts of groups 3 and 4
    lead, and experts 8 and 9 score alike for the eighth place: the bias
    decides between them."""
    logits = torch.full((2, 32), -3.0)
    logits[0, 3], logits[0, 0:3] = 4.0, -6.0  # group 0: one high, the rest lowest
    for g in range(1, 8):  # the other groups: two fair scores each, rising by group
        logits[0, 4 * g:4 * g + 2] = torch.tensor([0.5, 0.4]) + 0.1 * g
    logits[1, 12:19] = 3.0
    logits[1, 8:10] = torch.tensor([2.0, 1.99])
    logits[1, 20:22] = torch.tensor([1.0, 0.9])
    bias = torch.zeros(32)
    bias[9] = 0.05  # lifts expert 9 over expert 8
    return logits, bias


def test_noaux_tc_matches_the_transcribed_gate_where_group_and_bias_decide():
    logits, bias = _hand_scores()
    mo = dataclasses.replace(CONFIG.moe, n_experts=32)
    want = _gate_transcribed(logits, bias, 8, 4, 8, 2.5)
    # the hand-built cases do what they are for
    assert 3 in torch.topk(logits[0], 8).indices.tolist() and 3 not in want[0]
    no_bias = _gate_transcribed(logits, torch.zeros(32), 8, 4, 8, 2.5)
    assert 9 in want[1] and 8 not in want[1] and 8 in no_bias[1] and 9 not in no_bias[1]
    _, w, idx = router_noaux_tc(logits, bias, mo)
    for t in range(2):
        got = dict(zip(idx[t].tolist(), w[t].tolist()))
        assert set(got) == set(want[t])
        for e in got:
            assert got[e] == pytest.approx(want[t][e], rel=1e-6)
        assert sum(got.values()) == pytest.approx(2.5, rel=1e-6)


def test_noaux_tc_on_random_logits_and_a_held_share():
    g = torch.Generator().manual_seed(3)
    logits, bias = torch.randn(64, 256, generator=g), 0.02 * torch.randn(256, generator=g)
    mo = dataclasses.replace(CONFIG.moe, n_experts=64, n_routed=256, held_from=64)
    want = _gate_transcribed(logits, bias, 8, 4, 8, 2.5)
    probs, w, idx = route({"router_bias": bias}, mo, logits)
    idx, held = held_ids(mo, idx)
    assert probs.shape == (64, 256) and held.shape == (64, 8)
    for t in range(64):
        got = {int(i) + 64: float(x) for i, x, h in zip(idx[t], w[t], held[t]) if h}
        ours = {e: x for e, x in want[t].items() if 64 <= e < 128}
        assert set(got) == set(ours)
        assert all(got[e] == pytest.approx(ours[e], rel=1e-6) for e in got)
    # about a quarter of the picks land in a quarter of the experts
    assert 0.15 < float(held.float().mean()) < 0.35


# ------------------------------------------------------------------ YaRN
def test_yarn_frequencies_and_scale_against_the_closed_form():
    y = CONFIG.mla.yarn
    # the dims turning 32 and 1 times over the original 4096 positions
    at = lambda rot: 64 * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(10000))  # noqa: E731
    low, high = math.floor(at(32)), math.ceil(at(1))
    assert (low, high) == (10, 23)
    got = rope_frequencies(64, 10000.0, yarn=y).double()
    for i in range(32):
        base = 10000.0 ** (-i / 32)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        assert float(got[i]) == pytest.approx(base / 40 * ramp + base * (1 - ramp), rel=1e-6)
    assert float(got[5]) == pytest.approx(10000.0 ** (-5 / 32), rel=1e-6)  # extrapolated
    assert float(got[30]) == pytest.approx(10000.0 ** (-30 / 32) / 40, rel=1e-6)  # interpolated
    assert torch.equal(rope_frequencies(64, 10000.0), rope_frequencies(64, 10000.0, yarn=None))
    m = 0.1 * math.log(40) + 1
    assert m * m == pytest.approx(1.874, abs=5e-4)
    assert attn._mla_scale(CONFIG) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    v2 = get_config("deepseek-v2-236b")
    assert attn._mla_scale(v2) == 192 ** -0.5


# ----------------------------------------------------- the configuration
def test_published_config_lays_out_and_counts_as_published():
    assert get_config("deepseek-v3-671b") is CONFIG
    sigs = [layer_signature(CONFIG, i) for i in range(61)]
    assert sigs[:3] == [("mla", "dense")] * 3 and set(sigs[3:]) == {("mla", "moe")}
    unrolled, n_groups, period = stack_plan(CONFIG)
    assert (unrolled, n_groups, period) == ([0, 1, 2], 58, [("mla", "moe")])
    # 671B in the main model (the MTP module's 14B left out)
    assert 0.99 * 671e9 < CONFIG.param_count() < 1.01 * 671e9
    assert 36e9 < CONFIG.active_param_count() < 38.5e9
    small = reduced()
    assert small.mla.q_lora_rank and small.mla.yarn is not None and small.moe.router == "noaux_tc"


def test_mesh_paths_refuse_what_they_do_not_run():
    cfg = reduced()
    with pytest.raises(ValueError, match="q_lora_rank.*YaRN.*noaux_tc"):
        refuse_on_mesh(cfg, "serving")
    for call in (lambda: tiered_moe_forward_mesh(None, {}, {}, cfg, None),
                 lambda: moe_forward_mesh(None, {}, cfg, None, full_capacity=True),
                 lambda: attn.mla_prefill_mesh(None, {}, cfg, None, None, None),
                 lambda: attn.mla_decode_mesh(None, {}, cfg, None, None, None,
                                              torch.zeros(1, dtype=torch.int32))):
        with pytest.raises(ValueError, match="on a mesh does not run"):
            call()
    share = dataclasses.replace(get_config("deepseek-v2-236b"), moe=dataclasses.replace(
        get_config("deepseek-v2-236b").moe, n_routed=320))
    with pytest.raises(ValueError, match="a share of 160 of 320"):
        refuse_on_mesh(share, "serving")
    refuse_on_mesh(get_config("deepseek-v2-236b"), "serving")  # the default runs


# ----------------------------------------------- against the reference
def _port(dims):
    cfg = system.port_config(dims)
    return cfg, system.build_params(dims, cfg, SEED, "cpu")


@pytest.mark.parametrize("held", [None, {"first": 4, "count": 8}], ids=["all", "share"])
def test_port_prefill_matches_the_reference(held):
    dims = _tiny(held)
    cfg, params = _port(dims)
    seq = torch.as_tensor(np.random.default_rng(0).integers(0, dims.vocab, 24))
    at = torch.arange(24)
    want = logits_at(dims, SEED, [seq], [at], "cpu")[0]
    rows = seq[None, :].repeat(24, 1)
    mask = at[None, :] <= at[:, None]
    got, _ = prefill(params, cfg, rows.int(), token_mask=mask)
    err = (want - got.float()).abs().max()
    scale = want.abs().max()
    assert err <= 1e-4 * scale
    low = logits_at(dims, SEED, [seq], [at], "cpu", quant=fp8_operands)[0]
    # the float8 control sits far outside float32 rounding
    assert (want - low).abs().max() > 100 * err and (want - low).abs().max() > 1e-3 * scale


@pytest.mark.parametrize("held", [None, {"first": 8, "count": 8}], ids=["all", "share"])
def test_serving_loop_paged_prefill_then_decode_matches_the_reference(held):
    """Logits of every decode step ServingLoop runs (paged, chunked prefill
    sharing a prefix first) against the reference's full forward over
    the request's prompt and tokens, at the position the step fed."""
    dims = _tiny(held)
    cfg, params = _port(dims)
    loop = ServingLoop(cfg, params, batch_size=4, n_groups=2, cache_len=64,
                       prefill_chunk_tokens=8, sizes=TierSizes(2, 2, dims.n_experts - 4),
                       block_size=4, device="cpu")
    seen = []  # (rid, position fed, logits)
    step = loop.engine.step_slots_paged

    def record(tokens, pos, slot_indices, tables, live=None):
        logits, counts = step(tokens, pos, slot_indices, tables, live=live)
        for row, i in enumerate(slot_indices):
            if live is None or live[row]:
                seen.append((loop.batcher.slots[i].request.rid, int(pos[row]),
                             logits[row].clone()))
        return logits, counts

    loop.engine.step_slots_paged = record
    rng = np.random.default_rng(5)
    system_prompt = rng.integers(0, dims.vocab, 12)
    reqs = [Request(rid=r, prompt=np.concatenate([system_prompt, rng.integers(
        0, dims.vocab, 3 + 5 * r)]).astype(np.int32), max_new_tokens=6) for r in range(3)]
    loop.submit(reqs[0])
    loop.run()  # the shared prompt's blocks enter the radix
    for r in reqs[1:]:
        loop.submit(r)
    loop.run()
    assert loop.kv.stats.hit_tokens >= 2 * 12  # ... and the later requests reuse them
    by_rid = {r.rid: r for r in reqs}
    seqs, ats, rows = [], [], []
    for rid, r in by_rid.items():
        toks = np.concatenate([r.prompt, np.asarray(r.generated[:-1], np.int32)])
        mine = [(p, lg) for q, p, lg in seen if q == rid]
        assert len(mine) == len(r.generated) - 1
        seqs.append(torch.as_tensor(toks.astype(np.int64)))
        ats.append(torch.as_tensor([p for p, _ in mine]))
        rows.append(torch.stack([lg for _, lg in mine]).float())
    want = logits_at(dims, SEED, seqs, ats, "cpu")
    for w, g in zip(want, rows):
        assert (w - g).abs().max() <= 1e-4 * w.abs().max()
    # the loop's pick counters: every pick held, or a part of them
    assert loop.routed_picks == 4 * 2 * sum(len(r.generated) - 1 for r in reqs)
    if held is None:
        assert loop.held_picks == loop.routed_picks
    else:
        assert 0 < loop.held_picks < loop.routed_picks


def _ffn_params(w, lo=0, n=None):
    """The port's MoE params of the drawn leaves `w`: the router, its
    bias, experts [lo, lo + n) and the shared expert."""
    n = w["ffn.w_gate"].shape[0] if n is None else n
    return {"router": w["ffn.router"], "router_bias": w["ffn.router_bias"],
            "w_gate": w["ffn.w_gate"][lo:lo + n], "w_up": w["ffn.w_up"][lo:lo + n],
            "w_down": w["ffn.w_down"][lo:lo + n],
            "shared": {k: w[f"ffn.shared.{k}"] for k in ("w_gate", "w_up", "w_down")}}


def _tiered(cfg, p, device="cpu"):
    """One layer's tier buffers holding p's experts (2 hot, 1 warm, the
    rest cold)."""
    e = cfg.moe.n_experts
    gen = torch.Generator(device=device).manual_seed(0)
    st = init_tiered_state(gen, cfg, TierSizes(2, 1, e - 3))
    _fill_one(st, p["w_gate"], p["w_up"], p["w_down"])
    return st


@pytest.mark.parametrize("path", ["flat", "tiered"])
def test_shares_add_up_to_the_uncut_reference_layer(path):
    """Four chips' shares of one MoE layer (4 of 16 experts each), the
    shared expert counted once, give what the reference's uncut layer
    gives; each share's counts are its own experts'."""
    full = _tiny()
    w = weights.layer_leaves(full, SEED, 1, "cpu")
    x = torch.randn(1, 20, full.d_model, generator=torch.Generator().manual_seed(1))
    want = ref.moe(w, x[0], full, None)
    cfg_full = system.port_config(full)
    total, counts = torch.zeros_like(x), []
    for chip in range(4):
        cfg = dataclasses.replace(cfg_full, moe=dataclasses.replace(
            cfg_full.moe, n_experts=4, n_routed=16, held_from=4 * chip))
        p = _ffn_params(w, 4 * chip, 4)
        if path == "flat":
            out = moe_forward(p, cfg, x, full_capacity=True)
            y, c = out.y, out.expert_counts
        else:
            y, c = tiered_moe_forward(p, _tiered(cfg, p), cfg, x, cold_capacity_frac=1.0)
        total, counts = total + y, counts + [c]
    sh = _ffn_params(w)["shared"]
    a = torch.nn.functional.silu(x[0] @ sh["w_gate"][0]) * (x[0] @ sh["w_up"][0])
    shared = a @ sh["w_down"][0]
    got = total[0] - 3 * shared
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.cat(counts).sum() == 20 * 4 and all(c.shape == (4,) for c in counts)


def test_moe_spans_name_the_share_and_the_router():
    cfg = dataclasses.replace(reduced(), moe=dataclasses.replace(
        reduced().moe, n_experts=4, n_routed=16, held_from=12))
    w = weights.layer_leaves(_tiny(), SEED, 1, "cpu")
    p = _ffn_params(w, 12, 4)
    before = obs_trace._INSTALLED
    tr = obs_trace.Tracer(enabled=True)
    obs_trace.install_tracer(tr)
    try:
        tiered_moe_forward(p, _tiered(cfg, p), cfg, torch.randn(3, 1, 64), layer=2)
    finally:
        obs_trace.install_tracer(before)
    spans = {e["name"]: e for e in tr.events if e.get("ph") == "X"}
    assert spans["moe"]["args"] == {"layer": 2, "tokens": 3, "graph": "eager",
                                    "held": "12-15/16", "router": "noaux_tc"}
    assert spans["moe.route"]["args"] == {"groups": "2/4"}


def test_mixer_spans_carry_the_q_rank():
    cfg = reduced()
    params = init_params(0, cfg, "cpu")
    before = obs_trace._INSTALLED
    tr = obs_trace.Tracer(enabled=True)
    obs_trace.install_tracer(tr)
    try:
        prefill(params, cfg, torch.zeros(1, 4, dtype=torch.int32))
    finally:
        obs_trace.install_tracer(before)
    mixers = [e["args"] for e in tr.events if e.get("ph") == "X" and e["name"] == "layer.mixer"]
    assert [m["q_lora"] for m in mixers] == [24] * 3 and {m["kind"] for m in mixers} == {"mla"}


# ------------------------------------------------------------------ card
def test_decode_graph_replay_equals_the_eager_call():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100): the decode graphs capture and replay there")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    DECODE_GRAPHS.clear()
    try:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(reduced(), param_dtype=dtype, moe=dataclasses.replace(
                reduced().moe, n_experts=8, n_routed=16, held_from=8))
            params = init_params(0, cfg, dev)
            p = params["stack"]["slot1"]["ffn"]
            p = {k: v[0] if isinstance(v, torch.Tensor) else {kk: vv[0] for kk, vv in v.items()}
                 for k, v in p.items()}
            p["router_bias"] = 0.02 * torch.randn(16, device=dev)
            st = _tiered(cfg, p, dev)
            p = {k: v for k, v in p.items() if k not in ("w_gate", "w_up", "w_down")}
            for b in (1, 8, 32):
                mask = (torch.arange(b, device=dev) % 3 != 2)[:, None]
                n = len(DECODE_GRAPHS)
                for s in range(3):  # capture, then two replays
                    g = torch.Generator(device=dev).manual_seed(100 * b + s)
                    x = torch.randn((b, 1, 64), generator=g, device=dev).to(
                        getattr(torch, dtype))
                    got = tiered_moe_forward(p, st, cfg, x, token_mask=mask)
                    want = tm._tiered_moe(p, st, cfg, x, 0.25, mask, None, None)
                    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                assert len(DECODE_GRAPHS) == n + 1
    finally:
        DECODE_GRAPHS.clear()
