"""The tiered MoE's decode calls as CUDA graphs (`serving/tiered_moe.py`,
`DecodeGraphs`).

CPU: a decode call runs eagerly there and says so in its `moe` span; the
graph key follows the width, the mask's presence and a rebound state
tensor and nothing else; the eager body equals a plain per-token loop.

Card (skipped without a CUDA device): a replay equals the eager body
bitwise in y and counts, for the deepseek and jamba smoke configurations
and one at deepseek-v2-lite's widths, fp32 and bf16, widths 1-32, with and
without dead rows; after migrations between replays; the counts a call
returned stay as they were when a later call replays the same graph; a
replayed call makes no host sync. Imports nothing of JAX, so on the
machine with the card:

  python -m pytest -q --noconftest tests/test_torch_moe_graph.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.obs.trace as obs_trace
import repro_torch.serving.tiered_moe as tm
from repro_torch.configs import get_config
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.kernels.expert_gemv.kernel import expert_ffn_gemv
from repro_torch.models.layers import make_generator
from repro_torch.models.moe import init_moe
from repro_torch.serving.tiered_moe import (
    DECODE_GRAPHS,
    TierSizes,
    apply_migrations,
    graph_key,
    init_tiered_state,
    tiered_moe_forward,
)

ARCHS = ("deepseek-v2-236b", "jamba-v0.1-52b")
WIDTHS = (1, 2, 4, 8, 16, 32)


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(reduce_for_smoke(get_config(arch)), param_dtype=dtype)


def _lite(dtype):
    """The deepseek smoke configuration at deepseek-v2-lite's MoE widths:
    d_model 2048, 64 experts of 1408 columns, top-6, 2 shared."""
    cfg = _cfg("deepseek-v2-236b", dtype)
    moe = dataclasses.replace(cfg.moe, n_experts=64, d_expert=1408, top_k=6, n_shared=2)
    return dataclasses.replace(cfg, d_model=2048, moe=moe)


def _layer(cfg, device, seed=0):
    """(ffn params without the routed experts, tier state) of one MoE
    layer, its experts split hot / warm / cold as a quarter, ~30% and the
    rest."""
    gen = make_generator(seed, device)
    e = cfg.moe.n_experts
    n_hot, n_warm = max(1, e // 4), max(1, round(0.3 * e))
    p = {k: v for k, v in init_moe(gen, cfg).items() if k in ("router", "shared")}
    return p, init_tiered_state(gen, cfg, TierSizes(n_hot, n_warm, e - n_hot - n_warm))


def _x(cfg, b, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    return torch.randn((b, 1, cfg.d_model), generator=g, device=device).to(dt)


def _dead(b, device):
    """Every third row dead (row 0 of a width-1 call stays live)."""
    return (torch.arange(b, device=device) % 3 != 2)[:, None]


@pytest.fixture
def tracer():
    before = obs_trace._INSTALLED
    tr = obs_trace.Tracer(enabled=True)
    obs_trace.install_tracer(tr)
    yield tr
    obs_trace.install_tracer(before)


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_call_is_eager_on_the_cpu(tracer, arch):
    cfg = _cfg(arch)
    p, st = _layer(cfg, "cpu")
    n = len(DECODE_GRAPHS)
    tiered_moe_forward(p, st, cfg, _x(cfg, 4, "cpu", 1), token_mask=_dead(4, "cpu"), layer=3)
    assert len(DECODE_GRAPHS) == n
    spans = [e for e in tracer.events if e.get("ph") == "X"]
    (moe,) = [e for e in spans if e["name"] == "moe"]
    e = cfg.moe.n_experts
    assert moe["args"] == {"layer": 3, "tokens": 4, "graph": "eager",
                           "held": f"0-{e - 1}/{e}", "router": "softmax"}
    names = [e["name"] for e in spans]
    assert names.count("moe.route") == 1 and names.count("moe.tier") == 3
    assert names.count("moe.combine") == 1


CHANGES = {
    # what changes between two calls -> whether the graph key changes
    "x values": False,
    "mask values": False,
    "migration in place": False,
    "width": True,
    "mask given": True,
    "mask dropped": True,
    "rebound tier buffer": True,
    "rebound routing table": True,
    "rebound router": True,
    "cold capacity": True,
    "dtype": True,
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_graph_key_follows_what_the_graph_reads(change):
    cfg = _cfg("deepseek-v2-236b")
    p, st = _layer(cfg, "cpu")
    x, mask, frac = _x(cfg, 4, "cpu", 1), _dead(4, "cpu"), 0.25
    before = graph_key(p, st, cfg, x, frac, mask, None)
    if change == "x values":
        x = _x(cfg, 4, "cpu", 2)
    elif change == "mask values":
        mask = ~mask
    elif change == "migration in place":
        apply_migrations(st, np.array([[0, 0, 0, 2, 1]], np.int32))
    elif change == "width":
        x, mask = _x(cfg, 8, "cpu", 1), _dead(8, "cpu")
    elif change == "mask given":
        before = graph_key(p, st, cfg, x, frac, None, None)
    elif change == "mask dropped":
        mask = None
    elif change == "rebound tier buffer":
        st = dict(st, warm=st["warm"].clone())
    elif change == "rebound routing table":
        st = dict(st, expert_slot=st["expert_slot"].clone())
    elif change == "rebound router":
        p = dict(p, router=p["router"].clone())
    elif change == "cold capacity":
        frac = 1.0
    elif change == "dtype":
        x = x.double()
    after = graph_key(p, st, cfg, x, frac, mask, None)
    assert (after != before) == CHANGES[change]
    assert after == graph_key(p, st, cfg, x, frac, mask, None)  # a pure function


def _plain_moe(p, st, cfg, x, mask):
    """Dropless tiered MoE token by token: each live token's top-k
    experts read from the buffer its routing tables name, weighted and
    summed in fp32, plus the shared experts."""
    mo = cfg.moe
    flat = x.reshape(-1, x.shape[-1]).double()
    probs = torch.softmax(flat @ p["router"].double(), -1)
    w, idx = torch.topk(probs, mo.top_k, -1)
    w = w / w.sum(-1, keepdim=True)
    bufs = [st["hot"], st["warm"], st["cold"]]

    def ffn(wts, h):  # wts [3, D, F]: gate, up, transposed down
        g, u, d = (t.double() for t in wts)
        return (torch.nn.functional.silu(h @ g) * (h @ u)) @ d.T

    y = torch.zeros_like(flat)
    counts = torch.zeros(mo.n_experts, dtype=torch.int32)
    for i in range(flat.shape[0]):
        if mask is not None and not bool(mask.reshape(-1)[i]):
            continue
        for j in range(mo.top_k):
            e = int(idx[i, j])
            counts[e] += 1
            wts = bufs[int(st["expert_tier"][e])][int(st["expert_slot"][e])]
            y[i] += w[i, j] * ffn(wts, flat[i])
    if mo.n_shared:
        sh = p["shared"]
        for s in range(mo.n_shared):
            a = torch.nn.functional.silu(flat @ sh["w_gate"][s].double())
            y += (a * (flat @ sh["w_up"][s].double())) @ sh["w_down"][s].double()
    return y.reshape(x.shape), counts


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("width", [1, 5])
def test_eager_decode_body_matches_a_plain_loop(width, masked):
    cfg = _cfg("deepseek-v2-236b")
    p, st = _layer(cfg, "cpu")
    x = _x(cfg, width, "cpu", 7)
    mask = _dead(width, "cpu") if masked else None
    y, counts = tiered_moe_forward(p, st, cfg, x, cold_capacity_frac=1.0, token_mask=mask)
    want_y, want_counts = _plain_moe(p, st, cfg, x, mask)
    # fp32 sums of ~100 products: within 1e-6 of the output's scale (the
    # tier buffers' initial draw is scaled by their slot count, not D)
    torch.testing.assert_close(y.double(), want_y, rtol=1e-5,
                               atol=1e-6 * float(want_y.abs().max()))
    assert torch.equal(counts, want_counts)


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100): the decode graphs capture and replay there")
    torch.backends.cuda.matmul.allow_tf32 = False
    DECODE_GRAPHS.clear()
    yield torch.device("cuda")
    DECODE_GRAPHS.clear()


def _eager(p, st, cfg, x, mask, frac=0.25):
    return tm._tiered_moe(p, st, cfg, x, frac, mask, None, None)


def _same(got, want, what):
    assert torch.equal(got[0], want[0]), f"{what}: y differs"
    assert torch.equal(got[1], want[1]), f"{what}: counts differ"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS + ("deepseek-v2-lite-widths",))
def test_replay_equals_eager_bitwise(cuda_device, arch, dtype):
    cfg = _lite(dtype) if arch == "deepseek-v2-lite-widths" else _cfg(arch, dtype)
    p, st = _layer(cfg, cuda_device)
    widths = (32,) if arch == "deepseek-v2-lite-widths" else WIDTHS
    for b in widths:
        for masked in (False, True):
            n = len(DECODE_GRAPHS)
            for seed in range(3):  # capture, then two replays
                x = _x(cfg, b, cuda_device, 100 * b + seed)
                mask = _dead(b, cuda_device) if masked else None
                got = tiered_moe_forward(p, st, cfg, x, token_mask=mask)
                _same(got, _eager(p, st, cfg, x, mask), f"width {b} masked {masked} call {seed}")
            assert len(DECODE_GRAPHS) == n + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_replay_follows_migrations(cuda_device, arch):
    """Experts 0, 1 start hot, 2, 3 warm, 4-7 cold (slots in order); each
    plan swaps experts between tiers, and the warm buffer is then written
    in place, which changes what the rows get."""
    cfg = _cfg(arch, "bfloat16")
    p, st = _layer(cfg, cuda_device)
    plans = [np.array([[0, 0, 0, 2, 1], [2, 1, 0, 2, 0]], np.int32),
             np.array([[5, 0, 0, 1, 1], [1, 0, 1, 2, 2]], np.int32)]
    mask = _dead(16, cuda_device)
    tiered_moe_forward(p, st, cfg, _x(cfg, 16, cuda_device, 1), token_mask=mask)  # capture
    for i, plan in enumerate(plans):
        x = _x(cfg, 16, cuda_device, 2 + i)
        before = _eager(p, st, cfg, x, mask)
        apply_migrations(st, plan)
        st["warm"].mul_(1.5)
        want = _eager(p, st, cfg, x, mask)
        assert not torch.equal(before[0], want[0])
        _same(tiered_moe_forward(p, st, cfg, x, token_mask=mask), want, f"after plan {i}")
    assert len(DECODE_GRAPHS) == 1


def test_returned_counts_outlive_later_replays(cuda_device):
    cfg = _cfg("deepseek-v2-236b", "bfloat16")
    p, st = _layer(cfg, cuda_device)
    calls = [tiered_moe_forward(p, st, cfg, _x(cfg, 32, cuda_device, s)) for s in range(3)]
    kept = [(y.clone(), c.clone()) for y, c in calls]
    calls.append(tiered_moe_forward(p, st, cfg, _x(cfg, 32, cuda_device, 9)))
    assert len(DECODE_GRAPHS) == 1
    assert not torch.equal(calls[1][1], calls[2][1])  # other routing
    for (y, c), (y0, c0) in zip(calls, kept):
        assert torch.equal(y, y0) and torch.equal(c, c0)


def test_replay_makes_no_host_sync_and_counts_its_launches(cuda_device, tracer):
    cfg = _cfg("deepseek-v2-236b", "bfloat16")
    p, st = _layer(cfg, cuda_device)
    mask = _dead(8, cuda_device)
    n0 = expert_ffn_gemv.launches
    tiered_moe_forward(p, st, cfg, _x(cfg, 8, cuda_device, 1), token_mask=mask)  # capture
    assert expert_ffn_gemv.launches - n0 == 3  # the warm-up's: one call a tier
    x = _x(cfg, 8, cuda_device, 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tiered_moe_forward(p, st, cfg, x, token_mask=mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert expert_ffn_gemv.launches - n0 == 6
    spans = [e for e in tracer.events if e.get("ph") == "X"]
    assert [e["args"]["graph"] for e in spans if e["name"] == "moe"] == ["capture", "replay"]
    assert [e["name"] for e in spans] == ["moe", "moe"]  # nothing inside either
