"""The port's observability layer (`repro_torch.obs`) on its serving loop
on the CPU: the counterparts of tests/test_obs.py's 12 tests (percentile
edge cases, get-or-create typing, the accumulate-vs-reset contract, the
shared registry, the tracer's disabled fast path, the trace_event round
trip with span nesting, kernel spans, the `resolve_obs` precedence
rule), then parity with the JAX package: the same fp32 granite smoke
serve traced in both gives the same span, instant and counter-track
names, `kernel.<op>` spans under the reference's op-layer names, and
snapshots with equal keys and equal non-timing values.

The reference's kernel spans fire when its jitted ops trace, so a shape
already compiled in the same process emits none: its `kernel.*` names
are held to be a subset of the port's, which fire on every call.
"""
import dataclasses
import json
import warnings

import jax
import numpy as np
import pytest

import repro_torch.configs as tcfgs
from repro.configs import get_config, reduce_for_smoke
from repro.core.policy import SchedulerPolicy as JaxSchedulerPolicy
from repro.core.tiers import TierThresholds as JaxTierThresholds
from repro.models.model import init_params as jax_init_params
from repro.obs import ObsConfig as JaxObsConfig
from repro.serving.batching import Request as JaxRequest
from repro.serving.loop import ServingLoop as JaxServingLoop
from repro_torch.bridge import to_torch
from repro_torch.core.policy import SchedulerPolicy
from repro_torch.core.tiers import TierThresholds
from repro_torch.kernels.backend import set_kernel_tracer
from repro_torch.models.model import init_params
from repro_torch.obs import (
    NULL_SPAN,
    MetricsRegistry,
    ObsConfig,
    Observability,
    Tracer,
    pct,
    resolve_obs,
)
from repro_torch.obs.trace import load_trace, validate_trace_events
from repro_torch.serving.batching import Request
from repro_torch.serving.loop import LoopStats, ServingLoop
from repro_torch.serving.tiered_moe import TierSizes

ARCH = "granite-moe-1b-a400m"
# the ops the port's default serving path calls on a GQA MoE model:
# paged attention (chunk and decode), the grouped GEMM on prefill
# chunks, the expert GEMV on decode steps
SERVE_OPS = {"kernel.paged_prefill_gqa", "kernel.paged_decode_gqa",
             "kernel.grouped_expert_ffn", "kernel.cold_expert_ffn"}


@pytest.fixture(scope="module")
def setup():
    cfg = tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH))
    return cfg, init_params(0, cfg, device="cpu")


@pytest.fixture(autouse=True)
def _no_tracer_leak():
    yield
    set_kernel_tracer(None)  # a traced stack installs the process-global tracer


def _loop(setup, **kw):
    cfg, params = setup
    return ServingLoop(cfg, params, batch_size=kw.pop("batch_size", 2),
                       n_groups=kw.pop("n_groups", 1), cache_len=16, device="cpu", **kw)


def _requests(cfg, n=4, new_tokens=3, seed=7):
    rng = np.random.default_rng(seed)
    return [Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, 4 + rid % 3)
                    .astype(np.int32), max_new_tokens=new_tokens)
            for rid in range(n)]


def _serve(loop, reqs):
    for r in reqs:
        loop.submit(r)
    return loop.run(max_steps=500)


# ------------------------------------------------ percentile edge cases
def test_pct_empty_and_single_sample_no_warnings():
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any numpy warning fails the test
        assert pct([], 50) == 0.0
        assert pct([], 95) == 0.0
        assert pct([0.25], 50) == 0.25
        assert pct([0.25], 95) == 0.25
        assert pct([1.0, 3.0], 50) == 2.0


def test_stats_percentiles_defined_on_empty_and_single():
    st = LoopStats()
    assert st.ttft_p50_s == 0.0 and st.ttft_p95_s == 0.0
    assert st.itl_p50_s == 0.0 and st.plan_p95_s == 0.0
    st.ttft_s.append(0.5)
    assert st.ttft_p50_s == 0.5 and st.ttft_p95_s == 0.5


# -------------------------------------------------------- the registry
def test_registry_get_or_create_and_kind_mismatch():
    reg = MetricsRegistry()
    c = reg.counter("x.n", unit="1", desc="a counter")
    assert reg.counter("x.n") is c
    with pytest.raises(ValueError):
        reg.gauge("x.n")  # same name, different kind
    h = reg.histogram("x.lat_s", unit="s")
    h.append(0.1)
    h.append(0.3)
    c.add(2)
    snap = reg.snapshot()
    assert snap["x.n"] == 2
    assert snap["x.lat_s.count"] == 2
    assert snap["x.lat_s.p50"] == pytest.approx(0.2)
    assert "x.n" in reg and "nope" not in reg


def test_registry_prometheus_text():
    reg = MetricsRegistry()
    reg.counter("serving.admitted", unit="requests", desc="admitted").add(3)
    reg.histogram("serving.ttft_s", unit="s").append(0.5)
    text = reg.prometheus_text()
    assert "# TYPE serving_admitted_requests counter" in text
    assert "serving_admitted_requests 3" in text
    assert 'quantile="0.5"' in text


def test_facade_reset_is_scoped_registry_reset_is_global():
    reg = MetricsRegistry()
    st = LoopStats(reg)
    other = reg.counter("other.n")
    st.admitted += 2
    st.wall_s += 1.5
    st.ttft_s.append(0.1)
    other.add(5)
    st.reset()  # facade reset: only serving.* instruments
    assert st.admitted == 0 and st.wall_s == 0.0 and st.ttft_s == []
    assert reg.snapshot()["other.n"] == 5
    reg.reset()  # registry reset: everything
    assert reg.snapshot()["other.n"] == 0


# ---------------------------------------- accumulate-vs-reset contract
def test_wall_s_accumulates_across_runs_and_reset_clears(setup):
    loop = _loop(setup)
    cfg = setup[0]
    _serve(loop, _requests(cfg, n=2, seed=1))
    first, first_tokens = loop.stats.wall_s, loop.stats.generated_tokens
    assert first > 0 and first_tokens > 0
    _serve(loop, _requests(cfg, n=2, seed=2))
    assert loop.stats.wall_s > first
    assert loop.stats.generated_tokens == 2 * first_tokens
    loop.stats.reset()
    assert loop.stats.wall_s == 0.0 and loop.stats.generated_tokens == 0
    _serve(loop, _requests(cfg, n=2, seed=3))
    assert loop.stats.wall_s > 0
    assert loop.stats.generated_tokens == first_tokens


# ------------------------------------------------------------- tracing
def test_disabled_tracer_is_null_and_empty():
    tr = Tracer(enabled=False)
    s = tr.span("step", phase=1)
    assert s is NULL_SPAN  # shared singleton: no per-call allocation
    with s:
        pass
    tr.instant("x")
    tr.counter("y", {"v": 1.0})
    assert tr.events == []
    assert all(e.get("ph") == "M" for e in tr.to_trace_events())


def test_loop_with_tracing_disabled_records_no_events(setup):
    loop = _loop(setup)
    _serve(loop, _requests(setup[0], n=2))
    assert loop.obs.tracer.enabled is False
    assert loop.obs.tracer.events == []


def test_trace_export_round_trip(setup, tmp_path):
    path = str(tmp_path / "smoke.trace.json")
    loop = _loop(setup, batch_size=4, n_groups=2,
                 obs=ObsConfig(trace=True, trace_path=path))
    assert len(_serve(loop, _requests(setup[0], n=6))) == 6
    loop.obs.export_trace()
    with open(path) as f:
        doc = json.load(f)  # plain JSON
    assert isinstance(doc["traceEvents"], list)
    events = load_trace(path)
    assert validate_trace_events(events) == []  # fields + nesting
    names = {e["name"] for e in events}
    for want in ("step", "admit", "decode", "replan"):
        assert want in names, f"missing {want} span"
    spans = {n: [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("ph") == "X" and e["name"] == n] for n in ("step", "decode")}
    assert spans["decode"]
    for s0, s1 in spans["decode"]:
        assert any(t0 <= s0 and s1 <= t1 for t0, t1 in spans["step"])


def test_kernel_spans_on_shared_timeline(setup):
    """The port runs eagerly: every op call is a span, under the
    reference's op name, with the backend it resolved to (the CPU runs
    the plain versions: "ref")."""
    loop = _loop(setup, obs=ObsConfig(trace=True))
    _serve(loop, _requests(setup[0], n=2, seed=11))
    kernel = [e for e in loop.obs.tracer.events if e["name"].startswith("kernel.")]
    assert {e["name"] for e in kernel} == SERVE_OPS
    assert {e["args"]["backend"] for e in kernel} == {"ref"}
    decodes = sum(e["name"] == "decode" for e in loop.obs.tracer.events)
    gqa = sum(e["name"] == "kernel.paged_decode_gqa" for e in kernel)
    assert gqa == decodes * setup[0].n_layers  # one span per layer a decode step


# ------------------------------------------------ shared registry wiring
def test_loop_engine_predictor_share_one_registry(setup):
    loop = _loop(setup)
    assert loop.stats.registry is loop.engine.stats.registry
    assert loop.stats.registry is loop.engine.predictor.stats.registry
    _serve(loop, _requests(setup[0], n=2, seed=5))
    snap = loop.stats.snapshot()
    assert snap["serving.completed"] == 2
    assert snap["engine.steps"] > 0
    assert "predictor.accuracy" in snap


# --------------------------------------------------- resolve_obs rule
def test_resolve_obs_precedence(setup):
    cfg, _ = setup
    out = resolve_obs(cfg, None)  # defaults: metrics on, tracing off
    assert isinstance(out, Observability) and not out.tracer.enabled
    cfg_traced = dataclasses.replace(cfg, obs=ObsConfig(trace=True))
    assert resolve_obs(cfg_traced, None).tracer.enabled
    explicit = Observability(ObsConfig(trace=False))
    assert resolve_obs(cfg_traced, explicit) is explicit
    assert resolve_obs(None, explicit).registry is explicit.registry
    with pytest.raises(TypeError):
        resolve_obs(cfg, obs="yes please")


# ------------------------------------------ parity with the JAX package
def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def _is_time(key: str) -> bool:
    """A snapshot value read off a clock: a `*_s` gauge (tokens_per_s
    too) or a statistic of a `*_s` histogram other than its count."""
    return key.endswith("_s") or ("_s." in key and not key.endswith(".count"))


@pytest.fixture(scope="module")
def traced_pair():
    """One fp32 granite smoke serve, traced, in each package: bridged
    params and tier state, the exporter's forced-migration policy
    (tau_hot 6, tau_cold 1, plan_min 1), 8 requests sharing an 8-token
    prefix. The reference's MoE runs its Pallas kernels (interpreted on
    the CPU), so its expert ops are called, as the port's are."""
    jcfg = dataclasses.replace(_f32(reduce_for_smoke(get_config(ARCH))), moe_backend="pallas")
    tcfg = _f32(tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH)))
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    kw = dict(batch_size=4, n_groups=2, cache_len=34)
    jl = JaxServingLoop(jcfg, params, obs=JaxObsConfig(trace=True), scheduler=JaxSchedulerPolicy(
        thresholds=JaxTierThresholds(tau_hot=6.0, tau_cold=1.0), plan_min=1), **kw)
    tl = ServingLoop(tcfg, to_torch(jax.tree.map(np.asarray, params)),
                     to_torch(jax.tree.map(np.asarray, jl.engine.tiered)),
                     sizes=TierSizes(*jl.engine.sizes), device="cpu", obs=ObsConfig(trace=True),
                     scheduler=SchedulerPolicy(thresholds=TierThresholds(tau_hot=6.0,
                                                                         tau_cold=1.0),
                                               plan_min=1), **kw)
    rng = np.random.default_rng(13)
    system = rng.integers(0, jcfg.vocab_size, 8)
    for rid in range(8):
        prompt = np.concatenate([system, rng.integers(0, jcfg.vocab_size, 2 + (rid % 3) * 4)])
        jl.submit(JaxRequest(rid=rid, prompt=prompt.astype(np.int32), max_new_tokens=8))
        tl.submit(Request(rid=rid, prompt=prompt.astype(np.int32), max_new_tokens=8))
    want = {r.rid: r.generated for r in jl.run()}
    got = {r.rid: r.generated for r in tl.run()}
    from repro.kernels.backend import set_kernel_tracer as jax_set_kernel_tracer

    jax_set_kernel_tracer(None)
    assert got == want and len(got) == 8
    return jl, tl


def _names(loop) -> dict:
    out = {}
    for e in loop.obs.tracer.to_trace_events():
        out.setdefault(e["ph"], set()).add(e["name"])
    return out


def _arg_keys(loop, ph) -> set:
    """(name, its args' keys) of every event of phase `ph`."""
    return {(e["name"], tuple(sorted(e.get("args", {}))))
            for e in loop.obs.tracer.to_trace_events() if e["ph"] == ph}


def test_trace_families_match_reference(traced_pair):
    """Spans ("X"), instants ("i"), counter tracks ("C") and metadata
    ("M") carry the same names in both packages, the migrations'
    `tier_migration` instants and the tier counter tracks included."""
    jl, tl = traced_pair
    want, got = _names(jl), _names(tl)
    assert sorted(got) == sorted(want)
    kernel = {n for n in got["X"] if n.startswith("kernel.")}
    assert {n for n in got["X"] - kernel} == {n for n in want["X"]
                                              if not n.startswith("kernel.")}
    for ph in ("i", "C", "M"):
        assert got[ph] == want[ph], ph
    for ph in ("i", "C"):  # instants and counter tracks carry the same fields
        assert _arg_keys(tl, ph) == _arg_keys(jl, ph), ph
    assert "tier_migration" in got["i"] and tl.stats.migrations > 0
    assert {"step", "admit", "prefill_chunk", "decode", "replan", "migrate"} <= got["X"]


def test_kernel_span_names_are_the_reference_ops(traced_pair):
    jl, tl = traced_pair
    got = {n for n in _names(tl)["X"] if n.startswith("kernel.")}
    want = {n for n in _names(jl)["X"] if n.startswith("kernel.")}
    assert got == SERVE_OPS
    assert want <= got


def test_snapshots_equal_but_timing(traced_pair):
    jl, tl = traced_pair
    want, got = jl.obs.snapshot(), tl.obs.snapshot()
    assert sorted(got) == sorted(want)
    for key in ("serving.completed", "serving.decode_steps", "serving.prefill_chunks",
                "engine.steps", "engine.migrations", "predictor.accuracy"):
        assert key in got and got[key] == want[key], key
    assert {k: got[k] for k in got if not _is_time(k)} == {
        k: want[k] for k in want if not _is_time(k)}
    assert got["engine.migrations"] > 0 and got["serving.prefill_chunks"] > 0
    assert dataclasses.asdict(tl.kv.stats) == dataclasses.asdict(jl.kv.stats)
    assert tl.kv.stats.hits > 0  # the shared prefix hit the radix
