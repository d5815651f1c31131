"""Trace replay of the PyTorch port against the JAX package: the port's
copy of `core/traces.py` generates the same arrays from the same seeds
and reads and writes the same files, and `replay_requests` drives the
port's `ServingLoop` through a skewed, phase-shifting, bursty trace to
the JAX replay's tokens and iteration count (fp32, bridged params and
tier state), with dynamic and with frozen scheduling.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.core.traces as jtr
import repro_torch.configs as tcfgs
import repro_torch.core.traces as ttr
from repro.configs import get_config, reduce_for_smoke
from repro.core.policy import SchedulerPolicy as JaxPolicy
from repro.core.tiers import TierThresholds as JaxThresholds
from repro.models.model import init_params as jax_init_params
from repro.serving.loop import ServingLoop as JaxServingLoop
from repro.serving.replay import replay_requests as jax_replay_requests
from repro_torch.bridge import to_torch
from repro_torch.core.policy import SchedulerPolicy
from repro_torch.core.tiers import TierThresholds
from repro_torch.serving.loop import ServingLoop
from repro_torch.serving.replay import replay_requests, requests_from_trace
from repro_torch.serving.tiered_moe import TierSizes

ARCH = "granite-moe-1b-a400m"
N_REQ = 6
NEW_TOKENS = 4
TRACE_KW = dict(prompt_len=6, prompt_len_jitter=2, new_tokens=NEW_TOKENS, n_phases=2,
                burst=2, gap_steps=3, seed=11)
REQ_FIELDS = ("arrival_step", "prompt_lens", "prompt_tokens", "new_tokens")


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("kw", [
    dict(n_requests=6, vocab_size=512, **TRACE_KW),
    dict(n_requests=17, vocab_size=64, prompt_len=9, prompt_len_jitter=4, new_tokens=3,
         zipf_a=1.5, n_phases=3, burst=4, gap_steps=1, seed=3),
])
def test_synth_request_trace_matches_jax(kw):
    j, t = jtr.synth_request_trace(**kw), ttr.synth_request_trace(**kw)
    for name in REQ_FIELDS:
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.meta == j.meta
    for i in range(len(j)):
        np.testing.assert_array_equal(t.prompt(i), j.prompt(i))


@pytest.mark.parametrize("phase_steps", [(), (5,)])
def test_generate_trace_matches_jax(phase_steps):
    kw = dict(n_steps=12, n_layers=2, n_experts=32, top_k=4, tokens_per_step=16,
              phase_steps=phase_steps, seed=4)
    np.testing.assert_array_equal(ttr.generate_trace(ttr.TraceSpec(**kw)),
                                  jtr.generate_trace(jtr.TraceSpec(**kw)))
    np.testing.assert_array_equal(ttr.fig3_base_distribution(ttr.TraceSpec(**kw)),
                                  jtr.fig3_base_distribution(jtr.TraceSpec(**kw)))


@pytest.mark.parametrize("writer,reader", [(jtr, ttr), (ttr, jtr)])
def test_each_package_loads_the_others_files(tmp_path, writer, reader):
    req = writer.synth_request_trace(5, 64, prompt_len=6, prompt_len_jitter=2, new_tokens=3,
                                     n_phases=2, seed=9)
    spec = writer.TraceSpec(n_steps=6, n_layers=2, n_experts=16, top_k=2, tokens_per_step=8,
                            phase_steps=(3,), seed=2)
    rt = writer.RoutingTrace.from_spec(spec)
    req.save(tmp_path / ("req" + writer.TRACE_SUFFIX))
    rt.save(tmp_path / ("rt" + writer.TRACE_SUFFIX))
    back = reader.load_trace(tmp_path / ("req" + reader.TRACE_SUFFIX))
    assert isinstance(back, reader.RequestTrace) and back.meta == req.meta
    for name in REQ_FIELDS:
        np.testing.assert_array_equal(getattr(back, name), getattr(req, name))
    back = reader.load_trace(tmp_path / ("rt" + reader.TRACE_SUFFIX))
    assert isinstance(back, reader.RoutingTrace) and back.meta == rt.meta
    np.testing.assert_array_equal(back.loads, rt.loads)
    with pytest.raises(ValueError, match="expected a 'requests' trace"):
        reader.RequestTrace.load(tmp_path / ("rt" + reader.TRACE_SUFFIX))


_SETUP = {}


def _setup():
    if not _SETUP:
        jcfg = _f32(reduce_for_smoke(get_config(ARCH)))
        tcfg = _f32(tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH)))
        params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
        trace = ttr.synth_request_trace(N_REQ, tcfg.vocab_size, **TRACE_KW)
        _SETUP.update(jcfg=jcfg, tcfg=tcfg, params=params, trace=trace)
    return _SETUP


def _loops(freeze):
    """A JAX loop and a port loop, same params and tier state, under the
    reference's skew test's policy: thresholds low enough that smoke
    decode loads cross tier boundaries, at least one move a replan
    (dynamic) or no moves (frozen)."""
    st = _setup()
    cache_len = int(st["trace"].prompt_lens.max()) + NEW_TOKENS + 2
    kw = dict(batch_size=4, n_groups=2, cache_len=cache_len)
    jpol = JaxPolicy(thresholds=JaxThresholds(tau_hot=6, tau_cold=1), plan_min=int(not freeze),
                     freeze=freeze)
    tpol = SchedulerPolicy(thresholds=TierThresholds(tau_hot=6, tau_cold=1),
                           plan_min=int(not freeze), freeze=freeze)
    jl = JaxServingLoop(st["jcfg"], st["params"], scheduler=jpol, **kw)
    tl = ServingLoop(st["tcfg"], to_torch(st["params"]),
                     to_torch(jax.tree.map(np.asarray, jl.engine.tiered)),
                     sizes=TierSizes(*jl.engine.sizes), scheduler=tpol, device="cpu", **kw)
    return jl, tl


@pytest.mark.parametrize("freeze", [False, True])
def test_replay_matches_jax(freeze):
    """Same trace, same tokens and iteration count as the JAX replay,
    under dynamic (migrating) and frozen scheduling; arrivals honored,
    the trace drained, wall time accumulated."""
    jl, tl = _loops(freeze)
    trace = _setup()["trace"]
    jres = jax_replay_requests(jl, jtr.RequestTrace(
        **{name: getattr(trace, name) for name in REQ_FIELDS}, meta=trace.meta))
    tres = replay_requests(tl, trace)
    assert tres.tokens() == jres.tokens()
    assert tres.iterations == jres.iterations >= int(trace.arrival_step.max())
    assert sorted(r.rid for r in tres.completions) == list(range(N_REQ))
    assert all(len(r.generated) == NEW_TOKENS for r in tres.completions)
    assert tl.stats.admitted == N_REQ and tl.stats.wall_s > 0
    assert tl.stats.replans == jl.stats.replans > 0
    assert tl.engine.stats.migrations == jl.engine.stats.migrations
    assert (tl.engine.stats.migrations == 0) == freeze
    assert tl.stats.migrations == tl.engine.stats.migrations


def test_replay_dynamic_and_frozen_tokens_agree():
    """The reference's skew invariant in the port alone: where an expert
    lives never changes what it computes."""
    trace = _setup()["trace"]
    dyn, fro = _loops(False)[1], _loops(True)[1]
    assert replay_requests(dyn, trace).tokens() == replay_requests(fro, trace).tokens()
    assert dyn.engine.stats.migrations > 0
    assert fro.engine.stats.migrations == 0


def test_requests_from_trace_materializes_prompts():
    trace = _setup()["trace"]
    reqs = requests_from_trace(trace, rid_base=10)
    assert len(reqs) == N_REQ
    for i, r in enumerate(reqs):
        assert r.rid == 10 + i and r.prompt.dtype == np.int32
        np.testing.assert_array_equal(r.prompt, trace.prompt(i))
        assert r.max_new_tokens == int(trace.new_tokens[i])


def test_replay_raises_instead_of_spinning():
    _, tl = _loops(False)
    with pytest.raises(RuntimeError, match="did not drain"):
        replay_requests(tl, _setup()["trace"], max_iterations=1)
