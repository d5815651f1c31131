"""The paper's analytic model in the PyTorch port (`repro_torch.core`:
scheduler, relayout, simulator) against the JAX package's `repro.core`,
on the inputs of the reference's own tests (`test_scheduler.py`,
`test_predictor_relayout.py`, `test_simulator.py`).

The port's modules are copies: the same numpy operations in the same
order. So every returned field is held equal, bitwise, not close. The
reference's behavioural claims (TriMoE beats every baseline, ablation
components never hurt) are run against the port as well. Every time the
simulator returns is modelled for the paper's Table-1 system, not
measured.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.configs as tcfgs
import repro_torch.core as tcore
from repro.configs import get_config
from repro.core import relayout as jrelayout
from repro_torch.core import relayout as trelayout

SHAPE = (5120, 1536)  # deepseek-v2 expert
POLICIES = ("klotski", "enkt", "monde", "gpu_ndp", "trimoe")
# examples/simulate_paper.py's ablation chain (paper Fig. 8)
ABLATIONS = {"cpu": dict(enable_refinement=False, enable_relayout=False),
             "refinement": dict(enable_refinement=True, enable_relayout=False),
             "relayout": dict(enable_refinement=True, enable_relayout=True)}
SIM_ARCH = "granite-moe-1b-a400m"  # tests/test_simulator.py's config


def _equal(a, b, path="result"):
    """Bitwise equality of two results of the same structure, field by
    field (dataclasses, lists, dicts, numpy arrays, floats)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), path
        assert a == b or (a != a and b != b), f"{path}: {a!r} != {b!r}"


def _mixed_workload(pkg, e=64, seed=0):
    """tests/test_scheduler.py's fixture, built from either package."""
    rng = np.random.default_rng(seed)
    loads = np.concatenate([
        rng.integers(250, 500, 2),
        rng.integers(20, 150, 18),
        rng.integers(0, 6, e - 20),
    ]).astype(np.float64)
    placements = []
    for i in range(e):
        if i < 2:
            placements.append(pkg.ExpertPlacement(pkg.STRIPED, -1, gpu_cached=True))
        elif i < 20:
            placements.append(pkg.ExpertPlacement(pkg.STRIPED, -1))
        else:
            placements.append(pkg.ExpertPlacement(pkg.LOCALIZED, i % 16))
    return loads, placements


@pytest.mark.parametrize("greedy_mode", ["cost", "makespan"])
@pytest.mark.parametrize("max_iters", [0, 64])
@pytest.mark.parametrize("seed", [0, 3, 5])
def test_schedule_equal(seed, max_iters, greedy_mode):
    out = []
    for pkg in (jcore, tcore):
        s = pkg.MakespanScheduler(pkg.CostModel(), pkg.ExpertShape(*SHAPE),
                                  max_iters=max_iters, greedy_mode=greedy_mode)
        loads, pls = _mixed_workload(pkg, seed=seed)
        sc = s.schedule(loads, pls)
        gpu_base = 1e-4
        out.append((sc, s.makespan(sc.assign, loads, pls),
                    s.makespan(sc.assign, loads, pls, gpu_base=gpu_base),
                    s.schedule(loads, pls, gpu_base_time=gpu_base),
                    [[s.device_cost(d, loads[i], pls[i]) for d in (pkg.GPU, pkg.CPU, pkg.NDP)]
                     for i in range(len(loads))],
                    [s._contention(d, pls[i]) for d in (pkg.GPU, pkg.CPU, pkg.NDP)
                     for i in (0, 2, 20)]))
    _equal(*out)


def test_schedule_without_cpu_equal():
    out = []
    for pkg in (jcore, tcore):
        s = pkg.MakespanScheduler(pkg.CostModel(), pkg.ExpertShape(*SHAPE), allow_cpu=False)
        loads, pls = _mixed_workload(pkg, seed=3)
        out.append(s.schedule(loads, pls))
    _equal(*out)
    assert not (out[1].assign == tcore.CPU).any()


def _relayout_cases(pkg):
    """tests/test_predictor_relayout.py's three fixtures."""
    pl = pkg.ExpertPlacement
    s, l = pkg.STRIPED, pkg.LOCALIZED
    return {
        "mixed": (np.array([400.0, 50, 50, 2, 2, 2, 2, 2]),
                  [pl(s, -1), pl(l, 0), pl(s, -1), pl(s, -1), pl(l, 1), pl(l, 1),
                   pl(l, 1), pl(l, 2)]),
        "cold_striped": (np.full(16, 2.0), [pl(s, -1) for _ in range(16)]),
        "skewed_dimm": (np.full(12, 4.0),
                        [pl(l, 0) for _ in range(8)] + [pl(l, d) for d in (1, 2, 3, 4)]),
    }


@pytest.mark.parametrize("window_links", [0.0, 1.5, 100.0])
@pytest.mark.parametrize("case", ["mixed", "cold_striped", "skewed_dimm"])
def test_relayout_plan_execute_equal(case, window_links):
    out = []
    for pkg, mod in ((jcore, jrelayout), (tcore, trelayout)):
        eng = pkg.RelayoutEngine(pkg.CostModel(), pkg.ExpertShape(*SHAPE), hbm_expert_slots=2)
        pred, pls = _relayout_cases(pkg)[case]
        tasks = eng.plan(pred, pls)
        planned = [dataclasses.replace(t) for t in tasks]
        rep = eng.execute(tasks, pls, eng.cm.t_dimm_link(eng.shape.weight_bytes) * window_links)
        out.append((planned, rep, pls, (mod.PREFETCH, mod.RELAYOUT, mod.REBALANCE)))
    _equal(*out)
    assert out[1][0], "every fixture plans at least one task"


@pytest.fixture(scope="module")
def sim_trace():
    j = jcore.trace_for_model(get_config(SIM_ARCH), 256, n_steps=12, seed=0)
    t = tcore.trace_for_model(tcfgs.get_config(SIM_ARCH), 256, n_steps=12, seed=0)
    np.testing.assert_array_equal(j, t)
    return t


def _sim(pkg, cfg, trace, policy, **kw):
    model = pkg.SimModel.from_config(cfg)
    flags = pkg.SimFlags(policy=policy, warmup_steps=4, **kw)
    return model, pkg.TriMoESimulator(model, trace, flags).run(8)


@pytest.fixture(scope="module")
def sim_runs(sim_trace):
    """Every policy and the three ablation flag sets, through both packages."""
    cases = {p: (p, {}) for p in POLICIES}
    cases.update({f"ablation_{k}": ("trimoe", kw) for k, kw in ABLATIONS.items()})
    runs = {}
    for name, (policy, kw) in cases.items():
        runs[name] = tuple(
            _sim(pkg, cfg, sim_trace.copy(), policy, **kw)
            for pkg, cfg in ((jcore, get_config(SIM_ARCH)), (tcore, tcfgs.get_config(SIM_ARCH))))
    return runs


@pytest.mark.parametrize("case", list(POLICIES) + [f"ablation_{k}" for k in ABLATIONS])
def test_simulator_equal(sim_runs, case):
    (jmodel, jres), (tmodel, tres) = sim_runs[case]
    _equal(jmodel, tmodel, "model")
    _equal(jres, tres)
    assert jres.throughput == tres.throughput
    assert jres.moe_latency_per_layer_ms == tres.moe_latency_per_layer_ms


@pytest.mark.parametrize("arch,batch,policy", [
    ("deepseek-v2-236b", 512, "trimoe"),   # examples/simulate_paper.py's cell
    ("deepseek-v2-236b", 64, "klotski"),
    ("jamba-v0.1-52b", 128, "enkt"),       # MoE every other layer
])
def test_simulate_entry_equal(arch, batch, policy):
    flags = dict(warmup_steps=2, n_dimms=8, cpu_flops_scale=0.5)
    j = jcore.simulate(get_config(arch), batch, policy=policy, n_steps=3, **flags)
    t = tcore.simulate(tcfgs.get_config(arch), batch, policy=policy, n_steps=3, **flags)
    _equal(j, t)


# The reference's behavioural claims (tests/test_simulator.py), on the port.
@pytest.mark.parametrize("baseline", ["klotski", "enkt", "monde"])
def test_port_trimoe_beats_baseline(sim_runs, baseline):
    assert sim_runs["trimoe"][1][1].moe_time < sim_runs[baseline][1][1].moe_time


@pytest.mark.parametrize("step,before,slack", [
    ("ablation_cpu", "gpu_ndp", 1.0),          # +CPU is the big win (Fig. 8)
    ("ablation_refinement", "ablation_cpu", 1.05),
    ("ablation_relayout", "ablation_refinement", 1.10),
])
def test_port_ablation_never_hurts(sim_runs, step, before, slack):
    after, prior = sim_runs[step][1][1].moe_time, sim_runs[before][1][1].moe_time
    assert after < prior if slack == 1.0 else after <= prior * slack


def test_port_migration_and_predictor_in_paper_band(sim_runs):
    r = sim_runs["trimoe"][1][1]
    assert r.migration_overhead / r.step_time < 0.033  # paper §5.5: <3.3%
    assert r.migration_accuracy >= 0.70
    assert all(0 < r.utils[k] <= 1.0 for k in ("gpu", "cpu", "ndp"))
