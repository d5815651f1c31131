"""The program's spans as the benchmark reads them: the profiler ranges the
program opens leave the accepted reduction (`devtrace.reduce_events`) as
it was, the new reduction attributes idle time and launched work to the
innermost `trimoe.` range, and a traced tiny run on the CPU reports the
program-span metrics (the device-trace ones need a card)."""
import time
from types import SimpleNamespace

import pytest

import tiny
from devtrace import reduce_events
from harness import run_cell
from program_trace import reduce_program_ranges


class _Ev(SimpleNamespace):
    """The fields of a torch.profiler FunctionEvent the reductions read."""


def ev(name, t0, t1, device=False, eid=0, user=False):
    return _Ev(name=name, time_range=SimpleNamespace(start=t0, end=t1), id=eid,
               device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
               is_user_annotation=user)


def slice_events():
    """A 1000 us slice: the benchmark's decode range (and its device-side
    mirror), three kernels and a copy, each launched by a runtime call
    sharing its correlation id."""
    return [
        ev("bench.slice", 0, 1000, user=True),
        ev("bench.decode", 50, 950, user=True),
        ev("bench.decode", 150, 780, device=True, user=True),
        ev("cudaLaunchKernel", 120, 125, eid=11),
        ev("gateup_kernel", 150, 250, device=True, eid=11),
        ev("cudaLaunchKernel", 310, 315, eid=12),
        ev("down_kernel", 350, 450, device=True, eid=12),
        ev("cudaMemcpyAsync", 710, 712, eid=13),
        ev("Memcpy DtoD (Device -> Device)", 720, 760, device=True, eid=13),
        ev("Memset (Device)", 770, 780, device=True, eid=99),  # no launch seen
    ]


def program_ranges():
    """The program's ranges over it: decode > moe > moe.tier > the GEMV's
    kernel span, then migrate; host-side records only."""
    return [
        ev("trimoe.decode", 100, 900),
        ev("trimoe.moe", 200, 600),
        ev("trimoe.moe.tier", 300, 500),
        ev("trimoe.kernel.cold_expert_ffn", 305, 320),
        ev("trimoe.migrate", 700, 800),
    ]


def test_reduce_events_unmoved_by_the_program_ranges():
    base = slice_events()
    assert reduce_events(base) == reduce_events(base + program_ranges())
    assert reduce_events(base)["busy_s"] == pytest.approx(250e-6)


def test_idle_and_launches_go_to_the_innermost_range():
    r = reduce_program_ranges(slice_events() + program_ranges())
    assert r["window_s"] == pytest.approx(1e-3) and r["decode_steps"] == 1
    # busy 150-250, 350-450, 720-760, 770-780; idle cut by the ranges:
    # 0-100 outside, 100-150 decode, 250-300 moe, 300-305 moe.tier,
    # 305-320 the kernel span, 320-350 moe.tier, 450-500 moe.tier,
    # 500-600 moe, 600-700 decode, 700-720 and 760-770 and 780-800
    # migrate, 800-900 decode, 900-1000 outside
    us = {k: v * 1e6 for k, v in r["idle_s"].items()}
    assert us == pytest.approx({"outside": 200, "decode": 250, "moe": 150, "moe.tier": 85,
                                "kernel.cold_expert_ffn": 15, "migrate": 50})
    assert r["idle_in_moe_s"] * 1e6 == pytest.approx(250)
    assert r["idle_path_s"]["decode/moe/moe.tier/kernel.cold_expert_ffn"] * 1e6 == (
        pytest.approx(15))
    dev = {k: v * 1e6 for k, v in r["device_s"].items()}
    assert dev == pytest.approx({"decode": 100, "kernel.cold_expert_ffn": 100, "migrate": 40,
                                 "unattributed": 10})
    assert r["migrate_device_s"] * 1e6 == pytest.approx(40)


def test_no_program_ranges_no_reduction():
    assert reduce_program_ranges(slice_events()) == {}
    assert reduce_program_ranges(program_ranges()) == {}


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"))


def test_traced_run_reports_the_program_spans(bench_dir):
    out = run_cell(bench_dir, "tiny-deepseek.chat", 2**31 + 13, 5.0, True, time.time(),
                   device="cpu")
    got = out["metrics"]
    for name in ("moe_host_ms_p50", "mixer_host_ms_p50", "host_wait_ms_p50"):
        assert name in got and got[name]["value"] > 0, name
    # no card, no device activity: the device-trace readings are absent
    assert not {"idle_in_moe_pct", "migrate_device_ms_per_step"} & set(got)
