"""`moe_graph_pct`: the share of the window's decode MoE calls that
replayed a CUDA graph, read from the program's `moe` spans; nothing where
the spans carry no `graph` arg (a program without decode graphs)."""
import time
from types import SimpleNamespace

import pytest

import tiny
from harness import run_cell
from spec import module_at

READ = module_at(tiny.BENCH / "metrics" / "moe_graph_pct.py").read


def span(name, ts, dur, tid=1, **args):
    ev = {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur), "pid": 1, "tid": tid}
    if args:
        ev["args"] = args
    return ev


def events(graph=True):
    """A 10 s window ending with the last step at 20 s: two decode steps of
    three MoE calls each, a prefill MoE call, a profiled decode step and
    one step before the window."""
    g = (lambda mode: {"graph": mode}) if graph else (lambda mode: {})
    us = 1e6
    return [
        span("step", 5 * us, 1 * us),
        span("decode", 5.1 * us, 0.5 * us),
        span("moe", 5.2 * us, 0.01 * us, layer=1, **g("eager")),  # before the window
        span("step", 12 * us, 1 * us),
        span("decode", 12.1 * us, 0.5 * us),
        span("moe", 12.2 * us, 0.01 * us, layer=1, **g("capture")),
        span("moe", 12.3 * us, 0.01 * us, layer=2, **g("replay")),
        span("moe", 12.4 * us, 0.01 * us, layer=2, tid=2, **g("eager")),  # another thread
        span("moe", 12.5 * us, 0.01 * us, layer=3, **g("replay")),
        span("prefill", 12.7 * us, 0.2 * us),
        span("moe", 12.8 * us, 0.01 * us, layer=1, **g("eager")),  # a prefill call
        span("step", 15 * us, 1 * us, profiled=True),
        span("decode", 15.1 * us, 0.5 * us, profiled=True),
        span("moe", 15.2 * us, 0.01 * us, layer=1, profiled=True, **g("eager")),
        span("step", 19 * us, 1 * us),
        span("decode", 19.1 * us, 0.5 * us),
        span("moe", 19.2 * us, 0.01 * us, layer=1, **g("replay")),
        span("moe", 19.3 * us, 0.01 * us, layer=2, **g("replay")),
        span("moe", 19.4 * us, 0.01 * us, layer=3, **g("replay")),
    ]


@pytest.fixture
def program(monkeypatch):
    import program_trace  # on the path once tiny is imported

    def install(evs):
        monkeypatch.setattr(program_trace, "program_events", lambda: evs)
    return install


REC = SimpleNamespace(window_s=10.0)


def test_counts_the_window_decode_calls_that_replayed(program):
    program(events())
    # in the window's two unprofiled decode steps, same thread: capture,
    # replay, replay, then three replays
    assert READ(REC) == pytest.approx(100.0 * 5 / 6)


def test_no_graph_arg_no_reading(program):
    program(events(graph=False))
    assert READ(REC) is None
    program(None)
    assert READ(REC) is None


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"), configs=(tiny.DEEPSEEK,))


def test_traced_cpu_run_reads_no_replay(bench_dir):
    """On the CPU every decode MoE call runs eagerly: the share is 0."""
    out = run_cell(bench_dir, "tiny-deepseek.chat", 2**31 + 29, 3.0, True, time.time(),
                   device="cpu")
    assert out["metrics"]["moe_graph_pct"]["value"] == 0.0
