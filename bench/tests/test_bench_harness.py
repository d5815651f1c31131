"""Hygiene of the benchmark: what it imports, that its traffic and its
statistics are what they say, that BENCHMARK.json keeps its contract, and
that a new cell is found by name with no edit to the harness."""
import ast
import json
import re
import subprocess
import sys

import numpy as np
import pytest

import tiny
import spec
import system
from harness import load_cell, metrics_for, reader
from mix import gaps_of, traffic_of
from record import Record
from spec import dims_of, load_json

BENCH, ROOT = tiny.BENCH, tiny.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def imports(path):
    """Top-level names of the modules a source file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    local = {p.stem for p in BENCH.glob("*.py")}
    seen = set()
    todo = [BENCH / "reference" / "model.py", *BENCH.glob("reference/*.py"),
            *BENCH.glob("families/*.py")]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        names = imports(path)
        assert "repro_torch" not in names and not names & FORBIDDEN, path
        todo += [BENCH / f"{n}.py" for n in names & local]
    # the reference over every configuration's family, loaded by name
    code = ("import sys, json; sys.path[:0] = [%r, %r]; import reference.model, spec; "
            "[spec.dims_of(spec.load_json(%r + '/' + c['file'])) for c in "
            "json.load(open(%r + '/BENCHMARK.json'))['configs']]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (str(BENCH), str(ROOT / "src"), str(ROOT), str(ROOT)))
    mods = json.loads(subprocess.check_output([sys.executable, "-c", code]).decode()
                      .replace("'", '"'))
    assert "repro_torch" not in mods and not set(mods) & FORBIDDEN


@pytest.mark.parametrize("mix", ["chat_skew", "chat_steady", "doc_qa"])
def test_traffic_is_deterministic_by_seed(mix):
    spec = load_json(BENCH / "traffic" / f"{mix}.json")
    a, b = traffic_of(BENCH, spec, 1000, 2**31 + 7), traffic_of(BENCH, spec, 1000, 2**31 + 7)
    for k in (0, 5, 63, 64, 300):
        pa, na = a.request(k)
        pb, nb = b.request(k)
        assert na == nb and np.array_equal(pa, pb)
    gaps = lambda seed, rate: [g for _, g in zip(range(64), gaps_of(BENCH, spec, seed, rate))]  # noqa: E731
    assert gaps(2**31 + 7, 2.0) == gaps(2**31 + 7, 2.0)
    # another seed: other tokens, order and gaps; the same sizes in every
    # block, and the same gaps in every block of the arrival process
    c = traffic_of(BENCH, spec, 1000, 99)
    n = spec["block"] * spec.get("asks_per_doc", 1) * spec.get("docs_per_group", 1)
    sizes = lambda t: sorted((len(t.request(k)[0]), t.request(k)[1]) for k in range(n))  # noqa: E731
    assert sizes(a) == sizes(c)
    assert not np.array_equal(a.request(0)[0], c.request(0)[0])
    assert gaps(99, 4.0) != gaps(2**31 + 7, 4.0)
    assert sorted(gaps(99, 4.0)) == pytest.approx(sorted(gaps(2**31 + 7, 4.0)))
    assert np.mean(gaps(99, 4.0)) == pytest.approx(0.25)


def test_prompts_fit_the_cells_caches():
    bench = load_json(ROOT / "BENCHMARK.json")
    for cell in bench["workloads"]:
        spec = load_cell(BENCH, cell["name"])
        t = traffic_of(BENCH, spec["mix"], dims_of(spec["model"]).vocab, 1)
        longest = max(len(t.request(k)[0]) + t.request(k)[1] for k in range(512))
        assert longest - 1 <= spec["workload"]["loop"]["cache_len"]


def _record(**kw):
    base = dict(dims=dims_of(tiny.DEEPSEEK), setup_s=1.0, window_s=10.0, tokens=0, ttft_s=[],
                itl_s=[], step_s=[], loop={}, plan_s=[])
    return Record(**{**base, **kw})


def test_tails_over_every_request_and_rates_over_the_window():
    rng = np.random.default_rng(0)
    ttft, itl = rng.exponential(0.5, 300).tolist(), rng.exponential(0.05, 5000).tolist()
    rec = _record(tokens=4321, window_s=30.5, ttft_s=ttft, itl_s=itl)
    assert reader(BENCH, "ttft_p95_s")(rec) == pytest.approx(np.percentile(ttft, 95))
    assert reader(BENCH, "itl_p95_ms")(rec) == pytest.approx(1e3 * np.percentile(itl, 95))
    assert reader(BENCH, "tokens_per_s")(rec) == pytest.approx(4321 / 30.5)
    assert reader(BENCH, "ttft_p95_s")(_record()) is None


def test_a_new_cell_is_found_by_name(tmp_path):
    bench_dir = tiny.make_root(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-jamba.new", "config": "tiny-jamba",
                               "traffic": "tiny_chat", "chips": 1, "why": "added"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (bench_dir / "workloads" / "tiny-jamba.new.json").write_text(json.dumps(
        {"loop": tiny.LOOP, "load": {"clients": 2}, "limits": tiny.LIMITS}))
    cell = load_cell(bench_dir, "tiny-jamba.new")
    assert cell["workload"]["load"] == {"clients": 2}
    assert cell["model"]["name"] == "tiny-jamba"
    assert [m["name"] for m in metrics_for(cell["benchmark"], "tiny-jamba.new", False)] == [
        m["name"] for m in bench["end_to_end"]]


def test_a_new_generator_and_arrival_process_are_found_by_name(tmp_path):
    bench_dir = tiny.make_root(tmp_path)
    (bench_dir / "traffic" / "chat_again.py").write_text((BENCH / "traffic" / "chat.py").read_text())
    (bench_dir / "arrivals" / "even.py").write_text(
        "def gaps(params, rate, seed):\n    while True:\n        yield 1.0 / rate\n")
    mix = {**tiny.MIX, "generator": "chat_again", "arrivals": {"process": "even"}}
    t = traffic_of(bench_dir, mix, 256, 5)
    assert np.array_equal(t.request(3)[0], traffic_of(BENCH, tiny.MIX, 256, 5).request(3)[0])
    assert [g for _, g in zip(range(3), gaps_of(bench_dir, mix, 5, 4.0))] == [0.25] * 3


def test_a_new_model_family_is_found_by_name(tmp_path, monkeypatch):
    sigs = dims_of(tiny.DEEPSEEK).sigs
    for sub in ("families", "ports"):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "new_family.py").write_text(
            (BENCH / sub / "deepseek_v2.py").read_text())
    monkeypatch.setattr(spec, "FAMILIES", tmp_path / "families")
    monkeypatch.setattr(system, "PORTS", tmp_path / "ports")
    dims = dims_of({**tiny.DEEPSEEK, "model_type": "new_family"})
    assert dims.sigs == sigs
    assert system.port_config(dims).mla is not None


def test_configuration_files_state_the_source_and_cut_only_depth():
    bench = load_json(ROOT / "BENCHMARK.json")
    for c in bench["configs"]:
        cfg = load_json(ROOT / c["file"])
        assert cfg["source"] == c["source"]
        # the published value of every key that `reduced` names is stated beside it
        assert set(c["reduced"]) <= {"num_hidden_layers"}
        assert set(c["reduced"]) == set(cfg.get("published", {}))
        # what the program runs otherwise is stated apart, and named in the entry's why
        for key in cfg.get("runs_as", {}):
            assert key not in c["reduced"]
        assert not cfg.get("runs_as") or "departs" in c["why"]


def test_benchmark_json_keeps_its_contract():
    bench = load_json(ROOT / "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    assert configs == {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/") and len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        # every cell of a per-layer metric reports the metric it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        assert metrics_for(bench, cell, True), cell
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024
