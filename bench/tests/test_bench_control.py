"""The control at a size a test run holds: the reference computed with
float8 operands in the program's place, on the same served sample, comes
out over the cell's limit on every seed where the program stays under it.
(At the cells' own sizes the control's readings come from
`bench/run.py --control 1` on the card; PERF.md gives them.)"""
import time

import pytest

import tiny
from harness import run_cell


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("cell", ["tiny-deepseek.chat", "tiny-jamba.chat"])
@pytest.mark.parametrize("seed", [1, 2**31 + 1, 977])
def test_control_fails_where_the_program_passes(bench_dir, cell, seed):
    out = run_cell(bench_dir, cell, seed, 3.0, False, time.time(), device="cpu", control=True)
    limit = out["checks"]["mean_logit_gap"]["limit"]
    assert out["checks"]["mean_logit_gap"]["value"] <= limit
    assert out["diagnostics"]["control_mean_logit_gap"] > limit
