"""The yardstick's counts against hand-computed ones, on rows of the
kernel table in PERF.md (DeepSeek-V2's published widths, D 5120, F 1536)."""
import dataclasses

import pytest

import tiny  # noqa: F401
import roofline
from spec import dims_of

DS236 = dims_of({**tiny.DEEPSEEK, "name": "ds236", "hidden_size": 5120,
                 "moe_intermediate_size": 1536, "served_dtype": "bfloat16"})


def test_gemv_hot_tier_row():
    # expert_ffn_gemv, deepseek hot tier, 25 slots x 4 tokens: bound 0.35275 ms (bytes)
    nbytes = 25 * 3 * 5120 * 1536 * 2 + 2 * 100 * 5120 * 2
    assert roofline.expert_ffn_bytes(DS236, 25, 100) == nbytes
    assert roofline.expert_call_bound_s(DS236, 25, 100) * 1e3 == pytest.approx(0.35275, abs=5e-6)


def test_moe_gemm_hot_tier_rows():
    # moe_gemm, deepseek hot 25 x 128 rows: the table's gate|up row (bound
    # 0.25041 ms) and down row (0.13009 ms) are launches; the FFN-level
    # bound leaves out the intermediate [rows, 2F] written and [rows, F] read
    rows = 25 * 128
    ffn = roofline.expert_call_bound_s(DS236, 25, rows)
    inter = (rows * 2 * 1536 * 2 + rows * 1536 * 2) / roofline.HBM_BPS
    assert (ffn + inter) * 1e3 == pytest.approx(0.25041 + 0.13009, abs=2e-5)
    flops = roofline.expert_ffn_flops(DS236, rows)
    assert flops == 6 * rows * 5120 * 1536
    assert ffn == pytest.approx(roofline.expert_ffn_bytes(DS236, 25, rows) / roofline.HBM_BPS)


def test_token_flops_by_hand():
    d = dims_of(tiny.DEEPSEEK)
    # dense layer 0 + 2 MoE layers, MLA everywhere: D 64, H 4, nope 16, rope 8, v 16, r 32
    mla = 2 * (64 * 4 * 24 + 64 * 40 + 32 * 4 * 32 + 4 * 16 * 64)
    per_key = 2 * 4 * (24 + 16)
    dense = 6 * 64 * 96
    moe = 2 * 64 * 8 + 6 * 64 * 32 * (2 + 1)
    ctx = 10
    want = 3 * (mla + per_key * ctx) + dense + 2 * moe
    assert roofline.token_flops(d, ctx) == want
    # a window: two decode rows at contexts 10 and 11, one prefill row of 3
    # tokens after 5 cached (contexts 6, 7, 8), each row with one logits row
    head = 2 * 64 * 256
    got = roofline.window_flops(d, [10, 11], [(5, 3)])
    assert got == sum(roofline.token_flops(d, c) for c in (10, 11, 6, 7, 8)) + 3 * head


def test_fp32_peak():
    d32 = dataclasses.replace(DS236, dtype="float32")
    rows = 4096
    assert roofline.expert_call_bound_s(d32, 1, rows) == pytest.approx(
        max(roofline.expert_ffn_bytes(d32, 1, rows) / roofline.HBM_BPS,
            roofline.expert_ffn_flops(d32, rows) / 67e12))
