"""The plain reference against the port's CPU path on the same weights,
at tiny sizes of both families, and the float8 control failing where the
reference passes."""
import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts bench/ and src/ on the path)
from reference.layers import fp8_operands
from reference.model import logits_at
from spec import dims_of
import system

from repro_torch.models.model import prefill

SEED = 2**31 + 12345


def port_logits(dims, seq: torch.Tensor) -> torch.Tensor:
    """The port's logits at every position of `seq`: one masked prefill
    over all its prefixes, each row's last real token."""
    cfg = system.port_config(dims)
    params = system.build_params(dims, cfg, SEED, "cpu")
    n = len(seq)
    rows = seq[None, :].repeat(n, 1)
    mask = torch.arange(n)[None, :] <= torch.arange(n)[:, None]
    logits, _ = prefill(params, cfg, rows.int(), token_mask=mask)
    return logits.float()


@pytest.mark.parametrize("config", [tiny.DEEPSEEK, tiny.JAMBA], ids=["mla", "jamba"])
def test_reference_matches_port(config):
    dims = dims_of(config)
    seq = torch.as_tensor(np.random.default_rng(0).integers(0, dims.vocab, 24))
    ref = logits_at(dims, SEED, [seq], [torch.arange(24)], "cpu")[0]
    port = port_logits(dims, seq)
    scale = ref.abs().max()
    assert (ref - port).abs().max() <= 1e-4 * scale
    low = logits_at(dims, SEED, [seq], [torch.arange(24)], "cpu", quant=fp8_operands)[0]
    # the control sits far outside float32 rounding: at least 100x the port's error
    assert (ref - low).abs().max() > 100 * (ref - port).abs().max()
    assert (ref - low).abs().max() > 1e-3 * scale


def test_fp8_operands_rounds_to_e4m3():
    t = torch.randn(8, 16)
    q = fp8_operands(t, -1)
    assert not torch.equal(q, t)
    # e4m3 keeps 3 mantissa bits: at most 2^-4 relative error below the row's max
    big = t.abs() >= t.abs().amax(-1, keepdim=True) / 64
    assert ((q - t).abs() <= t.abs() * 2.0**-4 + 1e-6)[big].all()
