"""KV byte accounting (port of `cache_bytes`, repro/serving/kv_cache.py:34):
the contiguous per-slot reservation the paged pool is compared with."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import check_supported


def cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Bytes of a contiguous K/V cache of `batch` rows of `seq` tokens
    (what `init_cache` allocates for an attention-only model)."""
    check_supported(cfg)
    itemsize = torch_dtype(cfg.param_dtype).itemsize
    per_layer = 2 * batch * seq * cfg.n_kv_heads * cfg.resolved_head_dim * itemsize
    return cfg.n_layers * per_layer
