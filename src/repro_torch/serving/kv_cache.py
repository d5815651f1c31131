"""KV byte accounting (port of `cache_bytes`, repro/serving/kv_cache.py:34):
the contiguous per-slot reservation the paged pool is compared with."""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import MIXERS, check_supported, layer_signature


def cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Bytes of a contiguous cache of `batch` rows of `seq` tokens, as the
    reference's `init_cache` allocates it: 2 * Kv * hd values per token of
    an attention layer, kv_lora_rank + qk_rope_head_dim of an MLA layer."""
    check_supported(cfg)
    itemsize = torch_dtype(cfg.param_dtype).itemsize
    return sum(
        batch * math.prod(shape) * itemsize
        for i in range(cfg.n_layers)
        for shape in MIXERS[layer_signature(cfg, i)[0]].cache_shapes(cfg, seq).values()
    )
