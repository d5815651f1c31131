from repro_torch.serving.batching import BucketTable, Request, ZigzagBatcher
from repro_torch.serving.engine import (
    TriMoEServingEngine,
    fill_tiers_from_params,
    init_tiered_for_model,
    strip_expert_weights,
)
from repro_torch.serving.kv_cache import cache_bytes
from repro_torch.serving.loop import LoopStats, ServingLoop
from repro_torch.serving.paged_kv import (
    PagedKVCache,
    RadixPrefixIndex,
    init_paged_cache,
)
from repro_torch.serving.replay import ReplayResult, replay_requests, requests_from_trace
from repro_torch.serving.spec_decode import DraftConfig, PromptLookupDrafter
from repro_torch.serving.tiered_moe import (
    TierSizes,
    apply_migrations,
    init_tiered_state,
    tier_sizes,
    tiered_moe_forward,
)

__all__ = [
    "BucketTable", "Request", "ZigzagBatcher", "TriMoEServingEngine",
    "fill_tiers_from_params", "init_tiered_for_model", "strip_expert_weights",
    "cache_bytes", "LoopStats", "ServingLoop", "TierSizes",
    "apply_migrations", "init_tiered_state", "tier_sizes", "tiered_moe_forward",
    "PagedKVCache", "RadixPrefixIndex", "init_paged_cache",
    "DraftConfig", "PromptLookupDrafter", "ReplayResult", "replay_requests",
    "requests_from_trace",
]
