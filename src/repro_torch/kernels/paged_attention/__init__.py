from repro_torch.kernels.paged_attention.kernel import (
    paged_decode_gqa,
    paged_decode_mla,
    paged_prefill_gqa,
    paged_prefill_mla,
)
from repro_torch.kernels.paged_attention.ops import active_block_width, n_width_buckets
from repro_torch.kernels.paged_attention.ref import (
    linearize_blocks,
    paged_decode_gqa_ref,
    paged_decode_mla_ref,
    paged_prefill_gqa_ref,
    paged_prefill_mla_ref,
)

__all__ = [
    "active_block_width",
    "linearize_blocks",
    "n_width_buckets",
    "paged_decode_gqa",
    "paged_decode_gqa_ref",
    "paged_decode_mla",
    "paged_decode_mla_ref",
    "paged_prefill_gqa",
    "paged_prefill_gqa_ref",
    "paged_prefill_mla",
    "paged_prefill_mla_ref",
]
