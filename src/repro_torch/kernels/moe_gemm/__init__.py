from repro_torch.kernels.moe_gemm.kernel import moe_gemm
from repro_torch.kernels.moe_gemm.ops import grouped_expert_ffn, grouped_expert_matmul
from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ref, moe_gemm_groups_ref, moe_gemm_ref

__all__ = ["grouped_expert_ffn", "grouped_expert_matmul", "grouped_ffn_ref", "moe_gemm",
           "moe_gemm_groups_ref", "moe_gemm_ref"]
