from repro_torch.kernels.moe_gemm.kernel import moe_gemm
from repro_torch.kernels.moe_gemm.ops import grouped_expert_ffn
from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ref, moe_gemm_ref

__all__ = ["grouped_expert_ffn", "grouped_ffn_ref", "moe_gemm", "moe_gemm_ref"]
