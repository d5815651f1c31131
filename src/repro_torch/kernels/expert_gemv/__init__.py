from repro_torch.kernels.expert_gemv.kernel import expert_ffn_gemv
from repro_torch.kernels.expert_gemv.ops import cold_expert_ffn
from repro_torch.kernels.expert_gemv.ref import expert_ffn_gemv_ref, gemv_rounding_bound

__all__ = ["cold_expert_ffn", "expert_ffn_gemv", "expert_ffn_gemv_ref", "gemv_rounding_bound"]
