from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import attention_ref, rounding_bound

__all__ = ["attention_ref", "flash_attention", "mha", "rounding_bound"]
