"""The grouped expert GEMM's share of its roofline over the traced slice,
in percent: the prefill MoE calls' bounds (the experts that received
tokens and their rows; the larger of bytes over HBM bandwidth and
operations over peak) over the device time of `moe_gemm`'s launches."""

KERNELS = r"\bmoe_gemm_(bf16|f32)_kernel\b"


def read(rec):
    return rec.roofline_pct(KERNELS, decode=False)
