"""chameleon-34b [vlm] — early-fusion VLM, VQ image tokens.

[arXiv:2405.09818; unverified] 48L d_model=8192 64H (GQA kv=8)
d_ff=22016 vocab=65536. Early fusion: images arrive as VQ token ids in
the same stream, so the backbone is a plain dense decoder; the VQ-VAE
image tokenizer is a frontend STUB per spec (input_specs feeds token ids /
precomputed patch embeddings).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
)
