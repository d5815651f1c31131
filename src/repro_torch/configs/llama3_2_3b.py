"""llama3.2-3b [dense] — small llama3.

[hf:meta-llama/Llama-3.2-1B; unverified] 28L d_model=3072 24H (GQA kv=8)
d_ff=8192 vocab=128256. Tied embeddings, rope_theta=500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=5e5,
)
