"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal backbone.

[arXiv:2308.11596; hf] 24L(decoder) d_model=1024 16H (kv=16, i.e. MHA)
d_ff=8192 vocab=256206. 24 encoder layers. The speech frontend
(w2v-BERT conformer feature extractor) is a STUB per spec:
input_specs() provides precomputed frame embeddings of shape
[batch, frames, d_model]. Decode shapes exercise the text decoder with
cross-attention over encoder states.
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    encdec=EncDecConfig(n_encoder_layers=24, cross_attention=True,
                        frontend_frames=1024),
)
