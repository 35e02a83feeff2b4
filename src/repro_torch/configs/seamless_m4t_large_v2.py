"""SeamlessM4T-large-v2 [arXiv:2308.11596; hf].

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206 -- encoder-decoder,
multimodal.  The speech frontend is a STUB: each request carries
precomputed frame embeddings (1024, d_model), which a 24-layer encoder
turns into the memory the text decoder cross-attends.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206, norm="layernorm", act="gelu", gated_ffn=False,
    rope_theta=10000.0, pattern=("dec",),
    encoder_layers=24, frontend="audio", frontend_tokens=1024,
))
