"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256 -- text backbone with
gated cross-attention image layers every 5th layer.  The vision tower is a
STUB: each request carries precomputed patch embeddings (1024, d_model).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, norm="rmsnorm", act="silu", gated_ffn=True,
    rope_theta=500000.0,
    pattern=("attn", "attn", "attn", "cross", "attn"),
    frontend="vision", frontend_tokens=1024,
))
