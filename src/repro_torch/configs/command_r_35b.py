"""Command R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 — GQA, no-bias,
parallel attention+FFN residual block, LayerNorm, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab=256000, norm="layernorm", act="silu", gated_ffn=True,
    parallel_block=True, rope_theta=8_000_000.0, tie_embeddings=True,
    pattern=("attn",),
))
