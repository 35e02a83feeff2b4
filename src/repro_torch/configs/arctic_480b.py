"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base; hf].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts top-2
PLUS a dense residual FFN in parallel (dense-MoE hybrid).  Its experts are
~26.8 GB of bf16 per layer, so one H100 holds 2 of the 35 layers.
"""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.moe import MoEConfig

CONFIG = register(ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000, norm="rmsnorm", act="silu", gated_ffn=True,
    rope_theta=10000.0, pattern=("attn",),
    moe=MoEConfig(n_experts=128, top_k=2, d_ff=4864),
    moe_dense_residual=True, dense_ff=4864,
))
