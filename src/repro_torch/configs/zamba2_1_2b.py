"""Zamba2-1.2B [arXiv:2411.15242; hf].

38 blocks d_model=2048, Mamba2 backbone (ssm_state=64) with a SHARED
attention+FFN transformer block applied every 6th position (weights shared,
per-use input norms). 32H kv=32, shared-block d_ff=8192.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000, norm="rmsnorm", act="gelu", gated_ffn=True,
    rope_theta=10000.0,
    pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    ssm_state=64, subquadratic=True,
))
