"""Nemotron-4 15B [arXiv:2402.16819; unverified].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000 — GQA,
squared-ReLU ungated MLP, LayerNorm, RoPE.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=256000, norm="layernorm", act="relu2", gated_ffn=False,
    rope_theta=10000.0, pattern=("attn",),
))
