"""H2O-Danube3-4B [arXiv:2401.16818; unverified].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 — llama+mistral mix
with sliding-window attention (window 4096) => sub-quadratic, long_500k OK.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab=32000, norm="rmsnorm", act="silu", gated_ffn=True,
    rope_theta=10000.0, sliding_window=4096, pattern=("attn",),
    subquadratic=True,
))
