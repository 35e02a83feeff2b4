"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf].

27L d_model=2048 16H (kv=16 via MLA kv_lora=512) moe_d_ff=1408 vocab=102400,
MoE 64 routed top-6 + 2 shared experts; layer 0 uses a dense FFN (10944).
"""
from repro_torch.configs.base import ArchConfig, MLASpec, register
from repro_torch.models.moe import MoEConfig

CONFIG = register(ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=102400, norm="rmsnorm", act="silu", gated_ffn=True,
    rope_theta=10000.0, pattern=("mla",),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2),
    moe_first_dense=1, dense_ff=10944,
    mla=MLASpec(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                v_head_dim=128),
))
