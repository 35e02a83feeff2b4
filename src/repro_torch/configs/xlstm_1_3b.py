"""xLSTM-1.3B [arXiv:2405.04517; unverified].

48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304 -- xLSTM[7:1]: 7 mLSTM blocks
per sLSTM block.  The blocks' head dim is d_inner / 4 = 1024 (``head_dim``
512 is the JAX package's field, which no xLSTM block reads).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab=50304, norm="rmsnorm",
    pattern=("mlstm",) * 7 + ("slstm",),
    subquadratic=True,
))
