"""Architecture config schema + registry (``repro.configs.base``
counterpart): every config of the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.models.moe import MoEConfig  # noqa: F401 (configs use it)


@dataclasses.dataclass(frozen=True)
class MLASpec:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|vlm|audio|ssm|moe|hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_ffn: bool = True
    parallel_block: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    pattern: Tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    moe_dense_residual: bool = False
    moe_first_dense: int = 0
    dense_ff: int = 0
    mla: Optional[MLASpec] = None
    ssm_state: int = 64
    encoder_layers: int = 0
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    subquadratic: bool = False
    param_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"   # "int8": quantized KV cache
    serve_weight_dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def pattern_repeats(self) -> int:
        """Whole repeats of ``pattern``.  A hybrid pattern with a shared
        attention block (zamba2) may leave layers past the last whole
        repeat: its remainder blocks (``params["rem"]``), as in the JAX
        package; any other pattern must tile ``n_layers``."""
        if self.n_layers % len(self.pattern) and \
                "shared_attn" not in self.pattern:
            raise ValueError(f"{self.name}: {self.n_layers} layers do not "
                             f"tile the pattern {self.pattern}")
        return self.n_layers // len(self.pattern)


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    if not _REGISTRY:
        load_all()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port registers "
                       f"{names()}") from None


def names():
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)


def load_all():
    """Import every config module of the port (each self-registers)."""
    from repro_torch.configs import (  # noqa: F401
        arctic_480b, command_r_35b, deepseek_v2_lite_16b, h2o_danube_3_4b,
        llama_3_2_vision_11b, nemotron_4_15b, seamless_m4t_large_v2,
        xlstm_1_3b, yi_9b, zamba2_1_2b)


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Shrink a config to CPU-test size, preserving the family shape
    (identical to ``repro.configs.base.reduce_for_smoke``)."""
    period = len(cfg.pattern)
    n_layers = period * min(2, max(1, cfg.n_layers // period))
    if cfg.name.startswith("zamba"):
        n_layers = period + 2
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=8,
                                  top_k=min(cfg.moe.top_k, 2), d_ff=64)
    mla = MLASpec(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                  v_head_dim=16) if cfg.mla else None
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=64,
        n_heads=4, n_kv_heads=min(4, max(1, cfg.n_kv_heads)), head_dim=16,
        d_ff=128 if cfg.d_ff else 0, vocab=128, moe=moe, mla=mla,
        dense_ff=96 if cfg.dense_ff else 0,
        encoder_layers=min(2, cfg.encoder_layers),
        frontend_tokens=8 if cfg.frontend_tokens else 0,
        sliding_window=16 if cfg.sliding_window else None)
