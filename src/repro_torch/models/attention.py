"""Grouped-query attention with a dense KV cache (``repro.models.attention``
counterparts of ``gqa``, ``full_attention`` and ``cache_update``).

Shapes: hidden (B, S, D); q (B, S, H, hd); kv (B, S, KVH, hd).  GQA is
computed grouped -- q reshaped to (B, S, KVH, G, hd) -- so KV heads are
never materialized H times.  Caches are updated IN PLACE (the JAX package
returns new buffers; here a write into a slice of the stacked cache lands
in the caller's buffer, which saves a copy of the cache per layer).
MLA, paged KV and chunked attention wait for later slices.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models._backend import join as _j

# int8 KV-cache quantization step (post-norm k/v live in ~[-8, 8])
KV_QSCALE = 16.0


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    sliding_window: int | None = None
    bias: bool = False
    causal: bool = True
    rotary: bool = True


def init_attn(gen, cfg: AttnConfig, dtype=torch.bfloat16, repeats=None):
    H, KVH, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(dtype=dtype, bias=cfg.bias, repeats=repeats)
    return {
        "wq": L.init_dense(gen, d, H * hd, **kw),
        "wk": L.init_dense(gen, d, KVH * hd, **kw),
        "wv": L.init_dense(gen, d, KVH * hd, **kw),
        "wo": L.init_dense(gen, H * hd, d, scale=(H * hd) ** -0.5, **kw),
    }


def _einsum(eq, a, b):
    """``torch.einsum`` with JAX's type promotion of the two operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _grouped_scores_softmax_out(q, k, v, mask, scale):
    """q (B,Sq,KVH,G,hd); k,v (B,Sk,KVH,hd); mask (Sq,Sk) or (B,Sq,Sk) bool
    or None."""
    s = _einsum("bqkgd,bskd->bkgqs", q, k).to(torch.float32) * scale
    if mask is not None:
        if mask.dim() == 3:
            mask = mask[:, None, None]
        s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype,
                                              device=s.device))
    p = torch.softmax(s, dim=-1)
    return _einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)


def _is_per_slot(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dim() == 1


def full_attention(q, k, v, *, causal, window=None, q_pos0=0, kv_len=None):
    """Unchunked attention.  ``q_pos0`` and ``kv_len`` are ints (one
    position for the whole batch) or (B,) tensors of per-slot positions /
    cache lengths."""
    B, Sq, KVH, G, hd = q.shape
    Sk = k.shape[1]
    dev = q.device
    scale = hd ** -0.5
    mask = None
    if _is_per_slot(q_pos0) or _is_per_slot(kv_len):
        q0 = q_pos0.reshape(-1, 1, 1) if _is_per_slot(q_pos0) else q_pos0
        qi = q0 + torch.arange(Sq, device=dev)[None, :, None]
        ki = torch.arange(Sk, device=dev)[None, None, :]
    else:
        qi = q_pos0 + torch.arange(Sq, device=dev)[:, None]
        ki = torch.arange(Sk, device=dev)[None, :]
    if causal:
        mask = ki <= qi
    if window is not None:
        wm = ki > qi - window
        mask = wm if mask is None else (mask & wm)
    if kv_len is not None:
        kl = kv_len.reshape(-1, 1, 1) if _is_per_slot(kv_len) else kv_len
        lm = ki < kl
        mask = lm if mask is None else (mask & lm)
    return _grouped_scores_softmax_out(q, k, v, mask, scale)


def cache_update(buf, val, index):
    """Write ``val (B, S, ...)`` into ``buf (B, S_max, ...)`` in place,
    starting at sequence position ``index``: an int (whole batch) or a (B,)
    tensor of per-slot positions.  Returns ``buf``."""
    S = val.shape[1]
    val = val.to(buf.dtype)
    if _is_per_slot(index):
        pos = index[:, None] + torch.arange(S, device=buf.device)[None, :]
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[rows, pos] = val
    else:
        buf[:, index:index + S] = val
    return buf


def _kv_encode(t):
    """int8 KV-cache codes: round(t * KV_QSCALE), clipped to +-127."""
    return torch.clamp(torch.round(t.to(torch.float32) * KV_QSCALE),
                       -127, 127).to(torch.int8)


def gqa(p, x, positions, cfg: AttnConfig, *, cache=None, cache_index=None,
        name=None):
    """Grouped-query attention.  ``cache``: optional {"k", "v"} of
    (B, S_max, KVH, hd), written at ``cache_index`` (int or (B,) tensor);
    an int8 cache holds `_kv_encode` codes.  Returns (out, cache)."""
    B, S, D = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KVH
    q = L.dense(p["wq"], x, _j(name, "wq")).reshape(B, S, H, hd)
    k = L.dense(p["wk"], x, _j(name, "wk")).reshape(B, S, KVH, hd)
    v = L.dense(p["wv"], x, _j(name, "wv")).reshape(B, S, KVH, hd)
    if cfg.rotary:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)

    kv_len = None
    if cache is not None:
        if cache["k"].dtype == torch.int8:
            kc = cache_update(cache["k"], _kv_encode(k), cache_index)
            vc = cache_update(cache["v"], _kv_encode(v), cache_index)
            k = kc.to(x.dtype) * (1.0 / KV_QSCALE)
            v = vc.to(x.dtype) * (1.0 / KV_QSCALE)
        else:
            k = cache_update(cache["k"], k, cache_index)
            v = cache_update(cache["v"], v, cache_index)
        kv_len = cache_index + S

    qg = q.reshape(B, S, KVH, G, hd)
    q_pos0 = cache_index if cache is not None else 0
    out = full_attention(qg, k, v, causal=cfg.causal,
                         window=cfg.sliding_window, q_pos0=q_pos0,
                         kv_len=kv_len)
    out = out.reshape(B, S, H * hd)
    return L.dense(p["wo"], out, _j(name, "wo")), cache
