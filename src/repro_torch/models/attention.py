"""Grouped-query attention with a dense KV cache (``repro.models.attention``
counterparts of ``gqa``, ``full_attention`` and ``cache_update``).

Shapes: hidden (B, S, D); q (B, S, H, hd); kv (B, S, KVH, hd).  GQA is
computed grouped -- q reshaped to (B, S, KVH, G, hd) -- so KV heads are
never materialized H times.  Caches are updated IN PLACE (the JAX package
returns new buffers; here a write into a slice of the stacked cache lands
in the caller's buffer, which saves a copy of the cache per layer).
Long prefills (``gqa(chunked=True)``) use `chunked_attention`, which on
the card is the flash-attention kernel of `repro_torch.kernels`.  MLA and
paged KV wait for later slices.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                flash_attention_plain)
from repro_torch.models import _backend
from repro_torch.models import layers as L
from repro_torch.models._backend import join as _j

# int8 KV-cache quantization step (post-norm k/v live in ~[-8, 8])
KV_QSCALE = 16.0
#: `chunked_attention`'s default query and key chunks: the contract (the
#: JAX package asserts it) is that they divide Sq and Sk
Q_CHUNK, K_CHUNK = 512, 1024


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


def chunked_attention_plain(q, k, v, *, causal, window, q_chunk, k_chunk,
                            kv_len):
    """The JAX package's double-chunked online softmax, step for step:
    scores and PV in the operands' dtype (as its einsums round them), the
    running max, denominator and accumulator in float32, the causal upper
    triangle masked (not skipped).  ``q_chunk`` divides Sq, ``k_chunk``
    divides Sk."""
    B, Sq, KVH, G, hd = q.shape
    Sk, vd = k.shape[1], v.shape[-1]
    dev = q.device
    scale = hd ** -0.5
    out = torch.empty((B, Sq, KVH, G, vd), dtype=q.dtype, device=dev)
    for q0 in range(0, Sq, q_chunk):
        qb = q[:, q0:q0 + q_chunk]
        m = torch.full((B, KVH, G, q_chunk), float("-inf"), device=dev)
        l = torch.zeros((B, KVH, G, q_chunk), device=dev)
        o = torch.zeros((B, q_chunk, KVH, G, vd), device=dev)
        qpos = q0 + torch.arange(q_chunk, device=dev)[:, None]
        for k0 in range(0, Sk, k_chunk):
            kb, vb = k[:, k0:k0 + k_chunk], v[:, k0:k0 + k_chunk]
            s = _einsum("bqkgd,bskd->bkgqs", qb, kb).to(torch.float32) * scale
            kpos = k0 + torch.arange(k_chunk, device=dev)[None, :]
            mask = torch.ones((q_chunk, k_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos <= qpos
            if window is not None:
                mask &= kpos > qpos - window
            if kv_len is not None:
                mask &= kpos < kv_len
            s = s.masked_fill(~mask, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = _einsum("bkgqs,bskd->bqkgd", p.to(vb.dtype), vb)
            o = o * alpha.permute(0, 3, 1, 2)[..., None] + pv.to(torch.float32)
            m = m_new
        o = o / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
        out[:, q0:q0 + q_chunk] = o.to(q.dtype)
    return out


def attention_plain(q, k, v, *, causal, kv_len):
    """The flash kernel's plain version on the model layout: what a
    planned backend with ``reference=True`` runs on the card."""
    B, Sq, KVH, G, hd = q.shape
    o = flash_attention_plain(q.reshape(B, Sq, KVH * G, hd).transpose(1, 2),
                              k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, kv_len=kv_len)
    return o.transpose(1, 2).reshape(B, Sq, KVH, G, v.shape[-1])


def chunked_attention(q, k, v, *, causal=True, window=None,
                      q_chunk=Q_CHUNK, k_chunk=K_CHUNK, kv_len=None):
    """Double-chunked online-softmax attention for long prefills.  q (B,
    Sq, KVH, G, hd); k, v (B, Sk, KVH, hd); ``kv_len`` masks keys at
    ``kpos >= kv_len``.  ``min(q_chunk, Sq)`` must divide Sq and
    ``min(k_chunk, Sk)`` Sk on every device (the JAX package asserts it).

    On the CPU it runs `chunked_attention_plain`.  On a CUDA tensor it
    launches the flash-attention kernel on the model layout through
    strides (no copy of q, k or v), or, when the installed matmul backend
    asks for its plain versions (``reference=True``), runs
    `attention_plain`.  A window or a per-slot ``kv_len`` has no kernel
    yet and raises NotImplementedError there."""
    B, Sq, KVH, G, hd = q.shape
    Sk = k.shape[1]
    qc, kc = min(q_chunk, Sq), min(k_chunk, Sk)
    if Sq % qc or Sk % kc:
        raise ValueError(f"chunked_attention: Sq={Sq} is not a multiple of "
                         f"{qc} or Sk={Sk} of {kc}")
    if q.device.type == "cpu":
        return chunked_attention_plain(q, k, v, causal=causal, window=window,
                                       q_chunk=qc, k_chunk=kc, kv_len=kv_len)
    if window is not None or isinstance(kv_len, torch.Tensor):
        raise NotImplementedError(
            "chunked_attention on the card: a sliding window or per-slot "
            "kv_len waits for a later slice of the port")
    if getattr(_backend.current(), "reference", False):
        return attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    H = KVH * G
    out = torch.empty((B, Sq, KVH, G, v.shape[-1]), dtype=q.dtype,
                      device=q.device)
    flash_attention(q.reshape(B, Sq, H, hd).transpose(1, 2),
                    k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                    kv_len=kv_len,
                    out=out.view(B, Sq, H, -1).transpose(1, 2))
    return out


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
        name=None, chunked=False):
    """Grouped-query attention.  ``cache``: optional {"k", "v"} of
    (B, S_max, KVH, hd), written at ``cache_index`` (int or (B,) tensor);
    an int8 cache holds `_kv_encode` codes.  ``chunked`` (long prefill,
    cache written from position 0): attention through `chunked_attention`
    over the whole updated cache.  Returns (out, cache)."""
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
    if chunked and S > 1:
        out = chunked_attention(qg, k, v, causal=cfg.causal,
                                window=cfg.sliding_window, kv_len=kv_len)
    else:
        q_pos0 = cache_index if cache is not None else 0
        out = full_attention(qg, k, v, causal=cfg.causal,
                             window=cfg.sliding_window, q_pos0=q_pos0,
                             kv_len=kv_len)
    out = out.reshape(B, S, H * hd)
    return L.dense(p["wo"], out, _j(name, "wo")), cache
