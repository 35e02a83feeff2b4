"""Grouped-query attention and multi-head latent attention with a dense or
paged KV cache (``repro.models.attention`` counterparts of ``gqa``,
``mla``, ``full_attention``, ``chunked_attention`` and ``cache_update``).

Shapes: hidden (B, S, D); q (B, S, H, hd); kv (B, S, KVH, hd).  GQA is
computed grouped -- q reshaped to (B, S, KVH, G, hd) -- so KV heads are
never materialized H times.  Caches are updated IN PLACE (the JAX package
returns new buffers; here a write into a slice of the stacked cache lands
in the caller's buffer, which saves a copy of the cache per layer).
Long prefills (``gqa(chunked=True)``) use `chunked_attention`, which on
the card is the flash-attention kernel of `repro_torch.kernels`.  The
paged KV pool of the serving engine (`paged_update`, `paged_gather`,
``gqa(pages=)``, ``mla(pages=)``) is written in place too.  `mla`
caches the compressed latent and decodes one token through the absorbed
path (``kv_b`` folded into the query and output sides).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.sharding import (attention_shards, constrain,
                                              merged, splittable,
                                              write_slice)
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


def _grouped_scores_softmax_out(q, k, v, mask, scale):
    """q (B,Sq,KVH,G,hd); k,v (B,Sk,KVH,hd); mask (Sq,Sk) or (B,Sq,Sk) bool
    or None."""
    s = L.einsum("bqkgd,bskd->bkgqs", q, k).to(torch.float32) * scale
    if mask is not None:
        if mask.dim() == 3:
            mask = mask[:, None, None]
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return L.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)


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
            s = L.einsum("bqkgd,bskd->bkgqs", qb, kb).to(torch.float32) * scale
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
            pv = L.einsum("bkgqs,bskd->bqkgd", p.to(vb.dtype), vb)
            o = o * alpha.permute(0, 3, 1, 2)[..., None] + pv.to(torch.float32)
            m = m_new
        o = o / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
        out[:, q0:q0 + q_chunk] = o.to(q.dtype)
    return out


def attention_plain(q, k, v, *, causal, kv_len, window=None):
    """The flash kernel's plain version on the model layout: what a
    planned backend with ``reference=True`` runs on the card."""
    B, Sq, KVH, G, hd = q.shape
    o = flash_attention_plain(q.reshape(B, Sq, KVH * G, hd).transpose(1, 2),
                              k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, kv_len=kv_len, window=window)
    return o.transpose(1, 2).reshape(B, Sq, KVH, G, v.shape[-1])


def chunked_attention(q, k, v, *, causal=True, window=None,
                      q_chunk=Q_CHUNK, k_chunk=K_CHUNK, kv_len=None):
    """Double-chunked online-softmax attention for long prefills.  q (B,
    Sq, KVH, G, hd); k, v (B, Sk, KVH, hd); ``kv_len`` masks keys at
    ``kpos >= kv_len``.  ``min(q_chunk, Sq)`` must divide Sq and
    ``min(k_chunk, Sk)`` Sk on every device (the JAX package asserts it).

    On the CPU it runs `chunked_attention_plain`, which autograd
    differentiates.  On a CUDA tensor it launches the flash-attention
    kernel on the model layout through strides (no copy of q, k or v),
    with the sliding ``window`` when one is given, or, when the installed
    matmul backend asks for its plain versions (``reference=True``), runs
    `attention_plain`.  The kernel has no backward pass: its wrapper
    raises under autograd.  A per-slot ``kv_len`` has no kernel yet and
    raises NotImplementedError there.  On DTensors it runs on each
    device's batch and KV-head shards (`sharding.attention_shards`)."""
    Sq, Sk = q.shape[1], k.shape[1]
    qc, kc = min(q_chunk, Sq), min(k_chunk, Sk)
    if Sq % qc or Sk % kc:
        raise ValueError(f"chunked_attention: Sq={Sq} is not a multiple of "
                         f"{qc} or Sk={Sk} of {kc}")
    if q.device.type == "cpu":
        return attention_shards(
            lambda q, k, v: chunked_attention_plain(
                q, k, v, causal=causal, window=window, q_chunk=qc,
                k_chunk=kc, kv_len=kv_len), q, k, v)
    if isinstance(kv_len, torch.Tensor):
        raise NotImplementedError(
            "chunked_attention on the card: the flash kernel takes one "
            "kv_len for the batch, not a per-slot one")
    if getattr(_backend.current(), "reference", False):
        return attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                               window=window)

    def flash(q, k, v):
        B, Sq, KVH, G, hd = q.shape
        H = KVH * G
        out = torch.empty((B, Sq, KVH, G, v.shape[-1]), dtype=q.dtype,
                          device=q.device)
        flash_attention(q.reshape(B, Sq, H, hd).transpose(1, 2),
                        k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                        kv_len=kv_len, window=window,
                        out=out.view(B, Sq, H, -1).transpose(1, 2))
        return out
    return attention_shards(flash, q, k, v)


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
        write_slice(buf, 1, index, val)
    return buf


# ------------------------------------------------------------- paged KV pool

def _paged_rows(pool, val, pages, index, mask):
    """Flat row indices of ``val (B, S, ...)`` in ``pool (P, ps, ...)``.

    ``pages`` is the (B, W) page table; ``index`` the (B,) tensor (or int)
    of starting logical positions.  Page 0 of the pool is the TRASH page:
    masked (padding) writes land on its row 0, and a position whose
    page-table entry is 0 inside it, so a slot with a zeroed table never
    corrupts live pages; so do positions at or beyond ``W * ps``."""
    B, S = val.shape[:2]
    W, ps = pages.shape[1], pool.shape[1]
    dev = pool.device
    start = index.reshape(-1, 1) if _is_per_slot(index) else index
    pos = start + torch.arange(S, device=dev)[None, :]
    logical = torch.clamp(torch.div(pos, ps, rounding_mode="floor"),
                          0, W - 1).expand(B, S)
    phys = torch.gather(pages.long(), 1, logical) * ps + pos % ps
    valid = pos < W * ps
    if mask is not None:
        valid = valid & mask
    return torch.where(valid, phys, 0)


def paged_update(pool, val, pages, index, mask=None):
    """Write ``val (B, S, ...)`` into the shared page pool ``pool (P, ps,
    ...)`` in place, at per-slot logical positions ``index`` under the page
    table ``pages (B, W)``; ``mask (B, S)`` sends padding writes to the
    trash page (row 0).  The pool is flattened with ``view``, so a pool
    that is not contiguous raises instead of taking the writes in a copy.
    Several masked writes land on row 0 (``index_copy_`` without
    accumulation: which one wins is undefined on the card, and row 0 is
    never read unmasked).  Returns ``pool``."""
    rows = _paged_rows(pool, val, pages, index, mask)
    B, S = val.shape[:2]
    feat = pool.shape[2:]
    flat = pool.view((pool.shape[0] * pool.shape[1],) + feat)
    flat.index_copy_(0, rows.reshape(-1),
                     val.to(pool.dtype).reshape((B * S,) + feat))
    return pool


def paged_gather(pool, pages):
    """Each slot's pages gathered into a dense (B, W * ps, ...) sequence
    view (a copy) -- `full_attention`'s ``q_pos0`` / ``kv_len`` masking
    then applies unchanged (the tail beyond ``kv_len``, trash-page rows
    included, is masked out)."""
    B, W = pages.shape
    ps = pool.shape[1]
    return pool[pages.long()].reshape((B, W * ps) + pool.shape[2:])


def _kv_encode(t):
    """int8 KV-cache codes: round(t * KV_QSCALE), clipped to +-127."""
    return torch.clamp(torch.round(t.to(torch.float32) * KV_QSCALE),
                       -127, 127).to(torch.int8)


def gqa(p, x, positions, cfg: AttnConfig, *, cache=None, cache_index=None,
        name=None, chunked=False, pages=None, write_mask=None,
        kv_override=None):
    """Grouped-query attention.  ``kv_override`` supplies precomputed (k,
    v) (B, T, KVH, hd) for cross-attention: ``wk`` / ``wv`` and rope are
    skipped, and without a cache every query attends to all T keys under
    ``cfg.causal``.  ``cache``: optional {"k", "v"} of
    (B, S_max, KVH, hd), written at ``cache_index`` (int or (B,) tensor);
    an int8 cache holds `_kv_encode` codes.  ``chunked`` (long prefill,
    cache written from position 0): attention through `chunked_attention`
    over the whole updated cache.  With ``pages`` (a (B, W) page table)
    the cache leaves are the SHARED (num_pages + 1, page_size, KVH, hd)
    pool instead: writes scatter through the table (`paged_update`,
    ``write_mask`` (B, S) sending padding to the trash page) and attention
    reads the gathered per-slot view (`paged_gather`) under the same
    per-slot ``q_pos0`` / ``kv_len`` masks; on the paged path a row whose
    attention output is not finite stays so through ``wo``.  Returns (out,
    cache)."""
    B, S, D = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KVH
    # `splittable`: on DTensors, the heads split where the shards allow
    q = splittable(L.dense(p["wq"], x, _j(name, "wq")), H).reshape(
        B, S, H, hd)
    if kv_override is None:
        k = splittable(L.dense(p["wk"], x, _j(name, "wk")), KVH).reshape(
            B, S, KVH, hd)
        v = splittable(L.dense(p["wv"], x, _j(name, "wv")), KVH).reshape(
            B, S, KVH, hd)
        if cfg.rotary:
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override

    if pages is not None:
        def upd(buf, val):
            return paged_update(buf, val, pages, cache_index, write_mask)

        def view(buf):
            return paged_gather(buf, pages)
    else:
        def upd(buf, val):
            return cache_update(buf, val, cache_index)

        def view(buf):
            return buf

    kv_len = None
    if cache is not None:
        if cache["k"].dtype == torch.int8:
            kc = upd(cache["k"], _kv_encode(k))
            vc = upd(cache["v"], _kv_encode(v))
            k = view(kc).to(x.dtype) * (1.0 / KV_QSCALE)
            v = view(vc).to(x.dtype) * (1.0 / KV_QSCALE)
        else:
            k = view(upd(cache["k"], k))
            v = view(upd(cache["v"], v))
        kv_len = cache_index + S

    qg = splittable(q, KVH, dim=2).reshape(B, S, KVH, G, hd)
    if chunked and S > 1:
        out = chunked_attention(qg, k, v, causal=cfg.causal,
                                window=cfg.sliding_window, kv_len=kv_len)
    else:
        q_pos0 = cache_index if cache is not None else 0
        # on DTensors, on each device's batch and head shards: the scores'
        # einsum would flatten a sequence-sharded cache
        out = attention_shards(
            lambda q, k, v: full_attention(
                q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                q_pos0=q_pos0, kv_len=kv_len), qg, k, v)
    out = merged(out, (B, S, H * hd), KVH)
    y = L.dense(p["wo"], out, _j(name, "wo"))
    if pages is not None:
        # a planned wo quantizes ``out`` to int8, which maps NaN (read from
        # a corrupted page) to a finite code: keep such rows non-finite,
        # so that the paged engine's logit screen sees the fault
        y = torch.where(torch.isfinite(out).all(dim=-1, keepdim=True), y,
                        float("nan"))
    return y, cache


# ---------------------------------------------------------------- MLA layer

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0


def init_mla(gen, cfg: MLAConfig, dtype=torch.bfloat16, repeats=None):
    H, d, r = cfg.n_heads, cfg.d_model, cfg.kv_lora_rank
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    kw = dict(dtype=dtype, repeats=repeats)
    return {
        "wq": L.init_dense(gen, d, H * qd, **kw),
        "kv_a": L.init_dense(gen, d, r + cfg.qk_rope_dim, **kw),
        "kv_norm": L.init_norm(r, dtype, repeats=repeats, device=gen.device),
        "kv_b": L.init_dense(gen, r, H * (cfg.qk_nope_dim + cfg.v_head_dim),
                             **kw),
        "wo": L.init_dense(gen, H * cfg.v_head_dim, d,
                           scale=(H * cfg.v_head_dim) ** -0.5, **kw),
    }


def _absorbed(p, q_nope, q_rope, latent, k_rope, kv_len, cfg: MLAConfig,
              dtype):
    """The ABSORBED decode (DeepSeek-V2, appendix): ``kv_b``'s weight folded
    into the query and output sides, so one query row attends over the
    compressed latent cache directly.  It reads ``p["kv_b"]["w"]`` (the
    weight itself, as the JAX package does, under a planned backend too;
    the int8 serving domain's ``w_q`` codes dequantized in ``dtype``),
    scores in float32 with the per-slot ``kv_len`` mask; returns (B, 1, H *
    v_head_dim)."""
    B, S, H, nd = q_nope.shape
    r, vd = cfg.kv_lora_rank, cfg.v_head_dim
    kvb = p["kv_b"]
    if "w_q" in kvb:
        w_flat = kvb["w_q"].to(dtype) * kvb["w_s"].to(dtype)[..., None, :]
    else:
        w_flat = kvb["w"]
    w_kvb = splittable(w_flat, H).reshape(r, H, nd + vd)
    w_uk, w_uv = w_kvb[..., :nd], w_kvb[..., nd:]
    q_abs = L.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
    f32 = torch.float32
    scale = (nd + cfg.qk_rope_dim) ** -0.5
    scores = (torch.einsum("bqhr,bsr->bhqs", q_abs.to(f32), latent.to(f32))
              + torch.einsum("bqhd,bsd->bhqs", q_rope.to(f32),
                             k_rope.to(f32))) * scale
    kl = kv_len.reshape(-1, 1, 1, 1) if _is_per_slot(kv_len) else kv_len
    mask = torch.arange(latent.shape[1],
                        device=latent.device)[None, None, None, :] < kl
    pw = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", pw, latent.to(f32))
    out = L.einsum("bqhr,rhv->bqhv", o_lat.to(dtype), w_uv)
    return merged(out, (B, S, H * vd), H)


def mla(p, x, positions, cfg: MLAConfig, *, cache=None, cache_index=None,
        name=None, chunked=False, pages=None, write_mask=None):
    """Multi-head Latent Attention (DeepSeek-V2).  The cache holds the
    compressed latent and the shared rope key, ``latent ‖ k_rope``: a dense
    {"latent": (B, S_max, r + rd)} or, with ``pages``, the shared (num_pages
    + 1, page_size, r + rd) pool, written and read as in `gqa` (bf16, or
    `_kv_encode` int8 codes).  A one-token step with a cache takes the
    absorbed path (`_absorbed`: ``kv_b`` is not run through the matmul
    backend); otherwise ``kv_b`` expands the whole cached latent (the
    gathered pages on the paged path) and attention is MHA over
    ``k = k_nope ‖ k_rope``, query / key dim ``nd + rd``, value dim ``vd``
    (`chunked_attention` for a long prefill, else `full_attention`).
    Returns (out, cache)."""
    B, S, D = x.shape
    H, r = cfg.n_heads, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = splittable(L.dense(p["wq"], x, _j(name, "wq")), H).reshape(
        B, S, H, nd + rd)
    q_nope = q[..., :nd]
    q_rope = L.rope(q[..., nd:], positions, cfg.rope_theta)
    kv = L.dense(p["kv_a"], x, _j(name, "kv_a"))
    latent = L.norm(p["kv_norm"], kv[..., :r])
    k_rope = L.rope(kv[:, :, None, r:], positions, cfg.rope_theta)[:, :, 0]

    kv_len = None
    if cache is not None:
        packed = torch.cat([latent, k_rope], dim=-1)
        buf = cache["latent"]
        if buf.dtype == torch.int8:
            packed = _kv_encode(packed)
        if pages is not None:
            paged_update(buf, packed, pages, cache_index, write_mask)
            seq = paged_gather(buf, pages)
        else:
            seq = cache_update(buf, packed, cache_index)
        if buf.dtype == torch.int8:
            seq = seq.to(x.dtype) * (1.0 / KV_QSCALE)
        latent, k_rope = seq[..., :r], seq[..., r:]
        kv_len = cache_index + S

    if cache is not None and S == 1:
        out = _absorbed(p, q_nope, q_rope, latent, k_rope, kv_len, cfg,
                        x.dtype)
    else:
        Sk = latent.shape[1]
        # a cached latent comes sharded as the cache is (on its sequence
        # for a DTensor); the expansion needs its rows whole
        latent = constrain(latent, "act")
        kvb = splittable(L.dense(p["kv_b"], latent, _j(name, "kv_b")),
                         H).reshape(B, Sk, H, nd + vd)
        k_nope, v = kvb[..., :nd], kvb[..., nd:]
        k = torch.cat([k_nope, k_rope[:, :, None, :].to(k_nope.dtype)
                       .expand(B, Sk, H, rd)], dim=-1)
        qg = torch.cat([q_nope, q_rope], dim=-1).reshape(B, S, H, 1, nd + rd)
        if chunked and S > 1:
            out = chunked_attention(qg, k, v, causal=True, kv_len=kv_len)
        else:
            q_pos0 = cache_index if cache is not None else 0
            out = full_attention(qg, k, v, causal=True, q_pos0=q_pos0,
                                 kv_len=kv_len)
        out = merged(out, (B, S, H * vd), H)
    y = L.dense(p["wo"], out, _j(name, "wo"))
    if pages is not None:
        # as in `gqa`: a row read from a non-finite page stays non-finite
        # through a planned wo
        y = torch.where(torch.isfinite(out).all(dim=-1, keepdim=True), y,
                        float("nan"))
    return y, cache
