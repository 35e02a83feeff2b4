"""Config-driven LM assembly (``repro.models.transformer`` counterpart) for
the dense attention-only ``("attn",)`` pattern, zamba2's hybrid one (five
Mamba2 blocks, then one shared attention + FFN block), xlstm's (seven
mLSTM blocks, then one sLSTM block), deepseek's ``("mla",)`` one
(multi-head latent attention, then a MoE FFN; its layer 0 a dense FFN of
width ``cfg.dense_ff``, unstacked as ``params["first_dense"]`` and run
before the repeats), llama-3.2-vision's (four attention blocks and one
gated ``cross``-attention block to the frontend's rows) and seamless's
encoder-decoder ``("dec",)`` one (self-attention, cross-attention to the
encoder's memory, FFN; the encoder's non-causal rotary blocks stacked as
``params["enc_units"]``, named ``enc_units/0/...``).  Dense blocks take
either norm (RMSNorm, or LayerNorm with a bias: ``cfg.norm``), a gated or
ungated FFN, attention and FFN in parallel on one norm
(``cfg.parallel_block``: command-r), a sliding window
(``cfg.sliding_window``: h2o-danube), a head tied to the
embedding (``cfg.tie_embeddings``: no ``params["head"]``, logits ``h @
emb.T``) and, with ``cfg.moe``, a MoE FFN in place of the FFN, beside a
dense residual FFN of width ``cfg.dense_ff`` on the same norm under
``cfg.moe_dense_residual`` (arctic).

Params are the JAX package's pytree as a nested dict of tensors: the
layers are ``pattern_repeats`` repeats of the block pattern, one block per
pattern position stacked on a leading repeat axis R
(``params["units"][0]["attn"]["wq"]["w"]`` is ``(R, d_model, H * hd)``),
so a mapping artifact's layer names (``units/0/attn/wq@r``) address the
same weights in both packages.  zamba2's two blocks past its last whole
repeat are unstacked (``params["rem"]``, named ``rem/{i}``), and its
shared block's weights are one copy (``params["shared"]``, named
``shared/attn`` and ``shared/ffn`` at every use) with a per-use input norm
stacked in its pattern position.  deepseek's ``first_dense`` block is
named ``first_dense`` and its cache is ``caches["first"]``; its stacked
units hold ``n_layers - 1`` repeats.  Where the JAX package runs
``jax.lax.scan`` over the repeats, `backbone` loops in Python and
publishes the repeat index with `_backend.scan_slot`.

Public API:
  init_lm(gen, cfg)                              -> params (on gen.device)
  param_shapes(cfg)                              -> params as meta tensors
  params_from_jax(tree, device)                  -> params
  lm_loss(params, cfg, batch, remat=)            -> scalar loss (training)
  chunked_ce(h, w, targets)                      -> mean cross-entropy
  backbone(params, cfg, x, positions, ...)       -> (hidden, caches, aux)
  prefill(params, cfg, tokens, caches, lengths=, variant=, cross_source=)
                                                 -> (last_logits, caches)
  prefill_chunk(params, cfg, tokens, caches, index, valid, pages,
                variant=, full_logits=, cross_source=)
                                                 -> (logits, caches)
  encode(params, cfg, frames)                    -> encoder memory
  decode_step(params, cfg, token, caches, index, active=, pages=,
              variant=)                          -> (logits, caches)
  cache_specs(cfg, B, S_max)                     -> tree of meta tensors
  init_cache(cfg, B, S_max, device)              -> caches
  paged_cache_specs(cfg, B, pool_rows, page_size)-> tree of meta tensors
  init_paged_cache(cfg, B, pool_rows, page_size, device) -> caches
  cache_kv_axes(cfg)                             -> layout marker per leaf
  cache_batch_axes(caches)                       -> batch axis per leaf
  scatter_cache(caches, sub, slots)              -> caches (in place)
  copy_pages(caches, src, dst, kv_axes)          -> caches (in place)
  quantize_for_serve(params, cfg)                -> int8 serving params

Caches are updated in place (see `repro_torch.models.attention`): the
attention KV (dense per slot, or paged) and the recurrent blocks' per-slot
state (Mamba2's ``ssm``, mLSTM's ``C`` / ``n`` / ``m``, sLSTM's ``c`` /
``n`` / ``h`` / ``m``, all float32; the conv carries in the activation
dtype), which ``length_mask`` (ragged prefill, chunk validity,
``active``) leaves unchanged at masked steps (bit for bit but mLSTM's
``m``, which the JAX package's padding step moves by at most log
sigmoid(80)).  A prompt longer than 2048 tokens
prefills through the chunked (flash) attention, as the JAX package's
``_prefill_body`` does; like the JAX package's, that path needs a cache
length that is a multiple of ``min(1024, S_max)`` and a prompt length
that is a multiple of ``min(512, S)``.  ``length_mask`` also drops masked
tokens from MoE dispatch before the capacity cumsum, so padding and
retired slots never take an expert's place.  The cross-attention
memory (``ck`` / ``cv`` of the ``cross`` and ``dec`` blocks) is written
at prefill and at every chunk from ``cross_source`` and read at decode;
it is per-slot state, bfloat16 in every KV dtype.  The dense serving
engine (`repro_torch.serving.Engine(kv_layout="dense")`) prefills
admission groups with ``prefill(lengths=)``, moves them into its slot pool
with `scatter_cache` and decodes all slots with a per-slot ``index``; the
paged one streams prompts into its page pool with `prefill_chunk` (full
attention over each slot's gathered pages, never the chunked path, as in
the JAX package; recurrent state carried across chunks) and decodes with
``decode_step(pages=)``.

Training (`lm_loss`) runs the same blocks without caches: nothing is
written in place, each repeat may be rematerialised (``remat``), the MoE
blocks' load-balance aux is summed into the loss as in the JAX package,
and the vocab projection runs per 512-position chunk (`chunked_ce`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (constrain, settled,
                                              splittable)
from repro_torch.models import _backend
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

_j = _backend.join


#: the block kinds a pattern is made of, each built and run on its own
#: (the JAX package's `init_block` / `block_apply`): attention blocks
#: (dense, or with a MoE FFN), MLA + MoE, gated cross-attention,
#: encoder-decoder, Mamba2, mLSTM, sLSTM and zamba2's shared attention
BLOCK_KINDS = ("attn", "mla", "cross", "dec", "mamba", "mlstm", "slstm",
               "shared_attn")


def _check_supported(cfg: ArchConfig):
    """Refuse what the JAX package refuses: a block kind it does not know,
    and an ``mla`` block without ``cfg.moe`` (its MoE FFN reads it)."""
    unknown = [k for k in cfg.pattern if k not in BLOCK_KINDS]
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kind(s) {unknown}; "
                         f"a pattern is made of {BLOCK_KINDS}")
    if "mla" in cfg.pattern and cfg.moe is None:
        raise NotImplementedError(
            f"{cfg.name}: MLA without MoE blocks: an mla block holds a MoE "
            f"FFN (past its first dense layer), which needs cfg.moe, as "
            f"in the JAX package")


def _attn_cfg(cfg: ArchConfig, causal=True, cross=False) -> A.AttnConfig:
    """A cross-attention has no window, no rope and is not causal."""
    return A.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, rope_theta=cfg.rope_theta,
        sliding_window=None if cross else cfg.sliding_window,
        causal=causal and not cross, rotary=not cross)


def _mla_cfg(cfg: ArchConfig) -> A.MLAConfig:
    m = cfg.mla
    return A.MLAConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                       kv_lora_rank=m.kv_lora_rank, qk_nope_dim=m.qk_nope_dim,
                       qk_rope_dim=m.qk_rope_dim, v_head_dim=m.v_head_dim,
                       rope_theta=cfg.rope_theta)


def _mamba_cfg(cfg: ArchConfig) -> S.Mamba2Config:
    return S.Mamba2Config(d_model=cfg.d_model, d_state=cfg.ssm_state)


def _xlstm_cfg(cfg: ArchConfig) -> S.XLSTMConfig:
    return S.XLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads)


#: recurrent block kinds: (params key, function, its config)
_RECURRENT = {"mamba": ("mamba", S.mamba2, _mamba_cfg),
              "mlstm": ("core", S.mlstm, _xlstm_cfg),
              "slstm": ("core", S.slstm, _xlstm_cfg)}


def _dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _zamba_remainder(cfg: ArchConfig) -> int:
    period = len(cfg.pattern)
    return cfg.n_layers - (cfg.n_layers // period) * period


def _unit_repeats(cfg: ArchConfig) -> int:
    """Repeats of the stacked units: deepseek's layer 0 lives unstacked in
    ``params["first_dense"]``."""
    first = 1 if cfg.moe_first_dense and len(cfg.pattern) == 1 else 0
    return cfg.pattern_repeats - first


def init_block(gen: torch.Generator, cfg: ArchConfig, kind: str,
               repeats=None, first_dense=False):
    """One block of ``kind``, stacked on a leading ``repeats`` axis when
    given.  A ``shared_attn`` block holds only its per-use input norm; its
    weights live in ``params["shared"]`` (`init_shared_block`).  An
    ``attn`` block under ``cfg.moe`` holds a MoE FFN, and under
    ``cfg.moe_dense_residual`` also ``norm2`` and a dense FFN of width
    ``cfg.dense_ff`` (arctic; as in the JAX package, a MoE block without
    ``norm2`` normalises the FFN's input with ``norm1``).  An ``mla``
    block holds MLA, ``norm2`` and a MoE FFN, or with ``first_dense`` a
    dense FFN of width ``cfg.dense_ff``.  ``mlstm`` / ``slstm`` blocks
    hold their core under ``"core"``.  A ``cross`` block holds its
    attention, a scalar ``gate`` (zero, as in the JAX package: at init the
    block adds nothing), an FFN and ``norm2``; a ``dec`` block
    self-attention, ``xattn``, ``normx``, an FFN and ``norm2``."""
    dt, dev, d = _dtype(cfg), gen.device, cfg.d_model
    nk = dict(repeats=repeats, device=dev, kind=cfg.norm)
    p = {"norm1": L.init_norm(d, dt, **nk)}
    if kind == "attn":
        p["attn"] = A.init_attn(gen, _attn_cfg(cfg), dt, repeats=repeats)
        if cfg.moe is not None:
            p["moe"] = M.init_moe(gen, d, cfg.moe, dt, repeats=repeats)
            if cfg.moe_dense_residual:
                p["ffn"] = L.init_ffn(gen, d, cfg.dense_ff, cfg.gated_ffn,
                                      dt, repeats=repeats)
                p["norm2"] = L.init_norm(d, dt, **nk)
        elif cfg.d_ff:
            p["ffn"] = L.init_ffn(gen, d, cfg.d_ff, cfg.gated_ffn, dt,
                                  repeats=repeats)
            if not cfg.parallel_block:
                p["norm2"] = L.init_norm(d, dt, **nk)
    elif kind == "mla":
        p["attn"] = A.init_mla(gen, _mla_cfg(cfg), dt, repeats=repeats)
        if first_dense:
            p["ffn"] = L.init_ffn(gen, d, cfg.dense_ff, cfg.gated_ffn, dt,
                                  repeats=repeats)
        else:
            p["moe"] = M.init_moe(gen, d, cfg.moe, dt, repeats=repeats)
        p["norm2"] = L.init_norm(d, dt, **nk)
    elif kind == "cross":
        p["attn"] = A.init_attn(gen, _attn_cfg(cfg, cross=True), dt,
                                repeats=repeats)
        p["gate"] = torch.zeros(() if repeats is None else (repeats,),
                                dtype=dt, device=dev)
        p["ffn"] = L.init_ffn(gen, d, cfg.d_ff, cfg.gated_ffn, dt,
                              repeats=repeats)
        p["norm2"] = L.init_norm(d, dt, **nk)
    elif kind == "dec":
        p["attn"] = A.init_attn(gen, _attn_cfg(cfg), dt, repeats=repeats)
        p["xattn"] = A.init_attn(gen, _attn_cfg(cfg, cross=True), dt,
                                 repeats=repeats)
        p["normx"] = L.init_norm(d, dt, **nk)
        p["ffn"] = L.init_ffn(gen, d, cfg.d_ff, cfg.gated_ffn, dt,
                              repeats=repeats)
        p["norm2"] = L.init_norm(d, dt, **nk)
    elif kind == "mamba":
        p["mamba"] = S.init_mamba2(gen, _mamba_cfg(cfg), dt, repeats=repeats)
    elif kind == "mlstm":
        p["core"] = S.init_mlstm(gen, _xlstm_cfg(cfg), dt, repeats=repeats)
    elif kind == "slstm":
        p["core"] = S.init_slstm(gen, _xlstm_cfg(cfg), dt, repeats=repeats)
    elif kind != "shared_attn":
        raise ValueError(kind)
    return p


def init_shared_block(gen: torch.Generator, cfg: ArchConfig):
    """zamba2's shared transformer block (one copy)."""
    dt, d = _dtype(cfg), cfg.d_model
    return {"attn": A.init_attn(gen, _attn_cfg(cfg), dt),
            "ffn": L.init_ffn(gen, d, cfg.d_ff, cfg.gated_ffn, dt),
            "norm2": L.init_norm(d, dt, device=gen.device, kind=cfg.norm)}


def init_lm(gen: torch.Generator, cfg: ArchConfig):
    """Random parameters drawn from ``gen`` on ``gen.device``, with the JAX
    package's tree, shapes and scales (the numbers differ: the generators
    do): ``units`` a tuple of one stacked block per pattern position,
    zamba2's ``rem`` a list of its remainder blocks and its ``shared``
    block, deepseek's ``first_dense`` block, seamless's ``enc_units`` (one
    ``attn`` block stacked ``cfg.encoder_layers`` times) and ``enc_norm``;
    no ``head`` under ``cfg.tie_embeddings``."""
    _check_supported(cfg)
    dt, dev = _dtype(cfg), gen.device
    d, R, period = cfg.d_model, _unit_repeats(cfg), len(cfg.pattern)
    emb = torch.randn((cfg.vocab, d), generator=gen, device=dev,
                      dtype=torch.float32) * 0.02
    units = tuple(init_block(gen, cfg, kind, repeats=R)
                  for kind in cfg.pattern)
    params = {"emb": emb.to(dt),
              "final_norm": L.init_norm(d, dt, device=dev, kind=cfg.norm)}
    if not cfg.tie_embeddings:
        params["head"] = L.init_dense(gen, d, cfg.vocab, dt, scale=d ** -0.5)
    params["units"] = units
    rem = _zamba_remainder(cfg)
    if rem:
        params["rem"] = [init_block(gen, cfg, cfg.pattern[i % period])
                         for i in range(rem)]
    if "shared_attn" in cfg.pattern:
        params["shared"] = init_shared_block(gen, cfg)
    if cfg.moe_first_dense:
        params["first_dense"] = init_block(gen, cfg, cfg.pattern[0],
                                           first_dense=True)
    if cfg.encoder_layers:
        enc_cfg = dataclasses.replace(cfg, moe=None, parallel_block=False)
        params["enc_units"] = (init_block(gen, enc_cfg, "attn",
                                          repeats=cfg.encoder_layers),)
        params["enc_norm"] = L.init_norm(d, dt, device=dev, kind=cfg.norm)
    return params


class MetaGenerator(torch.Generator):
    """A CPU generator that reports the ``meta`` device, so that `init_lm`
    builds shape-only params (no storage, no draws)."""
    device = torch.device("meta")


def param_shapes(cfg: ArchConfig):
    """`init_lm`'s params as ``meta`` tensors: shapes and dtypes only."""
    return init_lm(MetaGenerator(), cfg)


def params_from_jax(tree, device="cuda"):
    """The JAX parameter pytree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's nested dict on
    ``device``.  bfloat16 leaves go through float32, since torch cannot
    read numpy's ``ml_dtypes`` bfloat16; their values are unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    dtype = str(tree.dtype)
    if dtype == "bfloat16":
        import numpy as np
        t = torch.from_numpy(np.asarray(tree, dtype=np.float32))
        return t.to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(tree.copy()).to(device)


def _repeat(tree, r: int):
    """Repeat ``r`` of a stacked subtree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _repeat(v, r) for k, v in tree.items()}
    return tree[r]


def block_apply(p, x, kind, cfg: ArchConfig, positions, *, cache=None,
                cache_index=None, shared=None, name=None, chunked=False,
                length_mask=None, pages=None, cross_kv=None):
    """One block of ``kind``; returns (x, cache, aux): ``aux`` is the MoE
    FFN's Switch load-balance loss (0.0 in a block without one), as in
    the JAX package.  ``name`` is the block's
    params path (``"units/3"``, ``"rem/0"``), threaded into every
    projection's backend call; the shared block's weights always use the
    fixed names ``"shared/attn"`` and ``"shared/ffn"`` (one copy, many
    call sites).

    ``attn`` / ``shared_attn``: pre-norm GQA + FFN (under
    ``cfg.parallel_block`` both read the one norm: ``x + attn + ffn``);
    ``pages`` (B, W)
    switches the attention KV to the paged pool, where ``length_mask`` (B,
    S) sends the writes of padding (and of masked slots) to the trash
    page.  Under ``cfg.moe`` an ``attn`` block's FFN is the MoE FFN on
    ``norm2`` (``norm1`` where the block has none), plus the dense
    residual FFN on the same normed input when the block has one
    (arctic).  ``mamba``, ``mlstm``, ``slstm``: a
    recurrent block whose new state is copied into ``cache`` in place;
    ``length_mask`` makes its masked steps identities on the state (the
    conv carry kept), on either KV layout.  ``mla``: MLA (latent cache,
    absorbed decode), then the MoE FFN with ``length_mask`` dropping
    masked tokens from dispatch, or the first dense layer's FFN.

    ``cross`` / ``dec``: cross-attention over ``cross_kv`` (the projected
    frontend or encoder memory, `_frontend_kv`), which attention uses as
    given and the cache's ``ck`` / ``cv`` receive rounded to bfloat16
    (prefill and chunks); without ``cross_kv`` attention reads the cached
    memory (decode), as in the JAX package.  ``cross`` adds
    ``tanh(gate) * attention``, then the FFN; ``dec`` runs GQA with the
    self-attention KV (``k`` / ``v``) first."""
    if kind in ("cross", "dec"):
        return _cross_block(p, x, kind, cfg, positions, cache=cache,
                            cache_index=cache_index, cross_kv=cross_kv,
                            name=name, chunked=chunked,
                            length_mask=length_mask, pages=pages)
    h = L.norm(p["norm1"], x, cfg.norm)
    if kind == "mla":
        ao, nc = A.mla(p["attn"], h, positions, _mla_cfg(cfg), cache=cache,
                       cache_index=cache_index, name=_j(name, "attn"),
                       chunked=chunked, pages=pages, write_mask=length_mask)
        x = x + ao
        h2 = L.norm(p["norm2"], x, cfg.norm)
        if "moe" in p:
            mo, ml = M.moe_ffn(p["moe"], h2, cfg.moe, name=_j(name, "moe"),
                               length_mask=length_mask)
            return x + mo, nc, ml["load_balance"]
        return x + L.ffn(p["ffn"], h2, cfg.act, _j(name, "ffn")), nc, 0.0
    if kind in _RECURRENT:
        key, fn, kcfg = _RECURRENT[kind]
        mo, ns = fn(p[key], h, kcfg(cfg), state=cache, name=_j(name, key),
                    length_mask=length_mask)
        if cache is not None:
            for leaf, new in ns.items():
                cache[leaf].copy_(settled(new))
        return x + mo, cache, 0.0
    if kind == "shared_attn":
        p, attn_name, ffn_name = shared, "shared/attn", "shared/ffn"
    elif kind == "attn":
        attn_name, ffn_name = _j(name, "attn"), _j(name, "ffn")
    else:
        raise ValueError(kind)
    ao, nc = A.gqa(p["attn"], h, positions, _attn_cfg(cfg), cache=cache,
                   cache_index=cache_index, name=attn_name, chunked=chunked,
                   pages=pages, write_mask=length_mask)
    if cfg.parallel_block and kind == "attn" and "ffn" in p:
        return x + ao + L.ffn(p["ffn"], h, cfg.act, ffn_name), nc, 0.0
    x = x + ao
    if "moe" in p:
        h2 = L.norm(p.get("norm2", p["norm1"]), x, cfg.norm)
        mo, ml = M.moe_ffn(p["moe"], h2, cfg.moe, name=_j(name, "moe"),
                           length_mask=length_mask)
        if "ffn" in p:      # arctic's dense residual beside the MoE
            mo = mo + L.ffn(p["ffn"], h2, cfg.act, ffn_name)
        return x + mo, nc, ml["load_balance"]
    if "ffn" in p:
        x = x + L.ffn(p["ffn"], L.norm(p["norm2"], x, cfg.norm), cfg.act,
                      ffn_name)
    return x, nc, 0.0


def _cross_memory(cache, cross_kv):
    """The cross-attention memory of one block: ``cross_kv`` when given,
    written into the cache's ``ck`` / ``cv`` rounded to bfloat16; else
    the cached memory."""
    if cache is None:
        return cross_kv
    if cross_kv is None:
        return cache["ck"], cache["cv"]
    cache["ck"].copy_(cross_kv[0])
    cache["cv"].copy_(cross_kv[1])
    return cross_kv


def _cross_block(p, x, kind, cfg: ArchConfig, positions, *, cache,
                 cache_index, cross_kv, name, chunked, length_mask, pages):
    """The ``cross`` and ``dec`` blocks of `block_apply`."""
    xcfg = _attn_cfg(cfg, cross=True)
    h = L.norm(p["norm1"], x, cfg.norm)
    if kind == "cross":
        ao, _ = A.gqa(p["attn"], h, positions, xcfg,
                      kv_override=_cross_memory(cache, cross_kv),
                      name=_j(name, "attn"))
        gate = torch.tanh(p["gate"])
        # JAX's promotion: a 0-d float32 gate times a bfloat16 planned
        # output is float32 (torch would keep the bfloat16)
        x = x + gate * ao.to(torch.promote_types(gate.dtype, ao.dtype))
    else:
        ao, _ = A.gqa(p["attn"], h, positions, _attn_cfg(cfg), cache=cache,
                      cache_index=cache_index, name=_j(name, "attn"),
                      chunked=chunked, pages=pages, write_mask=length_mask)
        x = x + ao
        xo, _ = A.gqa(p["xattn"], L.norm(p["normx"], x, cfg.norm), positions,
                      xcfg, kv_override=_cross_memory(cache, cross_kv),
                      name=_j(name, "xattn"))
        x = x + xo
    x = x + L.ffn(p["ffn"], L.norm(p["norm2"], x, cfg.norm), cfg.act,
                  _j(name, "ffn"))
    return x, cache, 0.0


def _frontend_kv(p_attn, cross_source, cfg: ArchConfig, name=None):
    """The frontend rows ``cross_source (B, T, d_model)`` projected by a
    cross-attention's ``wk`` / ``wv`` to (k, v) (B, T, KVH, hd), without
    rope."""
    B, T, _ = cross_source.shape
    KVH, hd = cfg.n_kv_heads, cfg.hd
    k = L.dense(p_attn["wk"], cross_source, _j(name, "wk"))
    v = L.dense(p_attn["wv"], cross_source, _j(name, "wv"))
    return (splittable(k, KVH).reshape(B, T, KVH, hd),
            splittable(v, KVH).reshape(B, T, KVH, hd))


def encode(params, cfg: ArchConfig, frames):
    """seamless's encoder: ``frames (B, T, d_model)`` -> the memory (B, T,
    d_model).  Each repeat of ``params["enc_units"]`` (one ``attn`` block
    stacked) runs under `_backend.scan_slot`, named ``enc_units/0/attn``
    and ``enc_units/0/ffn``: non-causal GQA with rope, then the FFN; then
    ``enc_norm``."""
    (blocks,) = params["enc_units"]
    acfg = _attn_cfg(cfg, causal=False)
    positions = torch.arange(frames.shape[1], device=frames.device)[None, :]
    x = frames
    for r in range(blocks["norm1"]["scale"].shape[0]):
        blk = _repeat(blocks, r)
        with _backend.scan_slot(r):
            ao, _ = A.gqa(blk["attn"], L.norm(blk["norm1"], x, cfg.norm),
                          positions, acfg, name="enc_units/0/attn")
            x = x + ao
            x = x + L.ffn(blk["ffn"], L.norm(blk["norm2"], x, cfg.norm),
                          cfg.act, "enc_units/0/ffn")
    return L.norm(params["enc_norm"], x, cfg.norm)


def backbone(params, cfg: ArchConfig, x, positions, *, caches=None,
             cache_index=None, chunked=False, length_mask=None, pages=None,
             cross_source=None, remat=False):
    """Run all layers; returns (final-normed hidden, caches, aux), ``aux``
    the sum of the blocks' MoE load-balance losses (JAX's order).
    deepseek's ``first_dense`` block first (unstacked, outside any
    repeat), then the pattern's blocks once per repeat under
    `_backend.scan_slot`, then zamba2's remainder blocks (``rem/{i}``).
    ``chunked``: attention through `attention.chunked_attention` (long
    prefill); ``length_mask`` / ``pages``: see `block_apply`.
    ``cross_source`` (B, T, d_model): the frontend rows or encoder
    memory, projected per ``cross`` / ``dec`` block and repeat
    (`_frontend_kv`, named ``units/{i}/attn`` or ``units/{i}/xattn``);
    None reads the cached memory.  ``remat``: each repeat's blocks are
    recomputed in the backward pass instead of keeping their activations
    (``torch.utils.checkpoint``; the JAX package's ``jax.checkpoint`` of
    its scan body)."""
    # the embedding gather leaves DTensor rows sharded as the table's
    # columns: lay them out as every repeat's output is
    x = constrain(x, "act")
    units, shared = params["units"], params.get("shared")
    unit_caches = caches["units"] if caches is not None else None
    repeats = units[0]["norm1"]["scale"].shape[0]
    kw = dict(cache_index=cache_index, shared=shared, chunked=chunked,
              length_mask=length_mask, pages=pages)
    aux = 0.0
    if "first_dense" in params:
        c = caches["first"] if caches is not None else None
        x, _, aux = block_apply(params["first_dense"], x, cfg.pattern[0],
                                cfg, positions, cache=c, name="first_dense",
                                **kw)

    def unit(r, x, aux):
        # stacked layers are named by their base path ("units/0/attn/wq");
        # a name-keyed backend selects repeat r's prepared kernels
        with _backend.scan_slot(r):
            for i, kind in enumerate(cfg.pattern):
                c = (_repeat(unit_caches[i], r) if unit_caches is not None
                     else None)
                blk, ckv = _repeat(units[i], r), None
                if kind in ("cross", "dec") and cross_source is not None:
                    sub = "attn" if kind == "cross" else "xattn"
                    ckv = _frontend_kv(blk[sub], cross_source, cfg,
                                       name=f"units/{i}/{sub}")
                x, _, a = block_apply(blk, x, kind, cfg, positions, cache=c,
                                      name=f"units/{i}", cross_kv=ckv, **kw)
                aux = aux + a
        return constrain(x, "act"), aux

    for r in range(repeats):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                unit, r, x, aux, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, aux = unit(r, x, aux)
    for i, blk in enumerate(params.get("rem", ())):
        c = caches["rem"][i] if caches is not None else None
        x, _, a = block_apply(blk, x, cfg.pattern[i % len(cfg.pattern)], cfg,
                              positions, cache=c, name=f"rem/{i}", **kw)
        aux = aux + a
    return L.norm(params["final_norm"], x, cfg.norm), caches, aux


def _head_weight(params, cfg: ArchConfig):
    """The vocab projection's (d_model, vocab) weight: ``emb.T`` for a
    tied head, the dequantized codes of an int8 serving head, else the
    head's ``w``."""
    if cfg.tie_embeddings:
        return params["emb"].T
    h = params["head"]
    if "w_q" in h:
        dt = params["emb"].dtype
        return h["w_q"].to(dt) * h["w_s"].to(dt)[..., None, :]
    return h["w"]


def _project_logits(params, cfg: ArchConfig, h):
    """Vocab projection, routed through the matmul backend when one is
    installed (planned execution of the head).  A planned head quantizes
    ``h`` to int8, which maps NaN to a finite code: rows of ``h`` that are
    not finite give NaN logits, so that the engine's screen sees a
    corrupted KV page under a planned backend too.  A tied head is ``h @
    emb.T`` in the activation dtype, never planned (as in the JAX
    package)."""
    if cfg.tie_embeddings:
        return L.matmul(h, params["emb"].T).to(torch.float32)
    be = _backend.current()
    if be is not None:
        y = be("head", params["head"], h)
        if y is not None:
            finite = torch.isfinite(h).all(dim=-1, keepdim=True)
            return torch.where(finite, y.to(torch.float32), float("nan"))
    return L.matmul(h, _head_weight(params, cfg)).to(torch.float32)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped dict / tuple / list
    trees."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of a dict / tuple / list tree, in `_tree_map` order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _block_cache_spec(cfg: ArchConfig, kind: str, B: int, S_max: int):
    """``{key: (shape, dtype)}`` of one block's cache.  The attention KV
    holds int8 codes when ``cfg.kv_cache_dtype == "int8"``, else bfloat16
    (whatever the parameter dtype, as in the JAX package).  The Mamba2
    and mLSTM conv carries hold activations: the parameter dtype, whatever
    the KV dtype (the JAX package gives them the KV dtype; the port writes
    state in place, where an int8 buffer would truncate it every step).
    The cross-attention memory ``ck`` / ``cv`` (B, frontend_tokens, KVH,
    hd) is bfloat16 whatever the KV dtype: what the JAX package's blocks
    store (its spec gives them the KV dtype, and its dense engine then
    truncates them into an int8 pool)."""
    kv = torch.int8 if cfg.kv_cache_dtype == "int8" else torch.bfloat16
    memory = (B, cfg.frontend_tokens, cfg.n_kv_heads, cfg.hd)
    if kind in ("attn", "dec", "shared_attn"):
        shape = (B, S_max, cfg.n_kv_heads, cfg.hd)
        spec = {"k": (shape, kv), "v": (shape, kv)}
        if kind == "dec":
            spec.update(ck=(memory, torch.bfloat16),
                        cv=(memory, torch.bfloat16))
        return spec
    if kind == "cross":
        return {"ck": (memory, torch.bfloat16), "cv": (memory, torch.bfloat16)}
    if kind == "mla":
        m = cfg.mla
        return {"latent": ((B, S_max, m.kv_lora_rank + m.qk_rope_dim), kv)}
    if kind == "mamba":
        mc = _mamba_cfg(cfg)
        return {"ssm": ((B, mc.n_heads, mc.head_dim, mc.d_state),
                        torch.float32),
                "conv": ((B, mc.conv_kernel - 1, mc.conv_dim), _dtype(cfg))}
    if kind in ("mlstm", "slstm"):
        xc, f32 = _xlstm_cfg(cfg), torch.float32
        H, hd = xc.n_heads, xc.head_dim
        if kind == "mlstm":
            return {"C": ((B, H, hd, hd), f32), "n": ((B, H, hd), f32),
                    "m": ((B, H), f32),
                    "conv": ((B, xc.conv_kernel - 1, xc.d_inner),
                             _dtype(cfg))}
        return {"c": ((B, H, hd), f32), "n": ((B, H, hd), f32),
                "h": ((B, H, hd), f32), "m": ((B, H), f32)}
    raise ValueError(kind)


def _assemble_caches(cfg: ArchConfig, block_fn, stacked, plain):
    """The layout walk shared by every cache-shaped tree (the JAX
    package's): ``block_fn(kind)`` gives one block's ``{key: spec}``;
    ``stacked(spec, repeats)`` builds a ``"units"`` leaf, ``plain(spec)``
    a ``"rem"`` or ``"first"`` one."""
    _check_supported(cfg)
    period, R = len(cfg.pattern), _unit_repeats(cfg)
    caches = {"units": tuple(
        {key: stacked(sp, R) for key, sp in block_fn(kind).items()}
        for kind in cfg.pattern)}
    rem = _zamba_remainder(cfg)
    if rem:
        caches["rem"] = [{key: plain(sp) for key, sp in
                          block_fn(cfg.pattern[i % period]).items()}
                         for i in range(rem)]
    if cfg.moe_first_dense:
        caches["first"] = {key: plain(sp) for key, sp in
                           block_fn(cfg.pattern[0]).items()}
    return caches


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def cache_specs(cfg: ArchConfig, B: int, S_max: int):
    """The dense cache's shapes and dtypes (`_block_cache_spec`), as a tree
    of ``meta`` tensors (no storage): the JAX package's tree, ``"units"``
    leaves stacked on a leading repeats axis."""
    return _assemble_caches(
        cfg, lambda kind: _block_cache_spec(cfg, kind, B, S_max),
        stacked=lambda sp, r: _meta((r,) + sp[0], sp[1]),
        plain=lambda sp: _meta(*sp))


def _zeros_like_specs(specs, device):
    return _tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                           device=device), specs)


def init_cache(cfg: ArchConfig, B: int, S_max: int, device="cuda"):
    """Dense cache of `cache_specs`, zeroed."""
    return _zeros_like_specs(cache_specs(cfg, B, S_max), device)


# Sequence-indexed attention-KV leaves: the ones the paged layout moves
# from per-slot (B, S_max, ...) buffers into the shared page pool (the JAX
# package's sets); every other leaf is per-slot state, slot-indexed in
# both layouts
_PAGED_KEYS = frozenset({"k", "v", "latent"})
_SEQ_KINDS = frozenset({"attn", "dec", "shared_attn", "mla"})


def _paged_block_cache_spec(cfg: ArchConfig, kind: str, B: int,
                            pool_rows: int, page_size: int):
    spec = _block_cache_spec(cfg, kind, B, 1)
    if kind in _SEQ_KINDS:
        for key, ((_, _, *feat), dt) in list(spec.items()):
            if key in _PAGED_KEYS:
                spec[key] = ((pool_rows, page_size, *feat), dt)
    return spec


def paged_cache_specs(cfg: ArchConfig, B: int, pool_rows: int,
                      page_size: int):
    """The PAGED layout's cache as ``meta`` tensors: each attention-KV
    leaf is the shared ``(R, pool_rows, page_size, KVH, hd)`` page pool
    (``pool_rows`` includes the trash row 0: pass num_pages + 1); per-slot
    state keeps its dense shape with B slots.  The tree of
    `cache_specs`."""
    return _assemble_caches(
        cfg, lambda kind: _paged_block_cache_spec(cfg, kind, B, pool_rows,
                                                  page_size),
        stacked=lambda sp, r: _meta((r,) + tuple(sp[0]), sp[1]),
        plain=lambda sp: _meta(tuple(sp[0]), sp[1]))


def init_paged_cache(cfg: ArchConfig, B: int, pool_rows: int,
                     page_size: int, device="cuda"):
    """Paged cache of `paged_cache_specs`, zeroed."""
    return _zeros_like_specs(
        paged_cache_specs(cfg, B, pool_rows, page_size), device)


def cache_kv_axes(cfg: ArchConfig):
    """Marker tree (the structure of `cache_specs` / `paged_cache_specs`):
    ``"page"`` for sequence-indexed attention-KV leaves, ``"slot"`` for
    per-slot state, with the count of leading stack axes appended
    (``"page1"``: a KV leaf whose pool / batch axis is axis 1 under the
    stacked repeats; ``"slot0"``: a remainder block's state, slots on
    axis 0).  The engine's slot reset, page copy, snapshot and KV-byte
    accounting address leaves of either layout through it."""
    def roles(kind):
        return {key: ("page" if kind in _SEQ_KINDS and key in _PAGED_KEYS
                      else "slot")
                for key in _block_cache_spec(cfg, kind, 1, 1)}
    return _assemble_caches(cfg, roles, stacked=lambda role, r: role + "1",
                            plain=lambda role: role + "0")


def copy_pages(caches, src, dst, kv_axes):
    """Copy-on-write: page rows ``src`` (k,) of every ``"page"`` leaf of
    ``kv_axes`` (`cache_kv_axes`) into rows ``dst`` (k,), in place
    (``pool[:, dst] = pool[:, src]``); per-slot state is left alone.
    ``src`` and ``dst`` are int64 tensors on the caches' device.  Returns
    ``caches``."""
    for buf, ax in zip(tree_leaves(caches), tree_leaves(kv_axes)):
        if ax.startswith("page"):
            axis = int(ax[4:])
            buf.index_copy_(axis, dst, buf.index_select(axis, src))
    return caches


def cache_batch_axes(caches):
    """Tree (matching ``caches``) of each leaf's BATCH axis: the
    ``"units"`` leaves are stacked with a leading repeats axis, so batch
    is axis 1; ``"rem"`` and ``"first"`` leaves carry batch first.  This
    is the layout knowledge `scatter_cache` needs to address slots."""
    axes = {"units": _tree_map(lambda _: 1, caches["units"])}
    for key in ("rem", "first"):
        if key in caches:
            axes[key] = _tree_map(lambda _: 0, caches[key])
    return axes


def scatter_cache(caches, sub, slots):
    """Write the first k rows of the cache ``sub`` into the B-slot pool
    ``caches`` at slot indices ``slots`` (k,) int64 on the caches' device,
    in place (``index_copy_`` along each leaf's batch axis) — the
    continuous-batching admission step: freshly prefilled per-request
    caches (KV and recurrent state) land in the slots the scheduler
    assigned, replacing whatever a retired request left there.  Rows of
    ``sub`` past k (the padding rows of an admission group) are not
    written, and ``slots`` must not repeat a slot: which of two writes to
    one slot lands is undefined on the card.  Returns ``caches``."""
    k = slots.numel()
    _tree_map(lambda buf, s, axis: buf.index_copy_(
        axis, slots, s.narrow(axis, 0, k).to(buf.dtype)),
        caches, sub, cache_batch_axes(caches))
    return caches


#: prompts longer than this many tokens prefill through the chunked
#: attention (the JAX package's ``_prefill_body``: ``chunked=Sq > 2048``)
CHUNKED_ABOVE = 2048


def _cross_source(params, cfg: ArchConfig, cross_source):
    """The memory the ``cross`` / ``dec`` blocks attend: the frontend rows
    themselves (vision), or the encoder's output over them (audio)."""
    if cfg.frontend == "audio" and cross_source is not None:
        return encode(params, cfg, cross_source)
    return cross_source


def prefill(params, cfg: ArchConfig, tokens, caches, lengths=None,
            variant=None, cross_source=None):
    """Process the prompts ``tokens (B, S)``, fill the caches, and return
    (logits at each row's last valid position, caches).  ``lengths`` (B,)
    marks right-padded prompts: recurrent state suppresses the padded tail
    exactly (``length_mask``), and KV written at padded positions is
    masked by every later read.  Prompts longer than 2048 tokens take the
    chunked attention (see the module docstring).  ``variant`` selects the
    plan variant of a multi-plan backend (`repro_torch.runtime.PlanSet`)
    for this call; None keeps any surrounding ``plan_variant`` selection
    or the backend's default.  ``cross_source`` (B, T, d_model): each
    row's frontend embeddings (vision: attended as they are; audio: run
    through `encode` first)."""
    with _backend.plan_variant(variant):
        B, Sq = tokens.shape
        x = L.embed(params["emb"], tokens)
        steps = torch.arange(Sq, device=tokens.device)[None, :]
        length_mask = None
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=tokens.device)
            length_mask = steps < lengths[:, None]
        h, caches, _ = backbone(
            params, cfg, x, steps, caches=caches, cache_index=0,
            chunked=Sq > CHUNKED_ABOVE, length_mask=length_mask,
            cross_source=_cross_source(params, cfg, cross_source))
        if lengths is None:
            h_last = h[:, -1]
        else:
            h_last = h[torch.arange(B, device=h.device), lengths - 1]
        return _project_logits(params, cfg, h_last), caches


def prefill_chunk(params, cfg: ArchConfig, tokens, caches, index, valid,
                  pages, variant=None, full_logits: bool = False,
                  cross_source=None):
    """One fixed-size chunk of a paged CHUNKED prefill.

    ``tokens`` (B, C) holds the next (up to C) prompt tokens of every
    prefilling slot, left-aligned; ``index`` (B,) is each slot's prefill
    progress (tokens already in its pages) and ``valid`` (B,) how many of
    this chunk's tokens are real -- 0 for slots that are decoding or idle,
    whose rows are fully masked: their KV writes land in the trash page
    and their recurrent state carries through bit for bit, so interleaving
    chunks with decode steps cannot perturb other slots.  Recurrent state
    accumulated in ``caches`` across calls is the carried chunk boundary.
    ``pages`` (B, W) is the page table.  Attention is `full_attention`
    with per-slot ``q_pos0`` / ``kv_len`` over each slot's gathered pages,
    never the chunked (flash) path, as in the JAX package.  Every row runs
    through the projections (M = B * C), so with dynamic activation scales
    a slot's numbers depend on its neighbours.  Returns (logits at each
    slot's last valid token -- the slot's first generated token once its
    whole prompt is in, garbage before that -- and the caches).

    ``variant`` selects the plan variant (see `prefill`).
    ``full_logits=True`` returns the logits at EVERY chunk position (B, C,
    V) instead: the speculative verify step reads the target variant's
    prediction after each drafted token from one chunk call (rows past
    ``valid`` are garbage by the same masking contract).
    ``cross_source`` (B, T, d_model): every slot's frontend rows (see
    `prefill`); the memory they give is rewritten into every slot's
    ``ck`` / ``cv`` at each chunk, as in the JAX package (so an audio
    arch runs its encoder over all B slots' rows at every chunk)."""
    with _backend.plan_variant(variant):
        B, C = tokens.shape
        dev = tokens.device
        x = L.embed(params["emb"], tokens)
        steps = torch.arange(C, device=dev)[None, :]
        positions = index[:, None] + steps
        length_mask = steps < valid[:, None]
        h, caches, _ = backbone(
            params, cfg, x, positions, caches=caches, cache_index=index,
            length_mask=length_mask, pages=pages,
            cross_source=_cross_source(params, cfg, cross_source))
        if full_logits:
            return _project_logits(params, cfg, h), caches
        last = torch.clamp(valid - 1, 0, C - 1)
        h_last = h[torch.arange(B, device=dev), last]
        return _project_logits(params, cfg, h_last), caches


def decode_step(params, cfg: ArchConfig, token, caches, index, active=None,
                pages=None, variant=None):
    """One decode step for ``token (B,)`` at position ``index``: an int
    (same-length batch) or a (B,) tensor of per-slot cache lengths.
    ``active`` (B,) bool marks live slots; the logits of an inactive slot
    are garbage by contract, and on either layout their recurrent state
    carries through unchanged.  With ``pages`` (B, W) the KV lives in the
    paged pool and ``active`` is also the write mask: inactive and
    still-prefilling slots write into the trash page, whatever their
    ``index``; on the dense cache an inactive slot writes its KV at its
    ``index``.  ``variant`` selects the plan variant (see `prefill`).
    The cross-attention memory is read from the caches (written at
    prefill), never from a frontend."""
    with _backend.plan_variant(variant):
        x = L.embed(params["emb"], token)[:, None, :]
        B = x.shape[0]
        if isinstance(index, torch.Tensor) and index.dim() == 1:
            positions = index[:, None]
        else:
            positions = torch.full((B, 1), int(index), device=x.device)
        length_mask = None if active is None else active[:, None]
        h, caches, _ = backbone(params, cfg, x, positions, caches=caches,
                                cache_index=index, length_mask=length_mask,
                                pages=pages)
        return _project_logits(params, cfg, h[:, -1]), caches


# ---------------------------------------------------------------- training

def _ce_chunk(hb, w, tb):
    """Summed next-token cross-entropy of one sequence chunk."""
    logp = torch.log_softmax(L.matmul(hb, w).to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, tb[..., None])[..., 0].sum()


def chunked_ce(h, w, targets, chunk=512):
    """Mean cross-entropy with the vocab projection computed per sequence
    chunk of ``min(chunk, S)`` positions, each chunk recomputed in the
    backward pass, so no (B, S, V) logits are kept.  As in the JAX
    package, positions past the last whole chunk are left out."""
    B, Sq, _ = h.shape
    chunk = min(chunk, Sq)
    n = Sq // chunk
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, n * chunk, chunk):
        tot = tot + torch.utils.checkpoint.checkpoint(
            _ce_chunk, h[:, c0:c0 + chunk], w, targets[:, c0:c0 + chunk],
            use_reentrant=False, preserve_rng_state=False)
    return tot / (B * n * chunk)


def lm_loss(params, cfg: ArchConfig, batch, remat=False):
    """``batch``: {"tokens", "targets" (B, S)[, "frontend"]} -> the scalar
    training loss: `chunked_ce` of the final hidden states plus 0.01 x the
    MoE load-balance aux.  A vision frontend's rows are attended as given,
    an audio one's through `encode`; a sequence longer than 2048 tokens
    takes the chunked attention, as in the JAX package.  On the card that
    is the flash kernel, which has no backward pass: with gradients
    enabled such a sequence raises NotImplementedError there."""
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    chunked = Sq > CHUNKED_ABOVE
    if chunked and tokens.device.type == "cuda" and torch.is_grad_enabled():
        raise NotImplementedError(
            f"lm_loss at {Sq} > {CHUNKED_ABOVE} tokens on the card: the "
            f"chunked attention there is the flash-attention kernel, which "
            f"has no backward pass yet (a flash backward kernel is new "
            f"work: the JAX package differentiates its jnp chunked "
            f"attention and has no Pallas backward)")
    x = L.embed(params["emb"], tokens)
    positions = torch.arange(Sq, device=tokens.device)[None, :]
    cross_source = None
    if cfg.frontend == "vision":
        cross_source = batch["frontend"]
    elif cfg.frontend == "audio":
        cross_source = encode(params, cfg, batch["frontend"])
    h, _, aux = backbone(params, cfg, x, positions, chunked=chunked,
                         cross_source=cross_source, remat=remat)
    loss = chunked_ce(h, _head_weight(params, cfg), batch["targets"])
    return loss + 0.01 * aux


# ------------------------------------------------- serve-time quantization

def quantize_for_serve(params, cfg: ArchConfig):
    """Under ``cfg.serve_weight_dtype == "int8"``, replace every projection
    weight (a ``{"w"}`` of two or more dims) by int8 codes ``w_q`` and
    float32 per-output-channel scales ``w_s`` (stacked weights ``(R, in,
    out)`` keep their leading axes: ``w_s`` is ``(*lead, out)``), with the
    JAX package's arithmetic: ``s = max(max |w|, 1e-8) / 127`` over the
    input axis, ``w_q = clip(round(w / s), -127, 127)``.  The embedding
    (and so a tied head), norms and the MoE experts' raw tensors stay as
    they are; the embedding is put last, as the JAX package does.  Works
    on concrete params and on ``meta`` params alike (the dry run's): the
    same ops give ``meta`` codes and scales.  Any other config returns
    ``params`` unchanged."""
    if cfg.serve_weight_dtype != "int8":
        return params
    f32 = torch.float32

    def walk(node):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.dim() >= 2:
                rest = {k: walk(v) for k, v in node.items() if k != "w"}
                s = torch.clamp_min(torch.amax(torch.abs(w.to(f32)), dim=-2),
                                    1e-8) / 127.0
                rest["w_q"] = torch.clamp(torch.round(w.to(f32) /
                                                      s[..., None, :]),
                                          -127, 127).to(torch.int8)
                rest["w_s"] = s
                return rest
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    # keep the embedding (and a tied head) as it is: vocab-gather accuracy
    out = walk({k: v for k, v in params.items() if k != "emb"})
    out["emb"] = params["emb"]
    return out
