"""Config-driven LM assembly (``repro.models.transformer`` counterpart) for
the attention-only ``("attn",)`` pattern.

Params are the JAX package's pytree as a nested dict of tensors: the
layers are ``pattern_repeats`` repeats of the block pattern, stacked on a
leading repeat axis R (``params["units"][0]["attn"]["wq"]["w"]`` is
``(R, d_model, H * hd)``), so a mapping artifact's layer names
(``units/0/attn/wq@r``) address the same weights in both packages.  Where
the JAX package runs ``jax.lax.scan`` over the repeats, `backbone` loops in
Python and publishes the repeat index with `_backend.scan_slot`.

Public API:
  init_lm(gen, cfg)                              -> params (on gen.device)
  params_from_jax(tree, device)                  -> params
  prefill(params, cfg, tokens, caches, lengths=, variant=)
                                                 -> (last_logits, caches)
  prefill_chunk(params, cfg, tokens, caches, index, valid, pages,
                variant=, full_logits=)          -> (logits, caches)
  decode_step(params, cfg, token, caches, index, active=, pages=,
              variant=)                          -> (logits, caches)
  cache_specs(cfg, B, S_max)                     -> tree of meta tensors
  init_cache(cfg, B, S_max, device)              -> caches
  paged_cache_specs(cfg, B, pool_rows, page_size)-> tree of meta tensors
  init_paged_cache(cfg, B, pool_rows, page_size, device) -> caches
  cache_kv_axes(cfg)                             -> layout marker per leaf
  cache_batch_axes(caches)                       -> batch axis per leaf
  scatter_cache(caches, sub, slots)              -> caches (in place)
  copy_pages(caches, src, dst)                   -> caches (in place)

Caches are updated in place (see `repro_torch.models.attention`).  A
prompt longer than 2048 tokens prefills through the chunked (flash)
attention, as the JAX package's ``_prefill_body`` does; like the JAX
package's, that path needs a cache length that is a multiple of
``min(1024, S_max)`` and a prompt length that is a multiple of
``min(512, S)``.  Hybrid, MoE, MLA, cross-attention and encoder-decoder
archs wait for later slices.  The dense serving engine
(`repro_torch.serving.Engine(kv_layout="dense")`) prefills admission
groups with ``prefill(lengths=)``, moves them into its slot pool with
`scatter_cache` and decodes all slots with a per-slot ``index``; the paged
one streams prompts into its page pool with `prefill_chunk` (full
attention over each slot's gathered pages, never the chunked path, as in
the JAX package) and decodes with ``decode_step(pages=)``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import _backend
from repro_torch.models import attention as A
from repro_torch.models import layers as L

_j = _backend.join


def _check_supported(cfg: ArchConfig):
    if (cfg.pattern != ("attn",) or cfg.moe is not None or cfg.mla
            or cfg.frontend or cfg.encoder_layers or cfg.parallel_block
            or cfg.tie_embeddings or cfg.norm != "rmsnorm"):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense attention-only ('attn',) "
            f"archs; the other families wait for later slices")


def _attn_cfg(cfg: ArchConfig) -> A.AttnConfig:
    return A.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window)


def _dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def init_lm(gen: torch.Generator, cfg: ArchConfig):
    """Random parameters drawn from ``gen`` on ``gen.device``, with the JAX
    package's shapes and scales (the numbers differ: the generators do)."""
    _check_supported(cfg)
    dt, dev = _dtype(cfg), gen.device
    d, R = cfg.d_model, cfg.pattern_repeats
    emb = torch.randn((cfg.vocab, d), generator=gen, device=dev,
                      dtype=torch.float32) * 0.02
    block = {"norm1": L.init_norm(d, dt, repeats=R, device=dev),
             "attn": A.init_attn(gen, _attn_cfg(cfg), dt, repeats=R)}
    if cfg.d_ff:
        block["ffn"] = L.init_ffn(gen, d, cfg.d_ff, cfg.gated_ffn, dt,
                                  repeats=R)
        block["norm2"] = L.init_norm(d, dt, repeats=R, device=dev)
    return {
        "emb": emb.to(dt),
        "final_norm": L.init_norm(d, dt, device=dev),
        "head": L.init_dense(gen, d, cfg.vocab, dt, scale=d ** -0.5),
        "units": (block,),
    }


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


def block_apply(p, x, cfg: ArchConfig, positions, *, cache=None,
                cache_index=None, name=None, chunked=False, length_mask=None,
                pages=None):
    """One ``attn`` block (pre-norm GQA + FFN). Returns (x, cache).
    ``pages`` (B, W) switches the attention KV to the paged pool, where
    ``length_mask`` (B, S) sends the writes of padding (and of masked
    slots) to the trash page."""
    h = L.norm(p["norm1"], x, cfg.norm)
    ao, nc = A.gqa(p["attn"], h, positions, _attn_cfg(cfg), cache=cache,
                   cache_index=cache_index, name=_j(name, "attn"),
                   chunked=chunked, pages=pages, write_mask=length_mask)
    x = x + ao
    if "ffn" in p:
        x = x + L.ffn(p["ffn"], L.norm(p["norm2"], x, cfg.norm), cfg.act,
                      _j(name, "ffn"))
    return x, nc


def backbone(params, cfg: ArchConfig, x, positions, *, caches=None,
             cache_index=None, chunked=False, length_mask=None, pages=None):
    """Run all layers; returns (final-normed hidden, caches).  ``chunked``:
    attention through `attention.chunked_attention` (long prefill);
    ``length_mask`` / ``pages``: see `block_apply`."""
    (units,) = params["units"]
    unit_cache = caches["units"][0] if caches is not None else None
    repeats = units["norm1"]["scale"].shape[0]
    for r in range(repeats):
        c = _repeat(unit_cache, r) if unit_cache is not None else None
        # stacked layers are named by their base path ("units/0/attn/wq");
        # a name-keyed backend selects repeat r's prepared kernels
        with _backend.scan_slot(r):
            x, _ = block_apply(_repeat(units, r), x, cfg, positions,
                               cache=c, cache_index=cache_index,
                               name="units/0", chunked=chunked,
                               length_mask=length_mask, pages=pages)
    return L.norm(params["final_norm"], x, cfg.norm), caches


def _project_logits(params, cfg: ArchConfig, h):
    """Vocab projection, routed through the matmul backend when one is
    installed (planned execution of the head).  A planned head quantizes
    ``h`` to int8, which maps NaN to a finite code: rows of ``h`` that are
    not finite give NaN logits, so that the engine's screen sees a
    corrupted KV page under a planned backend too."""
    be = _backend.current()
    if be is not None:
        y = be("head", params["head"], h)
        if y is not None:
            finite = torch.isfinite(h).all(dim=-1, keepdim=True)
            return torch.where(finite, y.to(torch.float32), float("nan"))
    return L.matmul(h, params["head"]["w"]).to(torch.float32)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped dict / tuple trees."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def cache_specs(cfg: ArchConfig, B: int, S_max: int):
    """The dense KV cache's shapes and dtypes, as a tree of ``meta``
    tensors (no storage): int8 codes when ``cfg.kv_cache_dtype ==
    "int8"``, else bfloat16 (whatever the parameter dtype, as in the JAX
    package)."""
    _check_supported(cfg)
    dt = torch.int8 if cfg.kv_cache_dtype == "int8" else torch.bfloat16
    shape = (cfg.pattern_repeats, B, S_max, cfg.n_kv_heads, cfg.hd)
    return {"units": ({"k": torch.empty(shape, dtype=dt, device="meta"),
                       "v": torch.empty(shape, dtype=dt, device="meta")},)}


def init_cache(cfg: ArchConfig, B: int, S_max: int, device="cuda"):
    """Dense KV cache of `cache_specs`, zeroed."""
    return _tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                           device=device),
                     cache_specs(cfg, B, S_max))


# Sequence-indexed attention-KV leaves: the ones the paged layout moves
# from per-slot (B, S_max, ...) buffers into the shared page pool (the JAX
# package's sets; the port's one kind, "attn", has only "k" and "v")
_PAGED_KEYS = frozenset({"k", "v", "latent"})
_SEQ_KINDS = frozenset({"attn", "dec", "shared_attn", "mla"})


def paged_cache_specs(cfg: ArchConfig, B: int, pool_rows: int,
                      page_size: int):
    """The PAGED layout's cache: each attention-KV leaf is the shared
    ``(R, pool_rows, page_size, KVH, hd)`` page pool (``pool_rows``
    includes the trash row 0: pass num_pages + 1), as a tree of ``meta``
    tensors with the dtypes of `cache_specs`.  ``B`` is kept for the JAX
    package's signature: an attention-only arch has no per-slot state."""
    _check_supported(cfg)
    dt = torch.int8 if cfg.kv_cache_dtype == "int8" else torch.bfloat16
    shape = (cfg.pattern_repeats, pool_rows, page_size, cfg.n_kv_heads,
             cfg.hd)
    return {"units": ({key: torch.empty(shape, dtype=dt, device="meta")
                       for key in ("k", "v")},)}


def init_paged_cache(cfg: ArchConfig, B: int, pool_rows: int,
                     page_size: int, device="cuda"):
    """Paged KV pool of `paged_cache_specs`, zeroed."""
    return _tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                           device=device),
                     paged_cache_specs(cfg, B, pool_rows, page_size))


def cache_kv_axes(cfg: ArchConfig):
    """Marker tree (the structure of `cache_specs` / `paged_cache_specs`):
    ``"page"`` for sequence-indexed attention-KV leaves, ``"slot"`` for
    per-slot state, with the count of leading stack axes appended
    (``"page1"``: a KV leaf whose pool / batch axis is axis 1 under the
    stacked repeats).  The engine's page copy and its KV-byte accounting
    address leaves of either layout through it."""
    _check_supported(cfg)
    (kind,) = cfg.pattern
    return {"units": ({key: ("page" if kind in _SEQ_KINDS and
                             key in _PAGED_KEYS else "slot") + "1"
                       for key in ("k", "v")},)}


def copy_pages(caches, src, dst):
    """Copy-on-write: page rows ``src`` (k,) of every page leaf into rows
    ``dst`` (k,), in place (``pool[:, dst] = pool[:, src]``); ``src`` and
    ``dst`` are int64 tensors on the caches' device.  Returns ``caches``."""
    _tree_map(lambda buf: buf.index_copy_(1, dst, buf.index_select(1, src)),
              caches)
    return caches


def cache_batch_axes(caches):
    """Tree (matching ``caches``) of each leaf's BATCH axis: the
    ``"units"`` leaves are stacked with a leading repeats axis, so batch
    is axis 1.  This is the layout knowledge `scatter_cache` needs to
    address slots."""
    return {"units": _tree_map(lambda _: 1, caches["units"])}


def scatter_cache(caches, sub, slots):
    """Write the first k rows of the cache ``sub`` into the B-slot pool
    ``caches`` at slot indices ``slots`` (k,) int64 on the caches' device,
    in place (``index_copy_`` along each leaf's batch axis) — the
    continuous-batching admission step: freshly prefilled per-request
    caches land in the slots the scheduler assigned, replacing whatever a
    retired request left there.  Rows of ``sub`` past k (the padding rows
    of an admission group) are not written, and ``slots`` must not repeat
    a slot: which of two writes to one slot lands is undefined on the
    card.  Returns ``caches``."""
    k = slots.numel()
    _tree_map(lambda buf, s, axis: buf.index_copy_(
        axis, slots, s.narrow(axis, 0, k).to(buf.dtype)),
        caches, sub, cache_batch_axes(caches))
    return caches


#: prompts longer than this many tokens prefill through the chunked
#: attention (the JAX package's ``_prefill_body``: ``chunked=Sq > 2048``)
CHUNKED_ABOVE = 2048


def prefill(params, cfg: ArchConfig, tokens, caches, lengths=None,
            variant=None):
    """Process the prompts ``tokens (B, S)``, fill the caches, and return
    (logits at each row's last valid position, caches).  ``lengths`` (B,)
    marks right-padded prompts; KV written at padded positions is masked by
    every later read.  Prompts longer than 2048 tokens take the chunked
    attention (see the module docstring).  ``variant`` selects the plan
    variant of a multi-plan backend (`repro_torch.runtime.PlanSet`) for
    this call; None keeps any surrounding ``plan_variant`` selection or
    the backend's default."""
    with _backend.plan_variant(variant):
        B, Sq = tokens.shape
        x = params["emb"][tokens]
        positions = torch.arange(Sq, device=tokens.device)[None, :]
        h, caches = backbone(params, cfg, x, positions, caches=caches,
                             cache_index=0, chunked=Sq > CHUNKED_ABOVE)
        if lengths is None:
            h_last = h[:, -1]
        else:
            last = torch.as_tensor(lengths, device=h.device) - 1
            h_last = h[torch.arange(B, device=h.device), last]
        return _project_logits(params, cfg, h_last), caches


def prefill_chunk(params, cfg: ArchConfig, tokens, caches, index, valid,
                  pages, variant=None, full_logits: bool = False):
    """One fixed-size chunk of a paged CHUNKED prefill.

    ``tokens`` (B, C) holds the next (up to C) prompt tokens of every
    prefilling slot, left-aligned; ``index`` (B,) is each slot's prefill
    progress (tokens already in its pages) and ``valid`` (B,) how many of
    this chunk's tokens are real -- 0 for slots that are decoding or idle,
    whose rows are fully masked: their KV writes land in the trash page,
    so interleaving chunks with decode steps cannot perturb other slots.
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
    ``valid`` are garbage by the same masking contract)."""
    with _backend.plan_variant(variant):
        B, C = tokens.shape
        dev = tokens.device
        x = params["emb"][tokens]
        steps = torch.arange(C, device=dev)[None, :]
        positions = index[:, None] + steps
        length_mask = steps < valid[:, None]
        h, caches = backbone(params, cfg, x, positions, caches=caches,
                             cache_index=index, length_mask=length_mask,
                             pages=pages)
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
    are garbage by contract.  With ``pages`` (B, W) the KV lives in the
    paged pool and ``active`` is the write mask: inactive and
    still-prefilling slots write into the trash page, whatever their
    ``index``.  On the dense cache ``active`` changes nothing (an
    attention-only model has no cross-slot coupling or recurrent state to
    suppress), and an inactive slot writes at its ``index``.  ``variant``
    selects the plan variant (see `prefill`)."""
    with _backend.plan_variant(variant):
        x = params["emb"][token][:, None, :]
        B = x.shape[0]
        if isinstance(index, torch.Tensor) and index.dim() == 1:
            positions = index[:, None]
        else:
            positions = torch.full((B, 1), int(index), device=x.device)
        length_mask = None if active is None else active[:, None]
        h, caches = backbone(params, cfg, x, positions, caches=caches,
                             cache_index=index, length_mask=length_mask,
                             pages=pages)
        return _project_logits(params, cfg, h[:, -1]), caches
