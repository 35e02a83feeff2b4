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
  prefill(params, cfg, tokens, caches, lengths=) -> (last_logits, caches)
  decode_step(params, cfg, token, caches, index, active=)
                                                 -> (logits, caches)
  cache_specs(cfg, B, S_max)                     -> tree of meta tensors
  init_cache(cfg, B, S_max, device)              -> caches
  cache_batch_axes(caches)                       -> batch axis per leaf
  scatter_cache(caches, sub, slots)              -> caches (in place)

Caches are updated in place (see `repro_torch.models.attention`).  A
prompt longer than 2048 tokens prefills through the chunked (flash)
attention, as the JAX package's ``_prefill_body`` does; like the JAX
package's, that path needs a cache length that is a multiple of
``min(1024, S_max)`` and a prompt length that is a multiple of
``min(512, S)``.  Hybrid, MoE, MLA, cross-attention and encoder-decoder
archs, paged caches and the paged chunked prefill of the serving engine
wait for later slices; the dense serving engine
(`repro_torch.serving.Engine`) prefills admission groups with
``prefill(lengths=)``, moves them into its slot pool with `scatter_cache`
and decodes all slots with a per-slot ``index``.
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
                cache_index=None, name=None, chunked=False):
    """One ``attn`` block (pre-norm GQA + FFN). Returns (x, cache)."""
    h = L.norm(p["norm1"], x, cfg.norm)
    ao, nc = A.gqa(p["attn"], h, positions, _attn_cfg(cfg), cache=cache,
                   cache_index=cache_index, name=_j(name, "attn"),
                   chunked=chunked)
    x = x + ao
    if "ffn" in p:
        x = x + L.ffn(p["ffn"], L.norm(p["norm2"], x, cfg.norm), cfg.act,
                      _j(name, "ffn"))
    return x, nc


def backbone(params, cfg: ArchConfig, x, positions, *, caches=None,
             cache_index=None, chunked=False):
    """Run all layers; returns (final-normed hidden, caches).  ``chunked``:
    attention through `attention.chunked_attention` (long prefill)."""
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
                               name="units/0", chunked=chunked)
    return L.norm(params["final_norm"], x, cfg.norm), caches


def _project_logits(params, cfg: ArchConfig, h):
    """Vocab projection, routed through the matmul backend when one is
    installed (planned execution of the head)."""
    be = _backend.current()
    if be is not None:
        y = be("head", params["head"], h)
        if y is not None:
            return y.to(torch.float32)
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


def prefill(params, cfg: ArchConfig, tokens, caches, lengths=None):
    """Process the prompts ``tokens (B, S)``, fill the caches, and return
    (logits at each row's last valid position, caches).  ``lengths`` (B,)
    marks right-padded prompts; KV written at padded positions is masked by
    every later read.  Prompts longer than 2048 tokens take the chunked
    attention (see the module docstring)."""
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


def decode_step(params, cfg: ArchConfig, token, caches, index, active=None):
    """One decode step for ``token (B,)`` at position ``index``: an int
    (same-length batch) or a (B,) tensor of per-slot cache lengths.
    ``active`` (B,) bool marks live slots; it keeps the JAX package's
    signature and changes nothing here: an attention-only model has no
    cross-slot coupling or recurrent state to suppress, and the logits of
    an inactive slot are garbage by contract."""
    x = params["emb"][token][:, None, :]
    B = x.shape[0]
    if isinstance(index, torch.Tensor) and index.dim() == 1:
        positions = index[:, None]
    else:
        positions = torch.full((B, 1), int(index), device=x.device)
    h, caches = backbone(params, cfg, x, positions, caches=caches,
                         cache_index=index)
    return _project_logits(params, cfg, h[:, -1]), caches
