"""Input stand-ins and step functions for every (architecture x input
shape) dry-run cell (``repro.launch.specs`` counterpart).  Stand-ins are
``meta`` tensors: shapes and dtypes, no storage.

Shapes:
  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill_step
  decode_32k   cache 32,768 global_batch 128  -> serve_step (1 new token)
  long_500k    cache 524,288 global_batch 1   -> serve_step; only for
               sub-quadratic archs (cfg.subquadratic)
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree as _tree
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def cell_is_runnable(cfg: ArchConfig, shape: str) -> bool:
    """long_500k requires sub-quadratic sequence mixing."""
    if shape == "long_500k":
        return cfg.subquadratic
    return True


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _i32(*shape):
    return _meta(shape, torch.int32)


def input_specs(cfg: ArchConfig, shape: str) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of this cell: the JAX
    package's tree, shapes and dtypes (the caches those of the port's
    `transformer.cache_specs`)."""
    meta = SHAPES[shape]
    B, S = meta["batch"], meta["seq"]
    if meta["kind"] == "train":
        specs = {"tokens": _i32(B, S), "targets": _i32(B, S)}
        if cfg.frontend:
            specs["frontend"] = _meta((B, cfg.frontend_tokens, cfg.d_model),
                                      torch.bfloat16)
        return {"batch": specs}
    if meta["kind"] == "prefill":
        specs = {"tokens": _i32(B, S), "caches": T.cache_specs(cfg, B, S)}
        if cfg.frontend:
            specs["frontend"] = _meta((B, cfg.frontend_tokens, cfg.d_model),
                                      torch.bfloat16)
        return specs
    # decode: one new token with a cache of length S; cross-attention KV
    # lives in the cache (written at prefill), so no frontend input
    return {"token": _i32(B), "caches": T.cache_specs(cfg, B, S),
            "index": _i32()}


def param_specs(cfg: ArchConfig):
    """`transformer.init_lm`'s params as ``meta`` tensors."""
    return T.param_shapes(cfg)


def opt_config(cfg: ArchConfig) -> adamw.AdamWConfig:
    # bf16 moments keep arctic-480b's optimizer state within a pod
    moment_dtype = (torch.bfloat16 if cfg.name == "arctic-480b"
                    else torch.float32)
    return adamw.AdamWConfig(lr=1e-4, weight_decay=0.01,
                             moment_dtype=moment_dtype)


def opt_specs(cfg: ArchConfig):
    """`adamw.init` on `param_specs`: the optimiser state as ``meta``
    tensors."""
    return adamw.init(param_specs(cfg), opt_config(cfg))


# ------------------------------------------------------------ step functions

def _is_placements(node) -> bool:
    """A leaf of a placements tree: a tuple of DTensor placements."""
    return isinstance(node, tuple) and len(node) > 0 and not any(
        isinstance(p, (dict, list, tuple)) for p in node)


def make_train_step(cfg: ArchConfig, grad_shardings=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: `lm_loss` with ``remat=True``, then
    `adamw.update`.  ``grad_shardings`` (a tree of DTensor placements,
    `sharding.shardings_for_params`) pins each DTensor gradient to its
    param's layout; a gradient that is not a DTensor is left as it is."""
    from repro_torch.launch.train import value_and_grad
    ocfg = opt_config(cfg)

    def pin(g, placements):
        if is_dtensor(g):
            return g.redistribute(g.device_mesh, placements)
        return g

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p: T.lm_loss(p, cfg, batch, remat=True), params)
        with torch.no_grad():
            if grad_shardings is not None:
                pins = _tree.leaves(grad_shardings, is_leaf=_is_placements)
                grads = _tree.unflatten(grads, [
                    pin(g, pl) for g, pl in zip(_tree.leaves(grads), pins)])
            params, opt_state, gnorm = adamw.update(grads, opt_state, params,
                                                    ocfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, tokens, caches, frontend=None):
        with torch.no_grad():
            return T.prefill(params, cfg, tokens, caches,
                             cross_source=frontend)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, token, caches, index):
        with torch.no_grad():
            return T.decode_step(params, cfg, token, caches, index)

    return serve_step
