"""Small ODiMO-managed façades beyond the paper's CNNs
(``repro.models.facades`` counterparts): an MLP stack and a
transformer-encoder classifier, both of managed Dense layers
(`repro_torch.models.managed`), so every weight matrix is channel-wise
searchable.  Both follow the façade contract of
`repro_torch.api.ModelHandle.from_legacy`:

    init(gen, cfg, spec)                      -> params
    apply(params, x, cfg, spec, mode, tau)    -> logits
    plan(cfg)                                 -> [(name, geometry, searchable)]

Plan names are params paths.  Both apply functions take a matmul
``backend`` (the `repro_torch.models._backend` protocol) and a plan
``variant``: with ``mode="deploy"`` and a `repro_torch.runtime.
PlannedBackend`, every covered dense runs through its planned kernel and
declined layers through the discretized fake-quant weights.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Tuple

import torch

from repro_torch.core.cost_models import LayerGeometry
from repro_torch.models import _backend
from repro_torch.models import managed as mg


def _installed(backend, variant):
    """The context of an apply call: ``backend`` installed when given, and
    the plan ``variant`` published."""
    stack = contextlib.ExitStack()
    if backend is not None:
        stack.enter_context(mg.matmul_backend(backend))
    stack.enter_context(_backend.plan_variant(variant))
    return stack


# --------------------------------------------------------------------------
# MLP over flattened inputs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int
    widths: Tuple[int, ...]
    n_classes: int
    name: str = "mlp"


def mlp_init(gen: torch.Generator, cfg: MLPConfig, spec):
    dims = [cfg.in_dim] + list(cfg.widths)
    layers = [mg.init_dense(gen, dims[i], dims[i + 1], spec)
              for i in range(len(cfg.widths))]
    head = mg.init_dense(gen, cfg.widths[-1], cfg.n_classes, spec)
    return {"layers": layers, "head": head}


def mlp_apply(p, x, cfg: MLPConfig, spec=None, mode="fp", tau=1.0,
              backend=None, variant=None):
    with _installed(backend, variant):
        h = x.reshape(x.shape[0], -1)
        for i, lp in enumerate(p["layers"]):
            h = torch.relu(mg.dense(lp, h, spec, mode, tau,
                                    name=f"layers/{i}"))
        return mg.dense(p["head"], h, spec, mode, tau, name="head")


def mlp_plan(cfg: MLPConfig) -> List[Tuple[str, LayerGeometry, bool]]:
    dims = [cfg.in_dim] + list(cfg.widths)
    plan = [(f"layers/{i}", mg.dense_geometry(dims[i], dims[i + 1]), True)
            for i in range(len(cfg.widths))]
    plan.append(("head", mg.dense_geometry(cfg.widths[-1], cfg.n_classes),
                 True))
    return plan


# --------------------------------------------------------------------------
# Transformer-encoder classifier (patchify -> blocks -> mean-pool -> head)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    in_dim: int                 # per-token input dim after patchify
    n_tokens: int
    d_model: int
    n_layers: int
    n_classes: int
    n_heads: int = 4
    ffn_mult: int = 2
    name: str = "encoder"


def _block_init(gen, cfg: EncoderConfig, spec):
    d, f = cfg.d_model, cfg.d_model * cfg.ffn_mult
    return {
        "qkv": mg.init_dense(gen, d, 3 * d, spec),
        "proj": mg.init_dense(gen, d, d, spec),
        "ffn1": mg.init_dense(gen, d, f, spec),
        "ffn2": mg.init_dense(gen, f, d, spec),
    }


def encoder_init(gen: torch.Generator, cfg: EncoderConfig, spec):
    return {
        "embed": mg.init_dense(gen, cfg.in_dim, cfg.d_model, spec),
        "blocks": [_block_init(gen, cfg, spec)
                   for _ in range(cfg.n_layers)],
        "head": mg.init_dense(gen, cfg.d_model, cfg.n_classes, spec),
    }


def _attention(h, qkv, cfg: EncoderConfig):
    B, S, D = h.shape
    hd = D // cfg.n_heads
    q, k, v = torch.split(qkv, D, dim=-1)
    shape = (B, S, cfg.n_heads, hd)
    q, k, v = (t.reshape(shape).permute(0, 2, 1, 3) for t in (q, k, v))
    att = torch.softmax(q @ k.transpose(2, 3) / hd ** 0.5, dim=-1)
    return (att @ v).permute(0, 2, 1, 3).reshape(B, S, D)


def _tokens(x, cfg: EncoderConfig):
    """Flatten any input into (B, n_tokens, in_dim) patch tokens."""
    return x.reshape(x.shape[0], cfg.n_tokens, cfg.in_dim)


def encoder_apply(p, x, cfg: EncoderConfig, spec=None, mode="fp", tau=1.0,
                  backend=None, variant=None):
    with _installed(backend, variant):
        h = mg.dense(p["embed"], _tokens(x, cfg), spec, mode, tau,
                     name="embed")
        for i, blk in enumerate(p["blocks"]):
            a = _attention(h, mg.dense(blk["qkv"], h, spec, mode, tau,
                                       name=f"blocks/{i}/qkv"), cfg)
            h = h + mg.dense(blk["proj"], a, spec, mode, tau,
                             name=f"blocks/{i}/proj")
            f = torch.relu(mg.dense(blk["ffn1"], h, spec, mode, tau,
                                    name=f"blocks/{i}/ffn1"))
            h = h + mg.dense(blk["ffn2"], f, spec, mode, tau,
                             name=f"blocks/{i}/ffn2")
        return mg.dense(p["head"], torch.mean(h, dim=1), spec, mode, tau,
                        name="head")


def encoder_plan(cfg: EncoderConfig) -> List[Tuple[str, LayerGeometry, bool]]:
    d, f = cfg.d_model, cfg.d_model * cfg.ffn_mult
    plan = [("embed", mg.dense_geometry(cfg.in_dim, d), True)]
    for i in range(cfg.n_layers):
        plan += [(f"blocks/{i}/qkv", mg.dense_geometry(d, 3 * d), True),
                 (f"blocks/{i}/proj", mg.dense_geometry(d, d), True),
                 (f"blocks/{i}/ffn1", mg.dense_geometry(d, f), True),
                 (f"blocks/{i}/ffn2", mg.dense_geometry(f, d), True)]
    plan.append(("head", mg.dense_geometry(d, cfg.n_classes), True))
    return plan
