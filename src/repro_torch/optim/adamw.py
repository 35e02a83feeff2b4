"""AdamW as plain tensor code with the JAX package's arithmetic
(``repro.optim.adamw`` counterparts): global gradient-norm clipping at
``clip_norm`` (None: none), a float32 step count in the bias
corrections, moments kept in ``moment_dtype`` (float32, or bfloat16 to
halve the optimiser state) and updated in float32, and the decoupled
weight decay ``p - lr * (update + weight_decay * p)``.  The defaults
(no decay, clipping at 1.0, float32 moments) are the search pipeline's.
``torch.optim.AdamW`` places eps otherwise, so it is not used.

Params, grads and moments are trees (`repro_torch.core.tree`), walked in
JAX's leaf order; the leaves' updates run as ``torch._foreach_*`` ops, one
launch per op over all leaves, each elementwise op that of the JAX update.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = 1.0
    moment_dtype: torch.dtype = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32 0-d
    mu: Any
    nu: Any


def init(params, cfg: AdamWConfig) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=cfg.moment_dtype)
    leaves = T.leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=T.tree_map(zeros, params),
                      nu=T.tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    total = 0.0
    for leaf in T.leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.minimum(torch.ones_like(gn), max_norm / (gn + 1e-9))
    # JAX's promotion: a bfloat16 gradient times the float32 scale is
    # float32 (torch would keep the bfloat16)
    leaves = [g.to(torch.promote_types(g.dtype, scale.dtype))
              for g in T.leaves(grads)]
    return T.unflatten(grads, torch._foreach_mul(leaves, scale)), gn


def update(grads, state: AdamWState, params, cfg: AdamWConfig, lr=None):
    """Returns (new_params, new_state, grad_norm)."""
    lr = cfg.lr if lr is None else lr
    if cfg.clip_norm is not None:
        grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gn = global_norm(grads)
    step = state.step + 1
    f32 = torch.float32
    stepf = step.to(f32)
    b1c = 1 - torch.pow(stepf.new_full((), cfg.b1), stepf)
    b2c = 1 - torch.pow(stepf.new_full((), cfg.b2), stepf)

    p32 = [p.to(f32) for p in T.leaves(params)]
    g = [x.to(f32) for x in T.leaves(grads)]
    m = [x.to(f32) for x in T.leaves(state.mu)]
    v = [x.to(f32) for x in T.leaves(state.nu)]
    fe = torch
    m = fe._foreach_add(fe._foreach_mul(m, cfg.b1),
                        fe._foreach_mul(g, 1 - cfg.b1))
    v = fe._foreach_add(fe._foreach_mul(v, cfg.b2),
                        fe._foreach_mul(fe._foreach_mul(g, 1 - cfg.b2), g))
    num = fe._foreach_div(m, b1c)
    den = fe._foreach_add(fe._foreach_sqrt(fe._foreach_div(v, b2c)), cfg.eps)
    upd = fe._foreach_div(num, den)
    if cfg.weight_decay:
        upd = fe._foreach_add(upd, fe._foreach_mul(p32, cfg.weight_decay))
    new_p = fe._foreach_sub(p32, fe._foreach_mul(upd, lr))
    dtypes = [p.dtype for p in T.leaves(params)]
    new_p = [x.to(d) for x, d in zip(new_p, dtypes)]
    md = cfg.moment_dtype
    return (T.unflatten(params, new_p),
            AdamWState(step, T.unflatten(state.mu, [x.to(md) for x in m]),
                       T.unflatten(state.nu, [x.to(md) for x in v])),
            gn)


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup, then cosine decay to floor * peak (float32)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, cos)
