"""Mixture-of-Experts FFN with grouped dense dispatch and capacity dropping
(``repro.models.moe`` counterpart).

Tokens are reshaped into G groups; within a group every (token, k) pair
of the top-k routing takes the next free place in its expert's buffer of
C places, and pairs past C are dropped, so shapes stay static and the
slots of a batch share each expert's capacity.  The expert products are
``torch.einsum`` over all experts (the JAX package's are jnp einsums
outside any Pallas kernel); the router and the shared experts are dense
layers named ``<block>/moe/router`` and ``<block>/moe/shared/...``, which
a planned matmul backend runs.  The expert tensors are raw ``(E, D, F)``
/ ``(E, F, D)`` arrays, not ``{"w"}`` dicts, so mapping emission skips
them, as the JAX package's does.

deepseek-v2-lite: 64 routed experts top-6 + 2 shared experts.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models._backend import join as _j


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    n_shared: int = 0            # always-on shared experts (deepseek)
    capacity_factor: float = 1.25
    act: str = "silu"
    gated: bool = True
    router_dtype: str = "float32"


def _experts(gen, repeats, shape, scale, dtype):
    """N(0, scale^2) of ``shape``, stacked on a leading ``repeats`` axis
    when given; drawn in float32 one repeat at a time and scaled in place,
    so that one float32 repeat is the only temporary (17.9 GB for one of
    arctic's (128, 7168, 4864) expert tensors)."""
    lead = () if repeats is None else (repeats,)
    out = torch.empty(lead + shape, dtype=dtype, device=gen.device)
    for r in range(repeats or 1):
        draw = torch.randn(shape, generator=gen, device=gen.device,
                           dtype=torch.float32).mul_(scale)
        (out[r] if repeats is not None else out).copy_(draw)
        del draw        # before the next repeat's draw
    return out


def init_moe(gen, d_model: int, cfg: MoEConfig, dtype=torch.bfloat16,
             repeats=None):
    """The JAX package's tree and scales: the router ``{"w"}`` in float32,
    the experts' ``up`` / ``gate`` ``(E, D, F)`` and ``down`` ``(E, F, D)``
    raw tensors, and the shared experts an FFN of width ``n_shared *
    d_ff``; every leaf stacked on a leading ``repeats`` axis when given."""
    E, Fd = cfg.n_experts, cfg.d_ff
    p = {"router": L.init_dense(gen, d_model, E, torch.float32,
                                repeats=repeats),
         "up": _experts(gen, repeats, (E, d_model, Fd), d_model ** -0.5,
                        dtype),
         "down": _experts(gen, repeats, (E, Fd, d_model), Fd ** -0.5, dtype)}
    if cfg.gated:
        p["gate"] = _experts(gen, repeats, (E, d_model, Fd), d_model ** -0.5,
                             dtype)
    if cfg.n_shared:
        p["shared"] = L.init_ffn(gen, d_model, cfg.n_shared * Fd, cfg.gated,
                                 dtype, repeats=repeats)
    return p


def _capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts)
    return max(c, cfg.top_k)


def top_k(probs, k: int):
    """The ``k`` largest of the last axis, ties broken toward the lower
    index as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no
    order among equal values): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch(probs, cfg: MoEConfig, length_mask=None):
    """Routing of ``probs (G, Tg, E)``: (``topv`` (G, Tg, K) renormalised,
    ``topi`` (G, Tg, K) the experts, ``onehot`` (G, Tg, K, E) int32 with
    masked tokens zeroed, ``pos`` (G, Tg, K) each pair's place in its
    expert's buffer, ``keep`` pos < C, C).
    ``length_mask`` (G, Tg) drops masked tokens before the capacity
    cumsum, so they never take a place."""
    G, Tg, E = probs.shape
    C = _capacity(Tg, cfg)
    topv, topi = top_k(probs, cfg.top_k)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    onehot = F.one_hot(topi, E).to(torch.int32)
    if length_mask is not None:
        onehot = onehot * length_mask.to(torch.int32)[..., None, None]
    flat = onehot.reshape(G, Tg * cfg.top_k, E)
    pos = (torch.cumsum(flat, dim=1) - 1).reshape(onehot.shape)
    pos = (pos * onehot).sum(-1)
    return topv, topi, onehot, pos, pos < C, C


def moe_ffn(p, x, cfg: MoEConfig, n_groups=None, name=None,
            length_mask=None):
    """x (B, S, D) -> (y (B, S, D), {"load_balance": Switch aux}), step for
    step the JAX package's: ``T // 4096`` groups (1 to 256) by default,
    the float32 router through `layers.dense`, softmax, top-k
    renormalised with a 1e-9 floor, ``length_mask`` (B, S) of valid tokens
    applied before the capacity cumsum, the combine and dispatch tensors
    in ``x.dtype``, the three expert einsums, the combine, plus the
    shared experts' FFN."""
    B, S, D = x.shape
    T = B * S
    G = n_groups if n_groups is not None else max(1, min(256, T // 4096))
    if T % G:
        raise ValueError(f"moe_ffn: {T} tokens do not split into {G} groups")
    Tg, E = T // G, cfg.n_experts
    xt = x.reshape(G, Tg, D)
    logits = L.dense(p["router"], xt.to(torch.float32), _j(name, "router"))
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    mask = None if length_mask is None else length_mask.reshape(G, Tg)
    topv, topi, onehot, pos, keep, C = dispatch(probs, cfg, mask)

    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(topi[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    aux = {"load_balance": E * torch.sum(me * ce)}

    pos_oh = F.one_hot(pos.clamp_max(C - 1), C).to(x.dtype) * \
        keep[..., None].to(x.dtype)
    comb = torch.einsum("gtke,gtkc->gtec", onehot.to(x.dtype),
                        pos_oh * topv[..., None].to(x.dtype))
    comb = constrain(comb, "moe_grouped")
    disp = constrain((comb > 0).to(x.dtype), "moe_grouped")
    ein = constrain(torch.einsum("gtec,gtd->gecd", disp, xt), "moe_expert")
    a = L.act_fn(cfg.act)
    if cfg.gated:
        h = a(L.einsum("gecd,edf->gecf", ein, p["gate"])) * \
            L.einsum("gecd,edf->gecf", ein, p["up"])
    else:
        h = a(L.einsum("gecd,edf->gecf", ein, p["up"]))
    h = constrain(h, "moe_expert")
    eout = constrain(L.einsum("gecf,efd->gecd", h, p["down"]), "moe_expert")
    # the combine "gtec,gecd->gtd" as one batched product over (e, c)
    # flattened with the expert-sharded e outermost, which every DTensor
    # version places (einsum's own order of the two is not)
    y = L.matmul(comb.reshape(G, Tg, E * C),
                 eout.reshape(G, E * C, D)).reshape(B, S, D)
    if cfg.n_shared:
        y = y + L.ffn(p["shared"], x, cfg.act, _j(name, "shared"))
    # on DTensors the combine leaves a pending sum over the experts: lay
    # it out as the residual stream before a caller adds to it
    return constrain(y, "act"), aux
