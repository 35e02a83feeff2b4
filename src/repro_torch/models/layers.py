"""Shared transformer building blocks (``repro.models.layers``
counterparts).  Projections are ``(in_features, out_features)``, so the
output channel is the last axis, as in the JAX package."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (contiguous, is_dtensor,
                                              replicated, settled)
from repro_torch.models import _backend


def _operands(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` in their promoted dtype (JAX's promotion: mixed
    bf16/f32 -> f32).  DTensor operands are made contiguous too: the
    reshapes inside a matmul or an einsum take the view DTensor plans
    from the global strides, which a local shard left strided by a
    redistribution may not allow."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if is_dtensor(a) or is_dtensor(b):
        a, b = contiguous(a), contiguous(b)
    return a, b


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's type promotion (`_operands`)."""
    a, b = _operands(a, b)
    return a @ b


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's type promotion (`_operands`)."""
    return torch.einsum(eq, *_operands(a, b))


def embed(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows ``emb[tokens]``, through ``F.embedding``: on a DTensor
    table its strategy and backward are those of a vocab-parallel
    embedding (indexing's backward, an ``index_put``, has none that every
    DTensor version places), with the tokens whole on every device (the
    vocab-parallel output's mask is of the tokens' local shape)."""
    return F.embedding(replicated(tokens), emb)


def init_dense(gen: torch.Generator, d_in, d_out, dtype=torch.bfloat16,
               scale=None, bias=False, repeats=None):
    """``{"w": N(0, scale^2) (d_in, d_out)}`` (default scale d_in**-0.5),
    stacked on a leading ``repeats`` axis when given; drawn in float32 one
    repeat at a time, on ``gen``'s device."""
    s = scale if scale is not None else d_in ** -0.5
    lead = () if repeats is None else (repeats,)
    w = torch.empty(lead + (d_in, d_out), dtype=dtype, device=gen.device)
    for r in range(repeats or 1):
        draw = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                           dtype=torch.float32) * s
        (w[r] if repeats is not None else w).copy_(draw)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p, x, name=None):
    """``name`` is the layer's params path, forwarded to the pluggable
    matmul backend; None skips backend dispatch.  Params of the int8
    serving domain (`transformer.quantize_for_serve`: ``w_q`` codes and
    per-output-channel ``w_s`` scales) are dequantized in ``x``'s dtype
    and multiplied as the JAX package's are."""
    be = _backend.current()
    if be is not None:
        y = be(name, p, x)
        if y is not None:
            return y  # planned kernel output, bias applied by the backend
    if "w_q" in p:
        w = p["w_q"].to(x.dtype) * p["w_s"].to(x.dtype)[..., None, :]
        y = matmul(x, w)
    else:
        y = matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return settled(y)


def init_norm(d, dtype=torch.bfloat16, repeats=None, device=None,
              kind="rmsnorm"):
    """``{"scale": ones}``, and LayerNorm's ``"bias"`` zeros, stacked on a
    leading ``repeats`` axis when given."""
    lead = () if repeats is None else (repeats,)
    p = {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    return p


def norm(p, x, kind="rmsnorm", eps=1e-5):
    """RMSNorm, or LayerNorm (``kind="layernorm"``): mean and variance in
    float32, then the scale, then the bias when ``p`` has one."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    else:
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, -1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32)
    if "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def rope(x, positions, theta=10000.0):
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def init_ffn(gen, d_model, d_ff, gated: bool, dtype=torch.bfloat16,
             repeats=None):
    p = {"up": init_dense(gen, d_model, d_ff, dtype, repeats=repeats),
         "down": init_dense(gen, d_ff, d_model, dtype, scale=d_ff ** -0.5,
                            repeats=repeats)}
    if gated:
        p["gate"] = init_dense(gen, d_model, d_ff, dtype, repeats=repeats)
    return p


def ffn(p, x, act_name="silu", name=None):
    a = act_fn(act_name)
    j = _backend.join
    if "gate" in p:
        h = a(dense(p["gate"], x, j(name, "gate"))) * \
            dense(p["up"], x, j(name, "up"))
    else:
        h = a(dense(p["up"], x, j(name, "up")))
    return dense(p["down"], h, j(name, "down"))
