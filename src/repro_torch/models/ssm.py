"""Mamba2 blocks of the hybrid zamba2 family (``repro.models.ssm``
counterpart; its xLSTM half waits for a later slice).

The recurrence is O(T) with O(1) state per slot: ``{"ssm": (B, H, hd,
N) float32, "conv": (B, K-1, conv_dim)}`` (`mamba2_init_state`).  The
JAX package computes the SSM in plain jnp, outside any Pallas kernel, and
so does the port in plain PyTorch; only ``in_proj`` and ``out_proj`` go
through `layers.dense`, and so through the planned kernels.  Functions
return new state tensors; `repro_torch.models.transformer` copies them
into its cache buffers in place.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models._backend import join as _j


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def n_heads(self):
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self):
        return self.d_inner + 2 * self.d_state


def init_mamba2(gen: torch.Generator, cfg: Mamba2Config,
                dtype=torch.bfloat16, repeats=None):
    """The JAX package's shapes and scales (``A_log`` 0, so A = -1; ``D``
    1; ``dt_bias`` 0, all float32), stacked on a leading ``repeats`` axis
    when given, drawn from ``gen`` on its device."""
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    dev = gen.device
    lead = () if repeats is None else (repeats,)
    proj_out = 2 * di + 2 * N + H          # z, x, B, C, dt
    conv_w = torch.randn(lead + (cfg.conv_kernel, cfg.conv_dim),
                         generator=gen, device=dev) * 0.2
    return {
        "in_proj": L.init_dense(gen, d, proj_out, dtype, repeats=repeats),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(lead + (cfg.conv_dim,), dtype=dtype,
                              device=dev),
        "A_log": torch.zeros(lead + (H,), device=dev),
        "D": torch.ones(lead + (H,), device=dev),
        "dt_bias": torch.zeros(lead + (H,), device=dev),
        "norm": L.init_norm(di, dtype, repeats=repeats, device=dev),
        "out_proj": L.init_dense(gen, di, d, dtype, scale=di ** -0.5,
                                 repeats=repeats),
    }


def _causal_conv(x, w, b, state=None, lengths=None):
    """Depthwise causal conv.  x (B, S, C), w (K, C), state (B, K-1, C) or
    None (zeros).  Returns (out (B, S, C), new state (B, K-1, C)).

    ``lengths`` (B,) makes the new state ragged-aware: with right-padded
    inputs the carried window holds the last K-1 VALID positions of each
    slot, ``xp[b, lengths[b] : lengths[b] + K-1]`` (``xp`` prepends the
    K-1 carry rows), gathered per slot; a slot with length 0 keeps its
    state bit for bit."""
    K = w.shape[0]
    S = x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    if lengths is None:
        new_state = xp[:, S:]
    else:
        rows = lengths.long()[:, None] + torch.arange(K - 1, device=x.device)
        new_state = torch.gather(
            xp, 1, rows[:, :, None].expand(-1, -1, xp.shape[2]))
    return out + b, new_state


#: time steps per chunk of the chunkwise-parallel SSD (the JAX package's)
SSD_CHUNK = 256


def _ssd_chunked(xs, Bt, Ct, dt, la, h0, chunk=None):
    """Chunkwise-parallel SSD (Mamba2).  xs (B, S, H, P); Bt, Ct (B, S,
    N); dt, la (B, S, H) with la = dt * A <= 0; h0 (B, H, P, N) float32.
    Returns (h_final, y (B, S, H, P)), summed in h0's dtype (float32 on
    the serving path).  Padding steps use dt = 0 (so la = 0): an exact
    identity on the state."""
    B, S, H, P = xs.shape
    Q = min(chunk or SSD_CHUNK, S)
    pad = (-S) % Q
    if pad:
        xs, Bt, Ct, dt, la = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                              for a in (xs, Bt, Ct, dt, la))
    f32 = h0.dtype
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=xs.device))[None, :, :, None]
    h = h0
    ys = []
    for c0 in range(0, S + pad, Q):
        xc = xs[:, c0:c0 + Q].to(f32)
        bc = Bt[:, c0:c0 + Q].to(f32)
        cc = Ct[:, c0:c0 + Q].to(f32)
        dtc = dt[:, c0:c0 + Q]
        ca = torch.cumsum(la[:, c0:c0 + Q], dim=1)           # (B, Q, H)
        # intra-chunk: y_t += sum_{s<=t} exp(ca_t - ca_s) dt_s (C_t.B_s) x_s
        cb = torch.einsum("bqn,bsn->bqs", cc, bc)
        decay = torch.exp(ca[:, :, None, :] - ca[:, None, :, :])
        W = cb[..., None] * torch.where(tri, decay, 0.0)     # (B, Q, Q, H)
        y = torch.einsum("bqsh,bshp->bqhp", W * dtc[:, None], xc)
        # inter-chunk: y_t += exp(ca_t) C_t . h0
        y = y + torch.einsum("bqn,bhpn->bqhp", cc, h) * \
            torch.exp(ca)[..., None]
        # state: h' = exp(ca_Q) h0 + sum_s exp(ca_Q - ca_s) dt_s B_s x_s
        dlast = torch.exp(ca[:, -1:, :] - ca)                # (B, Q, H)
        h = torch.exp(ca[:, -1, :])[:, :, None, None] * h + \
            torch.einsum("bsh,bshp,bsn->bhpn", dlast * dtc, xc, bc)
        ys.append(y)
    return h, torch.cat(ys, dim=1)[:, :S]


def _ssd_step(xs, Bt, Ct, dt, la, h0):
    """One step of the SSM recurrence (S = 1), shapes as `_ssd_chunked`'s:
    h' = exp(la) h0 + dt B x, y = C . h', summed in h0's dtype.  Returns
    (h', y (B, 1, H, P))."""
    f32 = h0.dtype
    dBx = torch.einsum("bhp,bn,bh->bhpn", xs[:, 0].to(f32),
                       Bt[:, 0].to(f32), dt[:, 0])
    h = h0 * torch.exp(la[:, 0])[..., None, None] + dBx
    return h, torch.einsum("bhpn,bn->bhp", h, Ct[:, 0].to(f32))[:, None]


def mamba2(p, x, cfg: Mamba2Config, state=None, name=None,
           length_mask=None):
    """x (B, S, D) -> (y (B, S, D), new state).  The chunked SSD for S > 1,
    the per-step recurrence for S = 1, as in the JAX package.
    ``length_mask`` (B, S) bool marks the VALID positions of right-padded
    ragged inputs: padded steps run with dt = 0, an exact identity on the
    SSM state, and the conv carry keeps each slot's last valid window.
    Outputs at masked positions are garbage by contract."""
    B, S, _ = x.shape
    di, N, H, hd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    zxbcdt = L.dense(p["in_proj"], x, _j(name, "in_proj"))
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + cfg.conv_dim]
    dt_raw = zxbcdt[..., di + cfg.conv_dim:]                  # (B, S, H)

    lengths = (length_mask.to(torch.int64).sum(dim=-1)
               if length_mask is not None else None)
    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state,
                                 lengths=lengths)
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(B, S, H, hd)
    Bt = xbc[..., di:di + N]                                  # (B, S, N)
    Ct = xbc[..., di + N:]                                    # (B, S, N)

    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])            # (B, S, H)
    if length_mask is not None:
        dt = dt * length_mask[..., None].to(f32)
    A = -torch.exp(p["A_log"])                                # (H,)
    h0 = (state["ssm"] if state is not None
          else torch.zeros((B, H, hd, N), dtype=f32, device=x.device))

    la = dt * A                                               # <= 0
    if S > 1:
        hT, y = _ssd_chunked(xs, Bt, Ct, dt, la, h0)
    else:
        hT, y = _ssd_step(xs, Bt, Ct, dt, la, h0)
    y = y + p["D"][None, None, :, None] * xs.to(f32)
    y = y.reshape(B, S, di).to(x.dtype) * F.silu(z)
    y = L.norm(p["norm"], y)
    out = L.dense(p["out_proj"], y, _j(name, "out_proj"))
    return out, {"ssm": hT, "conv": new_conv}


def mamba2_init_state(B, cfg: Mamba2Config, dtype=torch.bfloat16,
                      device="cuda"):
    """Zero state of B slots: the conv carry in ``dtype``, the SSM state
    in float32."""
    return {"ssm": torch.zeros((B, cfg.n_heads, cfg.head_dim, cfg.d_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((B, cfg.conv_kernel - 1, cfg.conv_dim),
                                dtype=dtype, device=device)}
