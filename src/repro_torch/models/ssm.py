"""Recurrent blocks (``repro.models.ssm`` counterpart): Mamba2 (the
hybrid zamba2 family) and xLSTM's mLSTM and sLSTM (xlstm-1.3b).

Each recurrence is O(T) with O(1) state per slot:
  mamba2 : {"ssm": (B, H, hd, N) float32, "conv": (B, K-1, conv_dim)}
  mlstm  : {"C": (B, H, hd, hd), "n": (B, H, hd), "m": (B, H) float32,
            "conv": (B, K-1, d_inner)}
  slstm  : {"c", "n", "h": (B, H, hd), "m": (B, H) float32}
The JAX package computes the recurrences in plain jnp, outside any Pallas
kernel, and so does the port in plain PyTorch (sLSTM's step loop in
Python); only the projections (``in_proj`` / ``out_proj``, ``up`` /
``w_if`` / ``down``, ``w_in`` / ``down``) go through `layers.dense`, and
so through the planned kernels.  Functions return new state tensors;
`repro_torch.models.transformer` copies them into its cache buffers in
place.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (constrain, elementwise, merged,
                                              per_batch_shard, splittable)
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
        cb = constrain(torch.einsum("bqn,bsn->bqs", cc, bc), "act")
        # masked in the exponent (the JAX package masks after the exp):
        # above the diagonal exp(ca_t - ca_s) overflows once a chunk's
        # decay passes float32's range, and the gradient of a masked inf
        # is NaN; the forward is the same, bit for bit
        diff = ca[:, :, None, :] - ca[:, None, :, :]
        decay = torch.exp(torch.where(tri, diff, float("-inf")))
        W = constrain(cb[..., None] * decay, "act")          # (B, Q, Q, H)
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


def _on_batch_shards(scan, inputs, state):
    """``scan(*inputs, state) -> (new state, outputs)`` on each device's
    batch shard (`sharding.per_batch_shard`: a chunk loop of plain ops
    rather than of DTensor ops); every input and state tensor has the
    batch first."""
    def run(batched, _):
        new, out = scan(*batched[:len(inputs)], tuple(batched[len(inputs):]))
        return (*((new,) if isinstance(new, torch.Tensor) else new), out)
    *new, out = per_batch_shard(run, tuple(inputs) + tuple(state))
    return tuple(new), out


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
    xbc, new_conv = _causal_conv(constrain(xbc, "act"), p["conv_w"],
                                 p["conv_b"], conv_state, lengths=lengths)
    xbc = F.silu(xbc)
    xs = constrain(xbc[..., :di].reshape(B, S, H, hd), "act")
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
        (hT,), y = _on_batch_shards(
            lambda *a: _ssd_chunked(*a[:5], *a[5]), (xs, Bt, Ct, dt, la),
            (h0,))
    else:
        (hT,), y = _on_batch_shards(
            lambda *a: _ssd_step(*a[:5], *a[5]), (xs, Bt, Ct, dt, la),
            (h0,))
    y = y + p["D"][None, None, :, None] * xs.to(f32)
    y = merged(y, (B, S, di), H).to(x.dtype) * F.silu(z)
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


# ===================================================================== mLSTM

@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int = 4
    expand: int = 2
    conv_kernel: int = 4

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def head_dim(self):
        return self.d_inner // self.n_heads


def _normal(gen, repeats, shape, scale, dtype):
    """N(0, scale^2) of ``shape``, stacked on a leading ``repeats`` axis
    when given, drawn in float32."""
    lead = () if repeats is None else (repeats,)
    w = torch.randn(lead + shape, generator=gen, device=gen.device) * scale
    return w.to(dtype)


def init_mlstm(gen: torch.Generator, cfg: XLSTMConfig,
               dtype=torch.bfloat16, repeats=None):
    """The JAX package's shapes and scales: ``up`` (d, 2 di), the conv, the
    block-diagonal per-head q / k / v ``(H, hd, hd)`` (di^2 / H params
    each), ``w_if`` (di, 2 H) for the input and forget gates, the norm and
    ``down`` (di, d); stacked on a leading ``repeats`` axis when given."""
    d, di, H, hd = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.head_dim
    dev = gen.device
    lead = () if repeats is None else (repeats,)
    p = {"up": L.init_dense(gen, d, 2 * di, dtype, repeats=repeats),
         "conv_w": _normal(gen, repeats, (cfg.conv_kernel, di), 0.2,
                                 dtype),
         "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev)}
    for key in ("wq_bd", "wk_bd", "wv_bd"):
        p[key] = _normal(gen, repeats, (H, hd, hd), hd ** -0.5, dtype)
    p["w_if"] = L.init_dense(gen, di, 2 * H, dtype, repeats=repeats)
    p["norm"] = L.init_norm(di, dtype, repeats=repeats, device=dev)
    p["down"] = L.init_dense(gen, di, d, dtype, scale=di ** -0.5,
                             repeats=repeats)
    return p


#: time steps per chunk of the chunkwise-parallel mLSTM (the JAX package's)
MLSTM_CHUNK = 256


def _mlstm_chunked(q, k, v, ig, fg, state, chunk=None):
    """Chunkwise-parallel mLSTM with exact exponential-gating
    stabilisation, step for step the JAX package's.  q / k / v (B, S, H,
    hd), k pre-scaled by hd**-0.5; ig / fg (B, S, H) float32 raw gate
    pre-activations; ``state`` (C0 (B, H, hd, hd), n0 (B, H, hd), m0 (B,
    H)) in the recurrent step's scaled convention (stored C = true C /
    exp(m)).  Returns ((C, n, m), h (B, S, H, hd)), summed in the state's
    dtype (float32 on the serving path).

    With a = cumsum(log sigmoid f) and u_s = i_s - a_s within a chunk,
    M_t = max(cummax_{s<=t} u_s, m0), m_t = a_t + M_t and
      h_t = [sum_{s<=t} exp(u_s - M_t) (q_t.k_s) v_s
             + exp(m0 - M_t) q_t.C0] / max(|den_t|, exp(-m_t)),
    den_t the same sums with k_s and n0 in place of v_s and C0.  Padding
    steps (i = -1e30: no input; f = 80: no decay) are an identity."""
    B, S, H, hd = q.shape
    Q = min(chunk or MLSTM_CHUNK, S)
    pad = (-S) % Q
    if pad:
        padded = lambda a, val: F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad),
                                      value=val)
        q, k, v = padded(q, 0.0), padded(k, 0.0), padded(v, 0.0)
        ig, fg = padded(ig, -1e30), padded(fg, 80.0)
    C0, n0, m0 = state
    f32 = C0.dtype
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=q.device))[None, None]
    hs = []
    for c0 in range(0, S + pad, Q):
        qt, kt, vt = (a[:, c0:c0 + Q].to(f32) for a in (q, k, v))
        it, ft = ig[:, c0:c0 + Q], fg[:, c0:c0 + Q]
        logf = F.logsigmoid(ft)                               # (B, Q, H)
        a = torch.cumsum(logf, dim=1)
        u = it - a
        Mt = torch.maximum(torch.cummax(u, dim=1).values, m0[:, None, :])
        # intra-chunk scores, gated: exp(a_t - a_s + i_s - m_t)
        # = exp(u_s - M_t) (a_t cancels)
        qk = constrain(torch.einsum("bqhd,bshd->bhqs", qt, kt), "act")
        g = torch.exp(u.transpose(1, 2)[:, :, None, :] -
                      Mt.transpose(1, 2)[:, :, :, None])     # (B, H, t, s)
        w = torch.where(tri, qk * g, 0.0)
        num = torch.einsum("bhts,bshd->bthd", w, vt)
        den = torch.sum(w, dim=-1).transpose(1, 2)           # (B, t, H)
        # inter-chunk, from the carried state
        inter = torch.exp(m0[:, None, :] - Mt)               # (B, t, H)
        num = num + inter[..., None] * torch.einsum("bqhk,bhvk->bqhv", qt,
                                                    C0)
        den = den + inter * torch.einsum("bqhk,bhk->bqh", qt, n0)
        m_t = a + Mt
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_t))[..., None])
        # end-of-chunk state, in the scaled convention
        MQ = Mt[:, -1, :]
        dec = torch.exp(u - MQ[:, None, :])                  # (B, s, H)
        keep = torch.exp(m0 - MQ)
        C0 = torch.einsum("bsh,bshv,bshk->bhvk", dec, vt, kt) + \
            keep[..., None, None] * C0
        n0 = torch.einsum("bsh,bshk->bhk", dec, kt) + keep[..., None] * n0
        m0 = a[:, -1, :] + MQ
    return (C0, n0, m0), torch.cat(hs, dim=1)[:, :S]


def _mlstm_step(q, k, v, ig, fg, state):
    """One step of the mLSTM recurrence (S = 1; xLSTM eq. 15-19), shapes
    as `_mlstm_chunked`'s; returns ((C, n, m), h (B, 1, H, hd)), summed in
    the state's dtype."""
    C, n, m = state
    f32 = C.dtype
    i_t, f_t = ig[:, 0], fg[:, 0]
    logf = elementwise(F.logsigmoid, f_t)
    m_new = torch.maximum(logf + m, i_t)
    fs = torch.exp(logf + m - m_new)
    is_ = torch.exp(i_t - m_new)
    kf, vf, qf = (a[:, 0].to(f32) for a in (k, v, q))
    C = C * fs[..., None, None] + is_[..., None, None] * \
        torch.einsum("bhv,bhk->bhvk", vf, kf)
    n = n * fs[..., None] + is_[..., None] * kf
    num = torch.einsum("bhvk,bhk->bhv", C, qf)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qf)),
                        torch.exp(-m_new))[..., None]
    return (C, n, m_new), (num / den)[:, None]


def mlstm(p, x, cfg: XLSTMConfig, state=None, name=None, length_mask=None):
    """Matrix-memory LSTM with exponential gating (xLSTM): x (B, S, D) ->
    (y (B, S, D), new state).  The chunked form for S > 1, the recurrent
    step for S = 1, as in the JAX package.  ``length_mask`` (B, S) bool
    marks the valid positions of right-padded ragged inputs: masked steps
    take the chunked form's padding convention (i = -1e30, f = 80), an
    identity on (C, n) that moves m by at most log sigmoid(80), and the
    conv carry keeps each slot's last valid window.  Outputs at masked
    positions are garbage by contract."""
    B, S, _ = x.shape
    di, H, hd = cfg.d_inner, cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    uz = L.dense(p["up"], x, _j(name, "up"))
    u, z = uz[..., :di], uz[..., di:]
    lengths = (length_mask.to(torch.int64).sum(dim=-1)
               if length_mask is not None else None)
    conv_state = state["conv"] if state is not None else None
    uc, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state,
                                lengths=lengths)
    uc = constrain(F.silu(uc), "act")
    uh = splittable(uc, H).reshape(B, S, H, hd)
    q = constrain(L.einsum("bshd,hdk->bshk", uh, p["wq_bd"]), "act")
    k = constrain(L.einsum("bshd,hdk->bshk", uh, p["wk_bd"]), "act") * \
        hd ** -0.5
    v = constrain(L.einsum("bshd,hdk->bshk", uh, p["wv_bd"]), "act")
    gates = L.dense(p["w_if"], uc, _j(name, "w_if")).to(f32)  # (B, S, 2H)
    ig, fg = gates[..., :H], gates[..., H:]
    if length_mask is not None:
        live = length_mask[..., None]
        ig = torch.where(live, ig, -1e30)
        fg = torch.where(live, fg, 80.0)
    if state is None:
        carry = (torch.zeros((B, H, hd, hd), dtype=f32, device=x.device),
                 torch.zeros((B, H, hd), dtype=f32, device=x.device),
                 torch.zeros((B, H), dtype=f32, device=x.device))
    else:
        carry = (state["C"], state["n"], state["m"])
    if S > 1:
        (CT, nT, mT), hs = _on_batch_shards(_mlstm_chunked,
                                            (q, k, v, ig, fg), carry)
    else:
        (CT, nT, mT), hs = _mlstm_step(q, k, v, ig, fg, carry)
    h = merged(hs, (B, S, di), H).to(x.dtype)
    h = L.norm(p["norm"], h) * F.silu(z)
    out = L.dense(p["down"], h, _j(name, "down"))
    return out, {"C": CT, "n": nT, "m": mT, "conv": new_conv}


def mlstm_init_state(B, cfg: XLSTMConfig, dtype=torch.bfloat16,
                     device="cuda"):
    """Zero state of B slots: the memory in float32, the conv carry in
    ``dtype``."""
    H, hd = cfg.n_heads, cfg.head_dim
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return {"C": z(B, H, hd, hd), "n": z(B, H, hd), "m": z(B, H),
            "conv": torch.zeros((B, cfg.conv_kernel - 1, cfg.d_inner),
                                dtype=dtype, device=device)}


# ===================================================================== sLSTM

def init_slstm(gen: torch.Generator, cfg: XLSTMConfig,
               dtype=torch.bfloat16, repeats=None):
    """The JAX package's shapes and scales: ``w_in`` (d, 4 di) for the i,
    f, z, o pre-activations, the per-head recurrent mixing ``r`` (H, hd,
    4 hd), the norm and ``down`` (di, d); stacked on a leading
    ``repeats`` axis when given."""
    d, di, H, hd = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.head_dim
    return {"w_in": L.init_dense(gen, d, 4 * di, dtype, repeats=repeats),
            "r": _normal(gen, repeats, (H, hd, 4 * hd), hd ** -0.5,
                               dtype),
            "norm": L.init_norm(di, dtype, repeats=repeats,
                                device=gen.device),
            "down": L.init_dense(gen, di, d, dtype, scale=di ** -0.5,
                                 repeats=repeats)}


def slstm(p, x, cfg: XLSTMConfig, state=None, name=None, length_mask=None):
    """Scalar-memory LSTM with exponential gating and recurrent head
    mixing (xLSTM): x (B, S, D) -> (y (B, S, D), new state), one step at a
    time as the JAX package's scan.  ``length_mask`` (B, S) marks the
    valid positions of ragged inputs: at a masked step the carry (c, n, h,
    m) is SELECTED unchanged (the recurrent mixing of h makes a gate-level
    identity impossible).  Outputs at masked positions are garbage by
    contract."""
    B, S, _ = x.shape
    di, H, hd = cfg.d_inner, cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    pre = splittable(L.dense(p["w_in"], x, _j(name, "w_in")), H).reshape(
        B, S, H, 4 * hd)
    if state is None:
        z = lambda *s: torch.zeros(s, dtype=f32, device=x.device)
        c, n, h, m = z(B, H, hd), z(B, H, hd), z(B, H, hd), z(B, H)
    else:
        c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    mask = () if length_mask is None else (length_mask,)
    # the scan runs on each batch shard's plain tensors (`per_batch_shard`)
    ys, c, n, h, m = per_batch_shard(_slstm_scan, (pre, c, n, h, m) + mask,
                                     (p["r"].to(f32),))
    y = merged(ys, (B, S, di), H).to(x.dtype)
    out = L.dense(p["down"], L.norm(p["norm"], y), _j(name, "down"))
    return out, {"c": c, "n": n, "h": h, "m": m}


def _slstm_scan(batched, shared):
    """`slstm`'s recurrence, one step at a time: ``batched`` (pre (B, S,
    H, 4 hd), c, n, h, m[, length_mask]), ``shared`` (r,); returns (the
    outputs (B, S, H, hd), c, n, h, m)."""
    pre, c, n, h, m, *mask = batched
    (r,) = shared
    length_mask = mask[0] if mask else None
    hd = pre.shape[-1] // 4
    hs = []
    for t in range(pre.shape[1]):
        g = pre[:, t].to(r.dtype) + torch.einsum("bhk,hkj->bhj", h, r)
        i_t, f_t, z_t, o_t = torch.split(g, hd, dim=-1)
        i_t, f_t = i_t.mean(-1), f_t.mean(-1)       # scalar gates per head
        logf = F.logsigmoid(f_t)
        m_new = torch.maximum(logf + m, i_t)
        fs = torch.exp(logf + m - m_new)[..., None]
        is_ = torch.exp(i_t - m_new)[..., None]
        c_new = c * fs + is_ * torch.tanh(z_t)
        n_new = n * fs + is_
        h_new = torch.sigmoid(o_t) * c_new / torch.clamp_min(n_new, 1e-6)
        hs.append(h_new)
        if length_mask is None:
            c, n, h, m = c_new, n_new, h_new, m_new
        else:
            live = length_mask[:, t]
            c = torch.where(live[:, None, None], c_new, c)
            n = torch.where(live[:, None, None], n_new, n)
            h = torch.where(live[:, None, None], h_new, h)
            m = torch.where(live[:, None], m_new, m)
    return (torch.stack(hs, dim=1), c, n, h, m)


def slstm_init_state(B, cfg: XLSTMConfig, device="cuda"):
    """Zero state of B slots, all float32."""
    H, hd = cfg.n_heads, cfg.head_dim
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return {"c": z(B, H, hd), "n": z(B, H, hd), "h": z(B, H, hd),
            "m": z(B, H)}
