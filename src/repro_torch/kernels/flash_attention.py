"""Causal flash attention with online softmax and grouped-query heads:
q (B, H, Sq, D) x k, v (B, KVH, Sk, D) -> (B, H, Sq, D), query head h
reading KV head ``h // (H // KVH)``.

The CUDA kernel (``csrc/flash_attention.cu``, sm_90a) replaces the Pallas
TPU kernel ``flash_attention`` of ``repro/kernels/flash_attention.py``.
What it computes is the TPU kernel's function: scores ``q k^T * D**-0.5``
summed in float32, the causal mask ``kpos <= qpos`` (positions from 0),
keys at ``kpos >= kv_len`` masked, running max and denominator in float32,
``p`` rounded to ``v.dtype`` before the PV product, a float32 accumulator
and ``acc / max(l, 1e-30)`` stored as bf16.  What bounds it on an H100 at
the prefill shapes: bf16 tensor-core operations (4 * D flops per causal
(query, key) pair), not bytes.  Each block owns 128 query rows of one head,
64 per consumer warpgroup; a producer thread streams K / V tiles of 128
keys by TMA through a 2-stage ring, and the consumers run ``wgmma`` bf16 ->
f32 for QK^T (both operands from shared memory) and PV (P from registers)
with the softmax in registers.  Key tiles wholly above the diagonal or
past ``kv_len`` are never loaded.

`flash_attention` launches the kernel for CUDA tensors and runs
`flash_attention_plain` only for CPU tensors.  ``flash_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: head dims the kernel is instantiated for: yi-9b's 128 and the reduced
#: yi-9b's 16
HEAD_DIMS = (16, 128)
#: query rows per plain-version step: bounds its float32 score block
PLAIN_Q_BLOCK = 512


def _check(q, k, v, kv_len):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (B, H, Sq, D) and two "
                         f"(B, KVH, Sk, D)")
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KVH == 0 or H % KVH or not Sk:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch "
                         f"or head dim differ, H is not a multiple of KVH, "
                         f"or there are no keys")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    if kv_len is not None and (isinstance(kv_len, torch.Tensor)
                               or int(kv_len) < 1):
        raise ValueError(f"kv_len must be None or an int >= 1, got {kv_len}")
    return B, H, KVH, Sq, Sk, D


def _scores(qb, k, q0, causal, kv_len):
    """float32 scores of query rows ``q0 ..`` (B, KVH, G, n, D) against k
    (B, KVH, Sk, D), and the mask of the keys each row may read."""
    D, Sk = k.shape[-1], k.shape[2]
    s = torch.einsum("bkgqd,bksd->bkgqs", qb.to(torch.float32),
                     k.to(torch.float32)) * D ** -0.5
    kpos = torch.arange(Sk, device=k.device)[None, :]
    qpos = q0 + torch.arange(qb.shape[3], device=k.device)[:, None]
    mask = torch.ones((qb.shape[3], Sk), dtype=torch.bool, device=k.device)
    if causal:
        mask &= kpos <= qpos
    if kv_len is not None:
        mask &= kpos < kv_len
    return s, mask


def flash_attention_plain(q, k, v, *, causal=True, kv_len=None):
    """Plain PyTorch version of the kernel's arithmetic: float32 scores,
    ``p = exp(s - rowmax)`` rounded to ``v.dtype`` for the PV product,
    float32 denominator of the unrounded ``p``, ``acc / max(l, 1e-30)``.
    Rows are independent, so it runs `PLAIN_Q_BLOCK` query rows at a time
    to bound its float32 score block."""
    B, H, KVH, Sq, Sk, D = _check(q, k, v, kv_len)
    G = H // KVH
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    vf = v.to(torch.float32)
    for q0 in range(0, Sq, PLAIN_Q_BLOCK):
        n = min(PLAIN_Q_BLOCK, Sq - q0)
        qb = q[:, :, q0:q0 + n].reshape(B, KVH, G, n, D)
        s, mask = _scores(qb, k, q0, causal, kv_len)
        s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bkgqs,bksd->bkgqd",
                           p.to(v.dtype).to(torch.float32), vf)
        o = acc / l.clamp_min(1e-30)
        out[:, :, q0:q0 + n] = o.reshape(B, H, n, D).to(q.dtype)
    return out


def flash_attention_ref(q, k, v, causal=True, kv_len=None):
    """Oracle (``repro.kernels.ref.flash_attention_ref``): float32 softmax
    and PV, output in ``q.dtype``; keys at ``kpos >= kv_len`` masked."""
    B, H, KVH, Sq, Sk, D = _check(q, k, v, kv_len)
    G = H // KVH
    s, mask = _scores(q.reshape(B, KVH, G, Sq, D), k, 0, causal, kv_len)
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return o.reshape(B, H, Sq, D).to(q.dtype)


def _strides_ok(t) -> bool:
    """The kernel reads ``t`` through its strides, by TMA: a unit stride in
    D, the others multiples of 8 elements (16 bytes), a 16-byte-aligned
    base."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1]))


def flash_attention(q, k, v, *, causal=True, kv_len=None, out=None):
    """q (B, H, Sq, D); k, v (B, KVH, Sk, D) with H = KVH * G; kv_len: None
    or an int >= 1 (keys at ``kpos >= kv_len`` are masked).  Any strides
    with a unit stride in D (the model's (B, S, H, D) layout as a permuted
    view).  ``out``: optional (B, H, Sq, D) view to write, e.g. a permuted
    view of a (B, Sq, H, D) buffer.  CUDA operands must be bf16 with D in
    `HEAD_DIMS`."""
    B, H, KVH, Sq, Sk, D = _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        o = flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
        return o if out is None else out.copy_(o)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for {q.device}")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"bf16 operands expected, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    elif (tuple(out.shape) != tuple(q.shape) or out.dtype != q.dtype
          or out.device != q.device or not _strides_ok(out)):
        raise ValueError("out must be a bf16 (B, H, Sq, D) view on q's "
                         "device with the kernel's stride layout")
    q, k, v = (t if _strides_ok(t) else t.contiguous() for t in (q, k, v))
    kv_end = Sk if kv_len is None else min(Sk, int(kv_len))
    if B * H and Sq:
        _build.launch(
            "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, H, KVH, Sq, kv_end, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
        flash_attention.launches += 1
    return out


flash_attention.launches = 0



def flash_error_bound(q, k, v, o_plain, *, kv_len=None):
    """Worst-case |kernel - plain version| of each output element, from
    where the two round differently (float64, (B, H, Sq, D)):

    * ``p`` rounded to bf16 for PV, each within a relative 2**-8 of its
      float32 value, in the kernel against its running max and in the
      plain version against the row max: 2 * 2**-8 * max|v|, since the
      weights ``p / l`` sum to 1;
    * the float32 scores: D products summed in another order, then scaled
      (the kernel in the log2 domain) and exponentiated, each within
      ``ds = (D + 4) * 2**-23 * smax + 2**-21`` of the exact score, smax =
      ``D**-0.5 * |q_i| * max_j |k_j|``; a relative error 2 ds in each
      ``p`` moves numerator and denominator, 8 ds * max|v| for the two;
    * the float32 sums of PV and of ``l`` over at most ``kv_end`` keys:
      ``kv_end * 2**-21 * max|v|`` for the two;
    * the final rounding to bf16 of both outputs: 2**-7 * |o_plain| (one
      bf16 step), and the factor 1 + 2**-7 on the rest.

    max|v| and max|k_j| are taken per (batch, KV head) over the keys the
    call reads."""
    B, H, KVH, Sq, Sk, D = _check(q, k, v, kv_len)
    G = H // KVH
    kv_end = Sk if kv_len is None else min(Sk, int(kv_len))
    f64 = torch.float64

    def per_head(t):   # (B, KVH) -> (B, H, 1, 1)
        return t.repeat_interleave(G, dim=1)[:, :, None, None]
    vmax = per_head(v[:, :, :kv_end].to(f64).abs().amax(dim=(2, 3)))
    kn = per_head(k[:, :, :kv_end].to(f64).norm(dim=-1).amax(dim=2))
    smax = D ** -0.5 * q.to(f64).norm(dim=-1, keepdim=True) * kn
    ds = (D + 4) * 2.0**-23 * smax + 2.0**-21
    u = 2.0**-7
    return (1 + u) * ((u + 8 * ds + kv_end * 2.0**-21) * vmax
                      + u * o_plain.to(f64).abs())
