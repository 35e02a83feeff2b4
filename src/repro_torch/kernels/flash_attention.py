"""Causal flash attention with online softmax and grouped-query heads:
q (B, H, Sq, D) x k (B, KVH, Sk, D), v (B, KVH, Sk, Dv) -> (B, H, Sq, Dv),
query head h reading KV head ``h // (H // KVH)``.  The value head dim Dv
is D, or 128 beside deepseek's MLA query / key dim 192 (128 nope + 64
rope).

The CUDA kernel (``csrc/flash_attention.cu``, sm_90a) replaces the Pallas
TPU kernel ``flash_attention`` of ``repro/kernels/flash_attention.py``.
What it computes is the TPU kernel's function: scores ``q k^T * D**-0.5``
summed in float32, the causal mask ``kpos <= qpos`` (positions from 0),
keys at ``kpos >= kv_len`` masked, and with a sliding ``window`` the keys
at ``kpos <= qpos - window`` (the JAX model's ``chunked_attention(window=)``,
which the Pallas kernel has no form of), running max and denominator in
float32,
``p`` rounded to ``v.dtype`` before the PV product, a float32 accumulator
and ``acc / max(l, 1e-30)`` stored as bf16.  What bounds it on an H100 at
the prefill shapes: bf16 tensor-core operations (4 * D flops per causal
(query, key) pair), not bytes.  Each block owns 128 query rows of one head,
64 per consumer warpgroup; a producer thread streams K / V tiles of 128
keys by TMA through a 2-stage ring, and the consumers run ``wgmma`` bf16 ->
f32 for QK^T (both operands from shared memory) and PV (P from registers)
with the softmax in registers.  Key tiles wholly above the diagonal, past
``kv_len`` or below the window are never loaded.  Head dim 120
(h2o-danube) is laid out as 128 in shared memory, its last 8 columns
zero-filled by TMA and never stored; the V tiles take their own width,
so MLA's 192 / 128 block fits the card's shared memory.

`flash_attention` launches the kernel for CUDA tensors and runs
`flash_attention_plain` only for CPU tensors.  ``flash_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: (D, Dv, windowed) the kernel is instantiated for, the one list of them
#: (`_build` hands it to the source as ``FLASH_SHAPES``): query / key head
#: dims 128 (yi-9b, nemotron, command-r), 120 (h2o-danube), 64
#: (zamba2-1.2b) and 16 (the reduced configs), each with and without the
#: sliding window, and deepseek's MLA, 192 beside a value dim of 128, with
#: no window
SHAPES = ((16, 16, True), (64, 64, True), (120, 120, True), (128, 128, True),
          (192, 128, False))
HEAD_DIMS = tuple(d for d, _, _ in SHAPES)
_WINDOWED = {(d, dv): w for d, dv, w in SHAPES}
NVCC_DEFINES = {"FLASH_SHAPES": " ".join(
    f"X({d}, {dv}, {str(w).lower()})" for d, dv, w in SHAPES)}
#: query rows per plain-version step: bounds its float32 score block
PLAIN_Q_BLOCK = 512


def _check(q, k, v, kv_len, window=None):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (B, H, Sq, D), (B, "
                         f"KVH, Sk, D) and (B, KVH, Sk, Dv)")
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
    if window is not None and (isinstance(window, torch.Tensor)
                               or int(window) < 1):
        raise ValueError(f"window must be None or an int >= 1, got {window}")
    return B, H, KVH, Sq, Sk, D, v.shape[3]


def _scores(qb, k, q0, causal, kv_len, window=None):
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
    if window is not None:
        mask &= kpos > qpos - window
    return s, mask


def flash_attention_plain(q, k, v, *, causal=True, kv_len=None,
                          window=None):
    """Plain PyTorch version of the kernel's arithmetic: float32 scores,
    ``p = exp(s - rowmax)`` rounded to ``v.dtype`` for the PV product,
    float32 denominator of the unrounded ``p``, ``acc / max(l, 1e-30)``
    (0 for a row that the mask leaves no key).  Rows are independent, so
    it runs `PLAIN_Q_BLOCK` query rows at a time to bound its float32
    score block."""
    B, H, KVH, Sq, Sk, D, Dv = _check(q, k, v, kv_len, window)
    G = H // KVH
    out = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    vf = v.to(torch.float32)
    for q0 in range(0, Sq, PLAIN_Q_BLOCK):
        n = min(PLAIN_Q_BLOCK, Sq - q0)
        qb = q[:, :, q0:q0 + n].reshape(B, KVH, G, n, D)
        s, mask = _scores(qb, k, q0, causal, kv_len, window)
        s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bkgqs,bksd->bkgqd",
                           p.to(v.dtype).to(torch.float32), vf)
        o = acc / l.clamp_min(1e-30)
        out[:, :, q0:q0 + n] = o.reshape(B, H, n, Dv).to(q.dtype)
    return out


def flash_attention_ref(q, k, v, causal=True, kv_len=None, window=None):
    """Oracle (``repro.kernels.ref.flash_attention_ref``): float32 softmax
    and PV, output in ``q.dtype``; keys at ``kpos >= kv_len`` and, with a
    ``window``, at ``kpos <= qpos - window`` masked; 0 for a row that the
    mask leaves no key, as the kernel stores."""
    B, H, KVH, Sq, Sk, D, Dv = _check(q, k, v, kv_len, window)
    G = H // KVH
    s, mask = _scores(q.reshape(B, KVH, G, Sq, D), k, 0, causal, kv_len,
                      window)
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    p = p * mask.any(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return o.reshape(B, H, Sq, Dv).to(q.dtype)


def _strides_ok(t) -> bool:
    """The kernel reads ``t`` through its strides, by TMA: a unit stride in
    D, the others multiples of 8 elements (16 bytes), a 16-byte-aligned
    base."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1]))


def flash_attention(q, k, v, *, causal=True, kv_len=None, window=None,
                    out=None):
    """q (B, H, Sq, D); k (B, KVH, Sk, D), v (B, KVH, Sk, Dv) with H = KVH *
    G; kv_len: None
    or an int >= 1 (keys at ``kpos >= kv_len`` are masked); window: None
    or an int >= 1 (keys at ``kpos <= qpos - window`` are masked).  Any
    strides with a unit stride in D (the model's (B, S, H, D) layout as a
    permuted view).  ``out``: optional (B, H, Sq, Dv) view to write, e.g. a
    permuted view of a (B, Sq, H, Dv) buffer; the kernel writes its Dv
    columns only.  CUDA operands must be bf16 with (D, Dv) a pair of
    `SHAPES`, and a window only where it is instantiated with one: another
    call raises, there is no fallback."""
    B, H, KVH, Sq, Sk, D, Dv = _check(q, k, v, kv_len, window)
    if q.device.type == "cpu":
        o = flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                  window=window)
        return o if out is None else out.copy_(o)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for {q.device}")
    _build.refuse_grad("flash_attention", q, k, v, out)
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"bf16 operands expected, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    windowed = _WINDOWED.get((D, Dv))
    if windowed is None:
        raise ValueError(f"head dims (D, Dv) = ({D}, {Dv}): the kernel is "
                         f"instantiated for {[s[:2] for s in SHAPES]}")
    if window is not None and not windowed:
        raise ValueError(f"no window at head dims ({D}, {Dv}): the kernel "
                         f"is instantiated without one there")
    if out is None:
        out = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    elif (tuple(out.shape) != (B, H, Sq, Dv) or out.dtype != q.dtype
          or out.device != q.device or not _strides_ok(out)):
        raise ValueError("out must be a bf16 (B, H, Sq, Dv) view on q's "
                         "device with the kernel's stride layout")
    q, k, v = (t if _strides_ok(t) else t.contiguous() for t in (q, k, v))
    kv_end = Sk if kv_len is None else min(Sk, int(kv_len))
    if B * H and Sq:
        _build.launch(
            "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, H, KVH, Sq, kv_end, D, Dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(bool(causal)), int(window or 0),
            torch.cuda.current_stream(q.device).cuda_stream)
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_error_bound(q, k, v, o_plain, *, kv_len=None):
    """Worst-case |kernel - plain version| of each output element, from
    where the two round differently (float64, (B, H, Sq, Dv); D below is
    the query / key head dim):

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
    B, H, KVH, Sq, Sk, D, _ = _check(q, k, v, kv_len)
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
