"""Roofline analysis (``repro.roofline.analysis`` counterpart): three terms
per (arch x shape x mesh) cell,

    compute term    = FLOPs / (devices * peak)
    memory term     = bytes / (devices * HBM_bw)
    collective term = collective_bytes / link_bw

FLOPs and HBM bytes come from an exact ANALYTIC enumerator over the
architecture's tensor ops, as implemented (full-square masked attention,
MoE capacity overcompute, the remat re-forward of training).  `hlo_flops`
and `hlo_bytes` keep the JAX package's names so that a reader finds their
counterparts; here they are analytic counts, not read from any compiled
program (the port has no HLO).  The enumerator clamps a sliding-window
arch's decode keys to the window, although both packages' decode masks
the whole cache rather than slicing it: the count is lower than what runs
(h2o-danube-3-4b at long_500k).  Collective bytes come from the dry-run
record (`repro_torch.launch.dryrun`), loop-scope bytes times the scan
repeats; a record of the port has them all at top level.  They are one
device's (the bytes its collectives bring in), so each device's link
carries them: the collective term divides them by the link rate only.
The JAX package divides them by the device count as well, which makes
its term 256 / 512 times smaller on the production meshes.

MODEL_FLOPS: 6*N*D (dense) / 6*N_active*D (MoE) for training; 2*N_active
per generated token for decode.  MODEL_FLOPS / FLOPs measures how much of
the executed compute is "useful".

The constants are those of the NVIDIA H100 SXM data sheet, dense (no
sparsity), at its 700 W board power.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.specs import SHAPES

# NVIDIA H100 SXM5 data sheet, dense tensor-core rates and HBM3 bandwidth
PEAK_BF16 = 989e12          # FLOP/s, BF16 tensor core
PEAK_INT8 = 1979e12         # op/s, INT8 tensor core
HBM_BW = 3.35e12            # B/s, HBM3
LINK_BW = 450e9             # B/s per direction, NVLink 4 (900 GB/s total)

#: the cells' shapes: `repro_torch.launch.specs.SHAPES` itself
SHAPE_META = SHAPES


# --------------------------------------------------------- parameter counts

def param_counts(cfg: ArchConfig) -> Dict[str, float]:
    """(total, active) parameter counts from the real init, on ``meta``
    (`transformer.param_shapes`)."""
    from repro_torch.models import transformer as T
    total = sum(leaf.numel() for leaf in T.tree_leaves(T.param_shapes(cfg)))
    active = total
    if cfg.moe is not None:
        E, K, F, D = (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff,
                      cfg.d_model)
        n_moe_layers = cfg.n_layers - cfg.moe_first_dense
        per_layer_experts = E * (3 if cfg.moe.gated else 2) * D * F
        active_frac = K / E
        active = total - n_moe_layers * per_layer_experts * (1 - active_frac)
    return {"total": float(total), "active": float(active)}


# --------------------------------------------------------- FLOPs enumerator

def _attn_flops(B, Sq, Sk, H, hd_qk, hd_v):
    """Full-square masked attention as implemented (scores + PV)."""
    return 2 * B * Sq * Sk * H * hd_qk + 2 * B * Sq * Sk * H * hd_v


def _block_fwd_flops(cfg: ArchConfig, kind: str, B: int, S: int,
                     cache_len: int | None) -> float:
    """Forward FLOPs of one block on (B, S) tokens (cache_len for decode)."""
    D = cfg.d_model
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lin = lambda i, o: 2.0 * B * S * i * o
    Sk = cache_len if cache_len is not None else S
    if cfg.sliding_window and kind in ("attn",):
        Sk = min(Sk, cfg.sliding_window) if cache_len is not None else Sk
    f = 0.0
    if kind in ("attn", "shared_attn", "dec"):
        f += lin(D, H * hd) + 2 * lin(D, KVH * hd) + lin(H * hd, D)
        f += _attn_flops(B, S, Sk, H, hd, hd)
        if kind == "dec":  # + cross attention to T_f frontend tokens
            Tf = cfg.frontend_tokens
            f += lin(D, H * hd) + lin(H * hd, D)
            f += _attn_flops(B, S, Tf, H, hd, hd)
        # FFN
        if cfg.moe is not None and kind == "attn":
            f += _moe_flops(cfg, B, S)
            if cfg.moe_dense_residual:
                f += (3 if cfg.gated_ffn else 2) * lin(D, cfg.dense_ff)
        elif cfg.d_ff:
            f += (3 if cfg.gated_ffn else 2) * lin(D, cfg.d_ff)
    elif kind == "mla":
        m = cfg.mla
        qd = m.qk_nope_dim + m.qk_rope_dim
        r = m.kv_lora_rank
        f += lin(D, H * qd) + lin(D, r + m.qk_rope_dim)
        if cache_len is not None:
            # ABSORBED decode: q/out folded through kv_b, attention over the
            # compressed latent (r) + rope dims
            f += 2.0 * B * H * m.qk_nope_dim * r       # q absorb
            f += 2.0 * B * H * Sk * (r + m.qk_rope_dim)  # scores
            f += 2.0 * B * H * Sk * r                  # latent-weighted sum
            f += 2.0 * B * H * r * m.v_head_dim        # output absorb
        else:
            f += lin(r, H * (m.qk_nope_dim + m.v_head_dim))
            f += _attn_flops(B, S, Sk, H, qd, m.v_head_dim)
        f += lin(H * m.v_head_dim, D)
        f += _moe_flops(cfg, B, S)
    elif kind == "cross":
        Tf = cfg.frontend_tokens
        f += lin(D, H * hd) + lin(H * hd, D)
        if cache_len is None:  # decode reuses prefill-cached cross KV
            f += 2 * 2.0 * B * Tf * D * KVH * hd        # kv projections
        f += _attn_flops(B, S, Tf, H, hd, hd)
        f += (3 if cfg.gated_ffn else 2) * lin(D, cfg.d_ff)
    elif kind == "mamba":
        di, N = 2 * D, cfg.ssm_state
        Hm, P = di // 64, 64
        f += lin(D, 2 * di + 2 * N + Hm) + lin(di, D)
        Q = min(256, S)
        nchunks = max(1, S // Q)
        # SSD chunk math: CB (2BQ^2N), W-apply (2BQ^2 Hm P), state io
        f += nchunks * (2.0 * B * Q * Q * N + 2.0 * B * Q * Q * Hm * P +
                        4.0 * B * Q * Hm * P * N)
    elif kind in ("mlstm", "slstm"):
        di = 2 * D
        Hx, hx = cfg.n_heads, di // cfg.n_heads
        if kind == "mlstm":
            # block-diagonal qkv: di*hd per matrix (not di^2)
            f += lin(D, 2 * di) + 3 * lin(di, hx) + lin(di, 2 * Hx) + lin(di, D)
            Q = min(256, S)
            nchunks = max(1, S // Q)
            f += nchunks * (4.0 * B * Q * Q * Hx * hx +       # qk + wv
                            4.0 * B * Q * Hx * hx * hx)       # state update
        else:
            f += lin(D, 4 * di) + lin(di, D)
            f += 2.0 * B * S * Hx * hx * 4 * hx               # recurrent mix
    else:
        raise ValueError(kind)
    return f


def _moe_flops(cfg: ArchConfig, B, S) -> float:
    """Dense-dispatch MoE as implemented (capacity buffers, not just top-k)."""
    m = cfg.moe
    D = cfg.d_model
    T = B * S
    G = max(1, min(256, T // 4096))  # matches moe_ffn's grouping heuristic
    Tg = T // G
    C = max(int(Tg * m.top_k * m.capacity_factor / m.n_experts), m.top_k)
    nmat = 3 if m.gated else 2
    f = 2.0 * T * D * m.n_experts                     # router
    f += 2 * 2.0 * G * Tg * m.n_experts * C * D       # dispatch + combine
    f += nmat * 2.0 * G * m.n_experts * C * D * m.d_ff  # expert FFNs
    if m.n_shared:
        f += nmat * 2.0 * T * D * (m.n_shared * m.d_ff)
    return f


def hlo_flops(cfg: ArchConfig, shape: str) -> Dict[str, float]:
    """Analytic as-implemented FLOPs of the cell (fwd / total / model);
    the JAX package's name, not an HLO count."""
    meta = SHAPE_META[shape]
    B, S = meta["batch"], meta["seq"]
    kind = meta["kind"]
    counts = param_counts(cfg)
    N, Na = counts["total"], counts["active"]

    cache_len = S if kind == "decode" else None
    s_eff = 1 if kind == "decode" else S

    fwd = 0.0
    period = len(cfg.pattern)
    reps = cfg.n_layers // period
    for k in cfg.pattern:
        fwd += reps * _block_fwd_flops(cfg, k, B, s_eff, cache_len)
    rem = cfg.n_layers - reps * period
    for i in range(rem):
        fwd += _block_fwd_flops(cfg, cfg.pattern[i % period], B, s_eff,
                                cache_len)
    if cfg.encoder_layers and kind != "decode":  # decode reuses enc memory
        Tf = cfg.frontend_tokens
        enc_cfg_ff = (2 if not cfg.gated_ffn else 3) * 2.0 * B * Tf * \
            cfg.d_model * cfg.d_ff
        enc_attn = (2 * 2.0 * B * Tf * cfg.d_model * cfg.n_heads * cfg.hd +
                    2 * 2.0 * B * Tf * cfg.d_model * cfg.n_kv_heads * cfg.hd +
                    _attn_flops(B, Tf, Tf, cfg.n_heads, cfg.hd, cfg.hd))
        fwd += cfg.encoder_layers * (enc_attn + enc_cfg_ff)
    # LM head
    fwd += 2.0 * B * s_eff * cfg.d_model * cfg.vocab

    if kind == "train":
        tokens = B * S
        total = fwd * 4.0            # fwd + 2x bwd + 1x remat re-forward
        model = 6.0 * Na * tokens
    elif kind == "prefill":
        total = fwd
        model = 2.0 * Na * B * S
    else:
        total = fwd
        model = 2.0 * Na * B
    return {"fwd": fwd, "total": total, "model": model,
            "params": N, "params_active": Na}


# --------------------------------------------------------- bytes enumerator

def hlo_bytes(cfg: ArchConfig, shape: str) -> float:
    """Idealized HBM traffic per step (reads + writes), global across
    devices; analytic, the JAX package's name.  Weight-byte width follows
    cfg.serve_weight_dtype and cache width the port's `cache_specs` (the
    int8 precision-domain variants)."""
    meta = SHAPE_META[shape]
    B, S = meta["batch"], meta["seq"]
    kind = meta["kind"]
    counts = param_counts(cfg)
    N = counts["total"]
    D = cfg.d_model
    F_eff = cfg.d_ff if cfg.d_ff else 2 * D
    if cfg.moe is not None:
        m = cfg.moe
        C_frac = m.top_k * m.capacity_factor  # capacity compute per token
        F_eff = m.d_ff * C_frac + (cfg.dense_ff if cfg.moe_dense_residual
                                   else 0) + m.n_shared * m.d_ff

    if kind == "train":
        opt_b = 2 if cfg.name == "arctic-480b" else 4   # moment dtype
        # params read (fwd+bwd+remat ~3x), grads w+r (f32), opt m,v r+w,
        # param write
        wb = N * (2 * 3 + 4 * 2 + 2 * opt_b * 2 + 2)
        act = cfg.n_layers * B * S * 2.0 * (8 * D + 3 * F_eff)
        return wb + act
    wbyte = 1.0 if cfg.serve_weight_dtype == "int8" else 2.0
    if kind == "prefill":
        wb = wbyte * N
        act = cfg.n_layers * B * S * 2.0 * (6 * D + 2 * F_eff)
        cache = _cache_bytes(cfg, B, S)
        return wb + act + cache
    # decode: all weights + full cache read + small activations
    wb = wbyte * N
    cache = _cache_bytes(cfg, B, S)
    act = cfg.n_layers * B * 2.0 * (6 * D + 2 * F_eff)
    return wb + cache + act


def _cache_bytes(cfg: ArchConfig, B, S) -> float:
    """KV-cache / state bytes, as the port's `cache_specs` allocates."""
    from repro_torch.models import transformer as T
    return float(sum(leaf.numel() * leaf.element_size()
                     for leaf in T.tree_leaves(T.cache_specs(cfg, B, S))))


# --------------------------------------------------------- the three terms

@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    chips: int
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float
    hlo_flops: float
    useful_ratio: float
    collective_bytes: float
    note: str = ""

    @property
    def terms(self):
        return {"compute": self.t_compute, "memory": self.t_memory,
                "collective": self.t_collective}


def collective_bytes_from_record(rec: dict) -> float:
    """Scan-aware total: top-level once + loop-scope x scan repeats."""
    tot = 0.0
    R = rec.get("scan_repeats", 1)
    for op, scopes in rec["collectives"]["bytes"].items():
        tot += scopes["top"] + R * scopes["loop"]
    return tot


def analyze_cell(rec: dict, peak=PEAK_BF16, hbm=HBM_BW, link=LINK_BW):
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch.dryrun import VARIANTS
    cfg = cfgbase.get(rec["arch"])
    var = rec.get("variant", "base")
    if VARIANTS.get(var):
        cfg = dataclasses.replace(cfg, **VARIANTS[var])
    shape = rec["shape"]
    chips = rec["n_devices"]
    fl = hlo_flops(cfg, shape)
    by = hlo_bytes(cfg, shape)
    cb = collective_bytes_from_record(rec)
    t_c = fl["total"] / (chips * peak)
    t_m = by / (chips * hbm)
    t_l = cb / link
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_l)),
              key=lambda kv: kv[1])[0]
    return Roofline(
        arch=rec["arch"], shape=shape, chips=chips,
        t_compute=t_c, t_memory=t_m, t_collective=t_l, dominant=dom,
        model_flops=fl["model"], hlo_flops=fl["total"],
        useful_ratio=fl["model"] / max(fl["total"], 1.0),
        collective_bytes=cb)


def load_records(dryrun_dir: str | Path, tag="sp"):
    recs = []
    for f in sorted(Path(dryrun_dir).glob(f"*__{tag}.json")):
        recs.append(json.loads(f.read_text()))
    return recs


def markdown_table(rooflines, records_by_key=None) -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS | HLO_FLOPs | useful | action on dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rooflines:
        act = {
            "compute": "raise useful ratio (cut full-square attn waste / "
                       "capacity overcompute; int8 domains 2x peak)",
            "memory": "cut HBM traffic (int8/ternary weights via ODiMO "
                      "domains, fuse, larger arithmetic intensity)",
            "collective": "re-shard to cut resharding collectives / overlap "
                          "with compute",
        }[r.dominant]
        lines.append(
            f"| {r.arch} | {r.shape} | {r.t_compute:.3e} | {r.t_memory:.3e} "
            f"| {r.t_collective:.3e} | **{r.dominant}** | "
            f"{r.model_flops:.3e} | {r.hlo_flops:.3e} | "
            f"{r.useful_ratio:.2f} | {act} |")
    return "\n".join(lines)


def records_table(recs) -> str:
    """One row per dry-run record: its status, trace s, and per device
    FLOPs, temp GiB and collective GiB, with the roofline's dominant
    term (a skipped cell: its reason), and the device the step was traced
    on with its long attention's path (a train cell's memory is that of
    the chunked plain attention on CPU fake tensors)."""
    from repro_torch.launch.dryrun import long_attention
    lines = ["| arch | shape | mesh | status | traced on | trace s | "
             "FLOPs / device | temp GiB / device | collective GiB / device "
             "| dominant |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for rec in recs:
        mesh = "x".join(map(str, rec.get("mesh") or
                            ([2, 16, 16] if rec["multi_pod"] else [16, 16])))
        if rec.get("status") != "ok":
            lines.append(f"| {rec['arch']} | {rec['shape']} | {mesh} | "
                         f"{rec['status']} | — | — | — | — | — | "
                         f"{rec.get('reason', '')[:50]} |")
            continue
        mem = rec["memory_analysis"]
        dev = rec.get("device", "cpu")
        path = rec.get("long_attention") or long_attention(
            "cpu" if dev == "cpu" else "cuda")
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {mesh} | ok | "
            f"{'cpu' if dev == 'cpu' else 'cuda'}, {path} | "
            f"{rec['trace_s']:.1f} | {rec['cost_analysis']['flops']:.4e} | "
            f"{mem['temp_size_in_bytes'] / 2**30:.3f} | "
            f"{collective_bytes_from_record(rec) / 2**30:.3f} | "
            f"{analyze_cell(rec).dominant} |")
    return "\n".join(lines)


def main(argv=None):
    """``python -m repro_torch.roofline.analysis [--dryrun-dir D] [--tag
    T] [--records]``: the table of the dry-run records in D (the single
    mesh's, ``build/dryrun_torch/single``, by default) at the H100
    constants; ``--records`` the records' own table (`records_table`)."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="build/dryrun_torch/single")
    ap.add_argument("--tag", default="sp")
    ap.add_argument("--records", action="store_true")
    args = ap.parse_args(argv)
    from repro_torch.configs import base as cfgbase
    cfgbase.load_all()
    if args.records:
        print(records_table(load_records(args.dryrun_dir, args.tag)))
        return
    out = []
    for rec in load_records(args.dryrun_dir, args.tag):
        if rec.get("status") != "ok":
            print(f"| {rec['arch']} | {rec['shape']} | — skipped: "
                  f"{rec.get('reason','')[:60]} |")
            continue
        out.append(analyze_cell(rec))
    print(markdown_table(out))


if __name__ == "__main__":
    main()
