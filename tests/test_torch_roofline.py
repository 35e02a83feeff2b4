"""The port's roofline enumerator (`repro_torch.roofline.analysis`) against
the JAX package's: parameter counts of all ten archs, the analytic FLOPs
and bytes of every runnable (arch, shape, variant) cell, `analyze_cell`'s
terms at JAX's constants (the collective term the devices times JAX's: the
port divides one device's bytes by the link rate only), `markdown_table`'s text; the enumerator against
``FlopCounterMode`` on one full-width block on ``meta`` (the bands of
``tests/test_roofline_crosscheck.py``), and the gap of the window clamp on
h2o-danube's decode, exactly the attention past the window.

The port's `cache_specs` keep the Mamba2 / mLSTM conv carries in the
parameter dtype and the cross-attention memory in bfloat16 whatever the KV
dtype (the JAX package gives them the KV dtype): under an int8 KV variant
the bytes differ by exactly those leaves, which the bytes test checks."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.launch import dryrun as jdry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.roofline import analysis as JRA  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.core import tree as _tree  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

ARCHS = ("arctic-480b", "command-r-35b", "deepseek-v2-lite-16b",
         "h2o-danube-3-4b", "llama-3.2-vision-11b", "nemotron-4-15b",
         "seamless-m4t-large-v2", "xlstm-1.3b", "yi-9b", "zamba2-1.2b")
#: cache leaves whose dtype the port fixes whatever the KV dtype
PORT_DTYPE_LEAVES = ("conv", "ck", "cv")


@pytest.fixture(scope="module", autouse=True)
def _load():
    jbase.load_all()
    cfgbase.load_all()


def _jcfg(arch, variant="base"):
    cfg = jbase.get(arch)
    return dataclasses.replace(cfg, **jdry.VARIANTS[variant]) \
        if jdry.VARIANTS[variant] else cfg


def test_ten_archs():
    assert tuple(cfgbase.names()) == ARCHS == tuple(jbase.names())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_jax(arch):
    assert RA.param_counts(cfgbase.get(arch)) == \
        JRA.param_counts(jbase.get(arch))


@pytest.fixture()
def memo_counts(monkeypatch):
    """Both packages' `param_counts` memoized per config (they depend on
    the shapes alone; `test_param_counts_equal_jax` holds them equal)."""
    monkeypatch.setattr(RA, "param_counts",
                        functools.lru_cache(None)(RA.param_counts))
    monkeypatch.setattr(JRA, "param_counts",
                        functools.lru_cache(None)(JRA.param_counts))


def _cache_dtype_gap(cfg, jcfg, B, S) -> float:
    """Port cache bytes less JAX's, from the leaves whose dtype differs
    (which must be the documented ones)."""
    import numpy as np
    ours = _tree.leaves_with_paths(T.cache_specs(cfg, B, S))
    theirs = _tree.leaves_with_paths(
        JT.cache_specs(jcfg, B, S),
        is_leaf=lambda n: hasattr(n, "dtype") and hasattr(n, "shape"))
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    gap = 0.0
    for (path, a), (_, b) in zip(ours, theirs):
        assert tuple(a.shape) == tuple(b.shape), path
        ja = np.dtype(b.dtype).itemsize
        if a.element_size() != ja:
            assert path[-1] in PORT_DTYPE_LEAVES, path
            gap += a.numel() * (a.element_size() - ja)
    return gap


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_and_bytes_equal_jax(arch, memo_counts):
    n = 0
    for shape in SP.SHAPES:
        for variant in D.VARIANTS:
            cfg = D.cell_config(arch, variant)
            jcfg = _jcfg(arch, variant)
            if not SP.cell_is_runnable(cfg, shape):
                continue
            n += 1
            ours, theirs = RA.hlo_flops(cfg, shape), JRA.hlo_flops(jcfg, shape)
            assert ours.keys() == theirs.keys()
            for k in ours:
                assert ours[k] == pytest.approx(theirs[k], rel=1e-12), \
                    (shape, variant, k)
            meta = SP.SHAPES[shape]
            gap = (0.0 if meta["kind"] == "train" else
                   _cache_dtype_gap(cfg, jcfg, meta["batch"], meta["seq"]))
            if variant in ("base", "wq8"):
                assert gap == 0.0
            assert RA.hlo_bytes(cfg, shape) == pytest.approx(
                JRA.hlo_bytes(jcfg, shape) + gap, rel=1e-12), (shape, variant)
    assert n >= 12


def _record(arch, shape, devices=256):
    return {"arch": arch, "shape": shape, "variant": "base",
            "n_devices": devices, "scan_repeats": 4, "status": "ok",
            "collectives": {"bytes": {
                c: {"top": 1e6 * (i + 1), "loop": 3e5 * i}
                for i, c in enumerate(D.COLLECTIVES)}}}


CELLS = [("yi-9b", "decode_32k"), ("zamba2-1.2b", "long_500k"),
         ("deepseek-v2-lite-16b", "train_4k"),
         ("seamless-m4t-large-v2", "prefill_32k")]


def test_analyze_cell_and_table_equal_jax(memo_counts):
    ours, theirs = [], []
    for arch, shape in CELLS:
        rec = _record(arch, shape)
        a = RA.analyze_cell(rec, peak=JRA.PEAK_BF16, hbm=JRA.HBM_BW,
                            link=JRA.LINK_BW)
        b = JRA.analyze_cell(rec)
        # the record's collective bytes are one device's: the port divides
        # them by the link rate, JAX by the device count as well
        want = dict(b.terms, collective=b.t_collective * rec["n_devices"])
        for k, v in a.terms.items():
            assert v == pytest.approx(want[k], rel=1e-12), (arch, k)
        assert a.dominant == max(want, key=want.get)
        for k in ("model_flops", "hlo_flops", "useful_ratio",
                  "collective_bytes"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), rel=1e-12)
        ours.append(a)
        theirs.append(b)
    # same rooflines -> same text
    assert RA.markdown_table(theirs) == JRA.markdown_table(theirs)
    assert RA.markdown_table(ours).splitlines()[:2] == \
        JRA.markdown_table(theirs).splitlines()[:2]


def test_h100_constants():
    assert (RA.PEAK_BF16, RA.PEAK_INT8, RA.HBM_BW, RA.LINK_BW) == \
        (989e12, 1979e12, 3.35e12, 450e9)
    rec = _record("yi-9b", "decode_32k", devices=1)
    r = RA.analyze_cell(rec)
    cfg = cfgbase.get("yi-9b")
    assert r.t_memory == RA.hlo_bytes(cfg, "decode_32k") / 3.35e12


# ------------------------------------------------------ counter cross-check

def _block_counted(cfg, kind, B, S, cache=None, cache_index=None):
    p = T.init_block(T.MetaGenerator(), cfg, kind)
    x = torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16, device="meta")
    pos = torch.zeros((1, S), dtype=torch.int32, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        T.block_apply(p, x, kind, cfg, pos, cache=cache,
                      cache_index=cache_index)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,kind,band", [
    ("yi-9b", "attn", (0.8, 1.2)),
    ("nemotron-4-15b", "attn", (0.8, 1.2)),
    ("h2o-danube-3-4b", "attn", (0.8, 1.2)),
    # MoE routing one-hots / cumsums: the wider band of the JAX test
    ("deepseek-v2-lite-16b", "mla", (0.6, 1.3)),
])
def test_enumerator_matches_counter_on_a_full_width_block(arch, kind, band):
    cfg = cfgbase.get(arch)
    B, S = 1, 128
    counted = _block_counted(cfg, kind, B, S)
    ratio = RA._block_fwd_flops(cfg, kind, B, S, None) / counted
    assert band[0] <= ratio <= band[1], (arch, ratio)


def test_window_clamp_gap_on_h2o_decode():
    """The enumerator clamps h2o's decode keys to its window; the decode
    masks the whole cache: one block's counted FLOPs exceed the
    enumerator's by exactly the attention over the keys past the
    window."""
    cfg = cfgbase.get("h2o-danube-3-4b")
    B, Sk, W = 1, 32768, cfg.sliding_window
    assert W and W < Sk
    shape = (B, Sk, cfg.n_kv_heads, cfg.hd)
    cache = {k: torch.empty(shape, dtype=torch.bfloat16, device="meta")
             for k in ("k", "v")}
    counted = _block_counted(cfg, "attn", B, 1, cache=cache,
                             cache_index=Sk - 1)
    enumerated = RA._block_fwd_flops(cfg, "attn", B, 1, Sk)
    H, hd = cfg.n_heads, cfg.hd
    gap = RA._attn_flops(B, 1, Sk, H, hd, hd) - \
        RA._attn_flops(B, 1, W, H, hd, hd)
    assert counted - enumerated == gap
    assert counted / enumerated > 2
