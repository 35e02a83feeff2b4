"""The port's CUDA kernels against their plain PyTorch versions on the
card (marker ``gpu``): bit for bit for the integer contractions, within
the float32 summation bound ``K * 2**-24 * sum_k |x * w| + 2**-24 * |y|``
for the bf16 columns of split_precision, within `flash_error_bound` (the
bf16 rounding of ``p`` and of the output, and the float32 sums) for
flash attention.  Each test decides inside its fixture
whether a card is present and skips here otherwise; run them on a machine
with an H100 with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.quant_matmul import (quant_matmul,  # noqa: E402
                                              quant_matmul_plain)
from repro_torch.kernels.split_precision import (  # noqa: E402
    bf16_error_bound, split_precision, split_precision_plain)
from repro_torch.kernels.split_ternary import (split_ternary,  # noqa: E402
                                               split_ternary_plain)
from repro_torch.kernels.ternary_matmul import (  # noqa: E402
    ternary_matmul, ternary_matmul_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain, flash_error_bound)
from repro_torch.kernels.ternary_packed import (  # noqa: E402
    pack_ternary, ternary_packed_matmul, ternary_packed_plain)
from repro_torch.models import _backend  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

pytestmark = pytest.mark.gpu

SHAPES = [(1, 8, 4), (3, 37, 130), (4, 4096, 512), (17, 256, 200),
          (64, 11008, 384), (130, 1000, 64)]


@pytest.fixture
def cuda():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        yield torch.device("cuda")
    finally:
        torch.set_num_threads(threads)


def _operands(m, k, n, seed, dev):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    t = torch.from_numpy(rng.integers(-1, 2, (k, n), dtype=np.int8))
    sx = torch.tensor(float(rng.uniform(0.01, 0.1)), dtype=torch.float32)
    sw = torch.from_numpy(rng.uniform(1e-3, 0.5, n).astype(np.float32))
    return [a.to(dev) for a in (x, w, t, sx, sw)]


#: SHAPES plus M off the wgmma kernel's 128-row tile (17, 100, 300) and N
#: off its 128- and 256-column tiles, and M 1, 4, 16 of the decode GEMM's
#: K-major loader (K 1000 padded to 1008, N 700 off its 64-column tile)
QUANT_SHAPES = SHAPES + [(17, 4096, 1000), (100, 1000, 4100),
                         (300, 4096, 640), (300, 11008, 130),
                         (1, 4096, 4096), (4, 11008, 4096), (16, 1000, 700)]


@pytest.mark.parametrize("layout", ["row_major", "k_major"])
@pytest.mark.parametrize("m,k,n", QUANT_SHAPES)
def test_quant_matmul_kernel_bit_exact(cuda, m, k, n, layout):
    """Both weight layouts bit for bit; the row-major one is copied into
    the kernel's K-major layout, a K-major one with K off the multiple of
    16 copied zero-padded (one counted copy per call either way)."""
    x, w, _, sx, sw = _operands(m, k, n, 0, cuda)
    if layout == "k_major":
        w = w.t().contiguous().t()
    before = quant_matmul.launches
    copies = quant_matmul.transposed_copies
    got = quant_matmul(x, w, sx, sw)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert quant_matmul.transposed_copies == copies + (
        layout == "row_major" or k % 16 != 0)
    assert torch.equal(got, quant_matmul_plain(x, w, sx, sw))


#: SHAPES plus the wgmma GEMM's M (17, 100, 300, 512) at N 1000 (padded to
#: 1008) and K 1000 (padded to 1008)
PACKED_SHAPES = SHAPES + [(17, 4096, 1000), (100, 1000, 512),
                          (300, 4096, 1000), (512, 4096, 512),
                          (512, 1000, 1000)]


@pytest.mark.parametrize("layout", ["row_major", "k_major"])
@pytest.mark.parametrize("m,k,n", PACKED_SHAPES)
@pytest.mark.parametrize("where", ["zero", "raw", "aligned", "all"])
def test_split_ternary_kernel_bit_exact(cuda, m, k, n, where, layout):
    """Both layouts of w_q bit for bit, with the split probes: w_q holds 99
    at and above the boundary, the packed stream 0xFF (a 2 in every 2-bit
    field) below it, and neither may reach the output.  A copy of w_q
    (row-major, or K or N off the kernel's alignment) or of the stream (N
    off it) is counted once per copied weight."""
    from repro_torch.kernels.split_ternary import weight_route
    x, w, t, sx, sw = _operands(m, k, n, 1, cuda)
    raw = min(7, n)
    boundary = {"zero": 0, "raw": raw, "all": n,
                "aligned": min(ops.align_boundary(raw, 128), n)}[where]
    cols = torch.arange(n, device=cuda)[None, :]
    w_q = torch.where(cols < boundary, w, t)
    k4 = -(-k // 4) * 4
    w_t = torch.nn.functional.pad(torch.where(cols >= boundary, t, 0),
                                  (0, 0, 0, k4 - k))
    w_p = pack_ternary(w_t)
    # columns read from the packed stream hold garbage in w_q, columns
    # read from w_q garbage in the stream: the kernel must read neither
    probe = torch.where(cols < boundary, w_q, 99).to(torch.int8)
    probe_p = torch.where(cols < boundary, 0xFF, w_p).to(torch.uint8)
    if layout == "k_major":
        probe = probe.t().contiguous().t()
    align = 16 if m > 16 else 4
    route = weight_route(tuple(probe.shape), probe.stride(), m)
    copies = (route != "k_major") + (n % align != 0)
    before = split_ternary.launches
    copied = split_ternary.transposed_copies
    got = split_ternary(x, probe, probe_p, sx, sw, boundary)
    torch.cuda.synchronize()
    assert split_ternary.launches == before + 1
    assert split_ternary.transposed_copies == copied + copies
    want = split_ternary_plain(x, w_q, w_p, sx, sw, boundary)
    assert torch.equal(got, want)


#: SHAPES (split None: the plan's) plus the wgmma GEMM's M (17, 100,
#: 300, 512, 12288) at the served wk / wv shape, N 1000 off its column
#: tiles and K 1000 (padded to 1008), and the served prefill call at each
#: K split of chip_smoke.py's sweep
TERNARY_CASES = [(m, k, n, None) for m, k, n in SHAPES + [
    (17, 4096, 512), (100, 4096, 512), (300, 4096, 512), (512, 4096, 512),
    (12288, 4096, 512), (300, 4096, 1000), (100, 1000, 512)]] + [
    (512, 4096, 512, split) for split in (1, 2, 4, 8)] + [
    (300, 1000, 1000, 8)]


@pytest.mark.parametrize("layout", ["row_major", "k_major"])
@pytest.mark.parametrize("m,k,n,split", TERNARY_CASES)
def test_ternary_matmul_kernel_bit_exact(cuda, monkeypatch, m, k, n, split,
                                         layout):
    """Both layouts bit for bit, at the plan's K split or a forced one; a
    row-major weight, or a K-major one with K off 16, is copied into the
    kernel's layout (one counted copy)."""
    from repro_torch.kernels import ternary_matmul as tm
    if split is not None:
        monkeypatch.setattr(tm, "wgmma_split", lambda *_: split)
    x, _, t, sx, sw = _operands(m, k, n, 2, cuda)
    if layout == "k_major":
        t = t.t().contiguous().t()
    before = ternary_matmul.launches
    copies = ternary_matmul.transposed_copies
    got = ternary_matmul(x, t, sx, sw)
    torch.cuda.synchronize()
    assert ternary_matmul.launches == before + 1
    assert ternary_matmul.transposed_copies == copies + (
        layout == "row_major" or k % 16 != 0)
    assert torch.equal(got, ternary_matmul_plain(x, t, sx, sw))


@pytest.mark.parametrize("m,route", [(512, ("igemm_wgmma", "Int8Codes")),
                                     (4, ("gemv", "KMajorCodes"))])
def test_ternary_matmul_launches_its_route(cuda, m, route):
    """One launch per call, of the int8 wgmma GEMM on the K-major codes
    (`Int8Codes`) above 16 rows and of the decode GEMM at M <= 16, by the
    kernel names the profiler records."""
    from torch.profiler import ProfilerActivity, profile
    k, n = 4096, 512
    x, _, t, sx, sw = _operands(m, k, n, 16, cuda)
    tk = t.t().contiguous().t()
    ternary_matmul(x, tk, sx, sw)
    torch.cuda.synchronize()
    before = ternary_matmul.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = ternary_matmul(x, tk, sx, sw)
        torch.cuda.synchronize()
    assert ternary_matmul.launches == before + 1
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    hits = [nm for nm in names if all(part in nm for part in route)]
    assert len(hits) == 1, names
    assert sum(e.count for e in prof.key_averages()
               if e.key == hits[0]) == 1
    assert torch.equal(got, ternary_matmul_plain(x, t, sx, sw))


def _split_precision_case(cuda, m, k, n, where, layout, seed=3):
    """One split_precision call against the plain version: int8 columns
    bit for bit, bf16 columns within the summation bound.  w_q holds 99 at
    and above the boundary and w_bf16 NaN below it (the split probe):
    neither may reach the output.  Weight copies (w_q row-major or off the
    kernel's alignment, w_bf16 off it) are counted once per weight."""
    from repro_torch.kernels.split_precision import weight_route
    x_q, w_q, _, sx, sw = _operands(m, k, n, seed, cuda)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1.5, (m, k)).astype(np.float32))
    w_b = torch.from_numpy(rng.normal(0, 0.05, (k, n)).astype(np.float32))
    x, w_b = (a.to(cuda).to(torch.bfloat16) for a in (x, w_b))
    raw = min(7, n)
    boundary = {"zero": 0, "raw": raw, "all": n,
                "aligned16": min(ops.align_boundary(raw + 40, 16), n),
                "aligned": min(ops.align_boundary(raw, 128), n)}[where]
    cols = torch.arange(n, device=cuda)[None, :]
    probe_q = torch.where(cols < boundary, w_q, 99).to(torch.int8)
    probe_b = torch.where(cols >= boundary, w_b,
                          float("nan")).to(torch.bfloat16)
    if layout == "k_major":
        probe_q = probe_q.t().contiguous().t()
    align = 16 if m > 16 else 4
    copies = (weight_route(tuple(probe_q.shape), probe_q.stride(), m) !=
              "k_major") + (k % 16 != 0 or n % align != 0)
    before = split_precision.launches
    copied = split_precision.transposed_copies
    got = split_precision(x, x_q, sx, probe_b, probe_q, sw, boundary)
    torch.cuda.synchronize()
    assert split_precision.launches == before + 1
    assert split_precision.transposed_copies == copied + copies
    want = split_precision_plain(x, x_q, sx, w_b, w_q, sw, boundary)
    assert torch.equal(got[:, :boundary], want[:, :boundary])
    err = (got.double() - want.double()).abs()
    bound = bf16_error_bound(x, w_b, want)
    assert bool((err[:, boundary:] <= bound[:, boundary:]).all())


@pytest.mark.parametrize("layout", ["row_major", "k_major"])
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("where", ["zero", "raw", "aligned16", "all"])
def test_split_precision_kernel(cuda, m, k, n, where, layout):
    """``raw`` (7) falls inside a 16-column group of the decode GEMM and
    inside a 128-column tile of the wgmma GEMM, ``aligned16`` (48) on a
    group edge and inside a tile."""
    _split_precision_case(cuda, m, k, n, where, layout)


@pytest.mark.parametrize("m", [17, 100, 512])
@pytest.mark.parametrize("k,n", [(4096, 512), (1000, 1000), (256, 200)])
@pytest.mark.parametrize("where", ["zero", "raw", "aligned", "all"])
def test_split_precision_wgmma_path(cuda, m, k, n, where):
    """The wgmma path (M > 16) on the K-major codes the layers hold: int8
    tiles below the boundary, bf16 tiles at or above it, both in the tile
    a raw boundary falls in; N 1000 and 200 padded to 16, K 1000 to 1008."""
    _split_precision_case(cuda, m, k, n, where, "k_major", seed=11)


#: the decode GEMM (M <= 16) at the served wk / wv shape, N and K off its
#: tiles (1000), the down projection's K and a wide N
DECODE_SHAPES = [(4096, 512), (1000, 1000), (4096, 1000), (11008, 4096),
                 (4096, 11008)]
DECODE_M = [1, 3, 4, 16]


@pytest.mark.parametrize("m", DECODE_M)
@pytest.mark.parametrize("k,n", DECODE_SHAPES)
@pytest.mark.parametrize("kernel", ["quant_matmul", "ternary_matmul",
                                    "ternary_packed", "split_ternary"])
def test_decode_gemm_bit_exact(cuda, kernel, m, k, n):
    """The decode GEMM of the four integer kernels bit for bit on the
    layouts the serving paths hold (K-major codes, the packed stream as
    stored): no weight copy at K % 16 == 0, one (the K pad) otherwise;
    split_ternary at raw boundary 7 (a 16-column group reads both streams)
    and the aligned 128, with both garbage probes."""
    x, w, t, sx, sw = _operands(m, k, n, 13, cuda)
    k4 = -(-k // 4) * 4
    pad_copy = int(k % 16 != 0)
    if kernel == "quant_matmul":
        wk = w.t().contiguous().t()
        copies = quant_matmul.transposed_copies
        got = ops.quant_matmul_op(x, wk, sx, sw)
        torch.cuda.synchronize()
        assert quant_matmul.transposed_copies == copies + pad_copy
        assert torch.equal(got, quant_matmul_plain(x, w, sx, sw))
    elif kernel == "ternary_matmul":
        tk = t.t().contiguous().t()
        copies = ternary_matmul.transposed_copies
        got = ops.ternary_matmul_op(x, tk, sx, sw)
        torch.cuda.synchronize()
        assert ternary_matmul.transposed_copies == copies + pad_copy
        assert torch.equal(got, ternary_matmul_plain(x, t, sx, sw))
    elif kernel == "ternary_packed":
        w_p = pack_ternary(torch.nn.functional.pad(t, (0, 0, 0, k4 - k)))
        copies = ternary_packed_matmul.padded_copies
        got = ops.ternary_packed_matmul_op(x, w_p, sx, sw)
        torch.cuda.synchronize()
        assert ternary_packed_matmul.padded_copies == copies
        assert torch.equal(got, ternary_packed_plain(x, w_p, sx, sw))
    else:
        cols = torch.arange(n, device=cuda)[None, :]
        for boundary in (7, min(128, n)):
            w_q = torch.where(cols < boundary, w, t)
            w_p = pack_ternary(torch.nn.functional.pad(
                torch.where(cols >= boundary, t, 0), (0, 0, 0, k4 - k)))
            probe = torch.where(cols < boundary, w_q, 99).to(torch.int8)
            probe_p = torch.where(cols < boundary, 0xFF, w_p).to(torch.uint8)
            copies = split_ternary.transposed_copies
            got = split_ternary(x, probe.t().contiguous().t(), probe_p, sx,
                                sw, boundary)
            torch.cuda.synchronize()
            assert split_ternary.transposed_copies == copies + pad_copy
            assert torch.equal(got, split_ternary_plain(x, w_q, w_p, sx, sw,
                                                        boundary))


@pytest.mark.parametrize("m", DECODE_M)
@pytest.mark.parametrize("k,n", DECODE_SHAPES)
@pytest.mark.parametrize("where", ["zero", "raw", "aligned", "all"])
def test_decode_gemm_split_precision(cuda, m, k, n, where):
    """split_precision's decode GEMM on the K-major codes: int8 columns bit
    for bit (mma.sync), bf16 columns (fmaf) within the bound, both probes."""
    _split_precision_case(cuda, m, k, n, where, "k_major", seed=14)


def test_cuda_wrappers_reject_mixed_devices(cuda):
    x, w, t, sx, sw = _operands(4, 64, 32, 5, cuda)
    with pytest.raises(ValueError):
        ternary_matmul(x, t, sx, sw.cpu())
    with pytest.raises(ValueError):
        ternary_packed_matmul(x, pack_ternary(t).cpu(), sx, sw)
    with pytest.raises(ValueError):
        split_precision(x.to(torch.bfloat16).cpu(), x, sx,
                        w.to(torch.bfloat16), w, sw, 0)


@pytest.mark.parametrize("m,k,n", PACKED_SHAPES)
def test_ternary_packed_kernel_bit_exact(cuda, m, k, n):
    x, _, t, sx, sw = _operands(m, k, n, 6, cuda)
    k4 = -(-k // 4) * 4
    w_p = pack_ternary(torch.nn.functional.pad(t, (0, 0, 0, k4 - k)))
    before = ternary_packed_matmul.launches
    copied = ternary_packed_matmul.padded_copies
    got = ops.ternary_packed_matmul_op(x, w_p, sx, sw)
    torch.cuda.synchronize()
    assert ternary_packed_matmul.launches == before + 1
    assert ternary_packed_matmul.padded_copies == copied + (
        n % (16 if m > 16 else 4) != 0)
    assert torch.equal(got, ternary_packed_plain(x, w_p, sx, sw))


def _bhsd(B, H, KVH, Sq, Sk, D, dev, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        dev).to(torch.bfloat16)
        for s in ((B, H, Sq, D), (B, KVH, Sk, D), (B, KVH, Sk, D))]


#: B, H, KVH, Sq, Sk, D, causal, kv_len: ragged Sq and Sk, G 1 and 8
FLASH_CASES = [(2, 4, 4, 100, 100, 16, True, None),
               (1, 8, 1, 77, 130, 128, True, 120),
               (1, 32, 4, 300, 300, 128, True, None),
               (2, 8, 8, 64, 1000, 128, True, 700),
               (1, 8, 1, 33, 257, 16, False, 200),
               (2, 16, 2, 130, 150, 128, False, 150),
               (1, 4, 4, 1, 70, 16, False, None),
               # Sq and Sk off the 128-row query and key tiles
               (2, 8, 2, 390, 517, 16, True, 450),
               (1, 16, 2, 391, 645, 128, True, 520)]


@pytest.mark.parametrize("B,H,KVH,Sq,Sk,D,causal,kv_len", FLASH_CASES)
def test_flash_attention_kernel_within_bound(cuda, B, H, KVH, Sq, Sk, D,
                                             causal, kv_len):
    q, k, v = _bhsd(B, H, KVH, Sq, Sk, D, cuda, Sq + Sk)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    err = (got.double() - want.double()).abs()
    bound = flash_error_bound(q, k, v, want, kv_len=kv_len)
    assert bool(torch.isfinite(got).all())
    assert bool((err <= bound).all()), float((err / bound).max())


def test_flash_op_masks_padded_keys_on_the_card(cuda):
    q, k, v = _bhsd(1, 4, 2, 200, 200, 128, cuda, 3)
    got = ops.flash_attention_op(q, k, v, causal=False, bq=128, bk=128)
    want = flash_attention_plain(q, k, v, causal=False)
    err = (got.double() - want.double()).abs()
    assert bool((err <= flash_error_bound(q, k, v, want)).all())


def test_chunked_attention_launches_flash_on_the_model_layout(cuda):
    """q (B, S, KVH, G, hd) and the cache's k / v through strides: the same
    numbers as the kernel on contiguous (B, H, S, D) copies; a planned
    backend asking for plain versions runs none."""
    rng = np.random.default_rng(8)
    B, S, KVH, G, hd, Sk = 2, 1024, 2, 4, 128, 2048
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        cuda).to(torch.bfloat16) for s in ((B, S, KVH, G, hd),
                                           (B, Sk, KVH, hd), (B, Sk, KVH, hd)))
    before = flash_attention.launches
    got = A.chunked_attention(q, k, v, kv_len=S)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention(
        q.reshape(B, S, KVH * G, hd).transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
        kv_len=S)
    assert torch.equal(got, want.transpose(1, 2).reshape(got.shape))

    class Plain:
        reference = True
    with _backend.use(Plain()):
        plain = A.chunked_attention(q, k, v, kv_len=S)
    assert flash_attention.launches == before + 2
    assert torch.equal(plain, A.attention_plain(q, k, v, causal=True,
                                                kv_len=S))


def test_flash_and_chunked_reject_what_the_kernel_does_not_take(cuda):
    q, k, v = _bhsd(1, 4, 2, 64, 64, 128, cuda)
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v, causal=True)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), v.float())
    q48, k48, v48 = _bhsd(1, 4, 2, 64, 64, 48, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q48, k48, v48)
    qg = q.transpose(1, 2).reshape(1, 64, 2, 2, 128)
    with pytest.raises(NotImplementedError, match="window"):
        A.chunked_attention(qg, k.transpose(1, 2), v.transpose(1, 2),
                            window=16)
    with pytest.raises(ValueError, match="multiple"):
        A.chunked_attention(qg, k.transpose(1, 2), v.transpose(1, 2),
                            q_chunk=48)


def test_long_prefill_on_the_card_launches_flash_per_layer(cuda):
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer as T
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
    params = T.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 2560), device=cuda,
                            generator=torch.Generator(device=cuda))
    before = flash_attention.launches
    logits, _ = T.prefill(params, cfg, prompts,
                          T.init_cache(cfg, 2, 3072, device=cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers
    assert tuple(logits.shape) == (2, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("m,n", [(16, 17024), (512, 512)])
@pytest.mark.parametrize("first", ["quant_matmul", "ternary_matmul"])
def test_decode_gemm_libraries_keep_their_own_launch_state(cuda, first, m,
                                                           n):
    """quant_matmul and ternary_matmul build the same instantiations into
    two libraries: the decode GEMM's, and the wgmma GEMM's
    ``igemm_wgmma<128, Int8Codes>``.  At M 16, K 4096, N 17024 (decode
    plan 128 x 2: a 2 KB x slice of 16 rows), and on the wgmma GEMM at M
    512 x N 512 (over 128 KB of ring; ternary_matmul K-split over a
    cluster), a block needs more than 48 KB of shared memory, which each
    library must allow for its own kernel, whichever launches first; both
    then agree with the plain version."""
    from repro_torch.kernels.quant_matmul import decode_plan
    k = 4096
    if m == 16:
        assert decode_plan(m, k, n, 132) == (128, 2)
    x, w, t, sx, sw = _operands(m, k, n, 15, cuda)
    calls = {"quant_matmul": (ops.quant_matmul_op, w, quant_matmul_plain),
             "ternary_matmul": (ops.ternary_matmul_op, t,
                                ternary_matmul_plain)}
    order = [first] + [c for c in calls if c != first]
    for name in order + order:
        op, weight, plain = calls[name]
        got = op(x, weight.t().contiguous().t(), sx, sw)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(x, weight, sx, sw)), name


def _engine_trace(vocab):
    """Mixed lengths and staggered arrivals in two 16-position slots;
    request 2 (14 prompt tokens, 8 new) retires at the length cap while
    request 3 keeps decoding and nothing waits for the freed slot until
    request 4 arrives at step 8."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(11)
    specs = [(4, 1, 0), (5, 2, 0), (14, 8, 0), (3, 9, 0), (3, 3, 8)]
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=p),
                    max_new_tokens=n, arrival_step=a)
            for i, (p, n, a) in enumerate(specs)]


def test_engine_planned_on_diana_launches_kernels_like_the_plain_run(
        cuda, tmp_path):
    """The dense engine on reduced yi-9b planned on diana (static scales):
    every forward launches each planned layer's kernel, and the tokens
    equal those of the plain versions (``reference=True``) bit for bit."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch.serve import (kv_cache_for,
                                          plan_mapping_execution)
    from repro_torch.launch.train import emit_static_mapping
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
    params = T.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg)
    art = emit_static_mapping(params, cfg, "diana", tmp_path / "m.json",
                              max_cout=64, act_log_scale=2.0)
    plan, backend = plan_mapping_execution(params, art)
    assert not backend.unbound
    cfg = kv_cache_for(cfg, art)
    hist = plan.kernel_histogram()
    assert hist == {"quant_matmul": 5, "split_ternary": 10}
    trace = _engine_trace(cfg.vocab)
    engine = Engine(cfg, params, max_batch=2, max_len=16, backend=backend)
    before = {k: getattr(ops, k).launches for k in hist}
    got = engine.run(trace)
    torch.cuda.synchronize()
    forwards = engine.stats["prefill_calls"] + engine.stats["decode_steps"]
    assert {k: getattr(ops, k).launches - before[k] for k in hist} == \
        {k: n * forwards for k, n in hist.items()}
    backend.reference = True
    want = engine.run(trace)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert "length_cap" in {r.finish_reason for r in got}


def test_engine_length_cap_retirement_on_the_card(cuda):
    """A slot retired at the length cap keeps ``lengths == max_len``; the
    next decode step must not write its KV there (an out-of-range index
    would fire a device-side assert and poison the context)."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
    params = T.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg)
    engine = Engine(cfg, params, max_batch=2, max_len=16)
    res = {r.rid: r for r in engine.run(_engine_trace(cfg.vocab))}
    torch.cuda.synchronize()
    assert res[2].finish_reason == "length_cap"
    assert res[2].finished_step + 1 < min(res[3].finished_step,
                                          res[4].admitted_step)
    assert all(r.n_tokens >= 1 for r in res.values())
    assert bool(torch.isfinite(torch.ones(1, device=cuda)).all())
