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


#: B, H, KVH, Sq, Sk, D, causal, kv_len: ragged Sq and Sk, G 1 and 8, D
#: 16, 64 and 128
FLASH_CASES = [(2, 4, 4, 100, 100, 16, True, None),
               (1, 8, 1, 77, 130, 128, True, 120),
               (1, 32, 4, 300, 300, 128, True, None),
               (2, 8, 8, 64, 1000, 128, True, 700),
               (1, 8, 1, 33, 257, 16, False, 200),
               (2, 16, 2, 130, 150, 128, False, 150),
               (1, 4, 4, 1, 70, 16, False, None),
               # Sq and Sk off the 128-row query and key tiles
               (2, 8, 2, 390, 517, 16, True, 450),
               (1, 16, 2, 391, 645, 128, True, 520),
               # zamba2-1.2b's head dim 64 (G 1), ragged and off the tiles
               (2, 32, 32, 300, 300, 64, True, None),
               (1, 8, 2, 391, 645, 64, True, 520),
               (1, 4, 4, 100, 130, 64, False, 120)]


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
    with pytest.raises(NotImplementedError, match="kv_len"):
        A.chunked_attention(qg, k.transpose(1, 2), v.transpose(1, 2),
                            kv_len=torch.tensor([64], device=cuda))
    with pytest.raises(ValueError, match="head dim"):
        A.chunked_attention(q48.transpose(1, 2).reshape(1, 64, 2, 2, 48),
                            k48.transpose(1, 2), v48.transpose(1, 2))
    with pytest.raises(ValueError, match="multiple"):
        A.chunked_attention(qg, k.transpose(1, 2), v.transpose(1, 2),
                            q_chunk=48)


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n,raw", [(24576, 6144, 90), (22528, 8192, 120),
                                     (6144, 24576, 361)])
def test_decode_gemm_at_the_wide_dense_shapes(cuda, m, k, n, raw):
    """nemotron-4-15b's and command-r-35b's FFN projections at decode: the
    decode GEMM stages up to 48 chunks of K per block (K 24576 and 22528
    in 8 splits, K 6144 in 2); quant_matmul and split_ternary (at the raw
    boundary diana plans, through the kernel) on the K-major codes bit
    for bit."""
    x, w, t, sx, sw = _operands(m, k, n, k + m, cuda)
    wk = w.t().contiguous().t()
    assert torch.equal(quant_matmul(x, wk, sx, sw),
                       quant_matmul_plain(x, w, sx, sw))
    cols = torch.arange(n, device=cuda)[None, :]
    w_q = torch.where(cols < raw, w, t).to(torch.int8)
    w_p = pack_ternary(torch.where(cols >= raw, t, 0).to(torch.int8))
    got = split_ternary(x, w_q.t().contiguous().t(), w_p, sx, sw, raw)
    assert torch.equal(got, split_ternary_plain(x, w_q, w_p, sx, sw, raw))


#: B, H, KVH, Sq, Sk, D, causal, kv_len, window: h2o-danube's head dim
#: 120 with and without its sliding window, windows that are and are not
#: multiples of the 128-key tile, ragged Sq / Sk, the window at the other
#: head dims, and rows that the window and kv_len leave no key (0)
WINDOW_CASES = [(2, 8, 2, 1024, 1024, 120, True, None, None),
                (1, 8, 2, 1500, 1500, 120, True, None, 1000),
                (1, 8, 2, 2048, 2048, 120, True, None, 128),
                (1, 32, 8, 3000, 3000, 120, True, None, 4096),
                (2, 4, 2, 390, 517, 120, True, 450, 100),
                (1, 4, 4, 77, 130, 120, True, 120, None),
                (1, 4, 2, 300, 400, 120, False, None, 129),
                (1, 8, 1, 700, 700, 16, True, None, 16),
                (1, 4, 4, 520, 520, 64, True, None, 300),
                (1, 4, 2, 600, 600, 128, True, 500, 200),
                (1, 4, 2, 300, 300, 120, False, 40, 64)]


@pytest.mark.parametrize("B,H,KVH,Sq,Sk,D,causal,kv_len,window",
                         WINDOW_CASES)
def test_flash_attention_window_and_head_dim_120_within_bound(
        cuda, B, H, KVH, Sq, Sk, D, causal, kv_len, window):
    q, k, v = _bhsd(B, H, KVH, Sq, Sk, D, cuda, Sq + Sk + (window or 0))
    q = q * 3   # peaked rows: a wrong key or mask moves the output far
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                          window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                 window=window)
    err = (got.double() - want.double()).abs()
    bound = flash_error_bound(q, k, v, want, kv_len=kv_len)
    assert bool(torch.isfinite(got).all())
    assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.parametrize("window", [None, 1000])
def test_flash_at_head_dim_120_writes_only_its_columns(cuda, window):
    """In the model's (B, S, H, 120) layout columns 120-127 of head h are
    the first 8 of head h + 1: the kernel stores 120 columns.  An output
    view with 8 guard columns after each head, and the model layout with a
    guard head after the last, keep their guard values."""
    B, H, KVH, S = 1, 8, 2, 640
    q, k, v = _bhsd(B, H, KVH, S, S, 120, cuda, 21)
    want = flash_attention_plain(q, k, v, window=window)
    buf = torch.full((B, S, H, 128), 7.0, dtype=torch.bfloat16,
                     device=cuda)
    flash_attention(q, k, v, window=window,
                    out=buf[..., :120].transpose(1, 2))
    model = torch.full((B, S, H + 1, 120), 7.0, dtype=torch.bfloat16,
                       device=cuda)
    flash_attention(q, k, v, window=window,
                    out=model[:, :, :H].transpose(1, 2))
    torch.cuda.synchronize()
    assert bool((buf[..., 120:] == 7.0).all())
    assert bool((model[:, :, H] == 7.0).all())
    for got in (buf[..., :120].transpose(1, 2),
                model[:, :, :H].transpose(1, 2)):
        err = (got.double() - want.double()).abs()
        assert bool((err <= flash_error_bound(q, k, v, want)).all())


@pytest.mark.parametrize("hd,window", [(120, 1000), (128, 300)])
def test_chunked_attention_launches_flash_with_the_window(cuda, hd, window):
    """``chunked_attention(window=)`` on the model layout launches the
    kernel with the window: the numbers of the kernel on contiguous (B, H,
    S, D) copies; a planned backend asking for plain versions runs
    `attention_plain` with the window."""
    rng = np.random.default_rng(9)
    B, S, KVH, G, Sk = 1, 2048, 2, 4, 3072
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        cuda).to(torch.bfloat16) for s in ((B, S, KVH, G, hd),
                                           (B, Sk, KVH, hd), (B, Sk, KVH, hd)))
    before = flash_attention.launches
    got = A.chunked_attention(q, k, v, kv_len=S, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention(
        q.reshape(B, S, KVH * G, hd).transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
        kv_len=S, window=window)
    assert torch.equal(got, want.transpose(1, 2).reshape(got.shape))

    class Plain:
        reference = True
    with _backend.use(Plain()):
        plain = A.chunked_attention(q, k, v, kv_len=S, window=window)
    assert flash_attention.launches == before + 2
    assert torch.equal(plain, A.attention_plain(q, k, v, causal=True,
                                                kv_len=S, window=window))


def test_h2o_long_prefill_on_the_card_launches_windowed_flash(cuda):
    """Reduced h2o-danube (window 16): a 2560-token prefill launches the
    kernel once per layer, with the window; the logits are finite."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer as T
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("h2o-danube-3-4b"))
    params = T.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 2560), device=cuda,
                            generator=torch.Generator(device=cuda))
    windows = []
    launch = A.flash_attention

    def recording(*args, **kw):
        windows.append(kw.get("window"))
        return launch(*args, **kw)
    A.flash_attention = recording
    try:
        before = flash_attention.launches
        logits, _ = T.prefill(params, cfg, prompts,
                              T.init_cache(cfg, 2, 3072, device=cuda))
        torch.cuda.synchronize()
    finally:
        A.flash_attention = launch
    assert flash_attention.launches == before + cfg.n_layers
    assert windows == [cfg.sliding_window] * cfg.n_layers
    assert tuple(logits.shape) == (2, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


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


#: B, H, KVH, Sq, Sk, causal, kv_len at deepseek's MLA head dims (query /
#: key 192, value 128): its long prefill's shape (G 1), ragged and off the
#: tiles, kv_len inside a longer cache, G 4 and not causal
MLA_CASES = [(1, 16, 16, 3072, 3072, True, None),
             (2, 4, 4, 300, 400, True, 350),
             (1, 16, 16, 1000, 2048, True, 1000),
             (1, 8, 2, 391, 645, True, 520),
             (1, 4, 4, 77, 130, False, 100)]


def _mla_operands(B, H, KVH, Sq, Sk, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        dev).to(torch.bfloat16)
        for s in ((B, H, Sq, 192), (B, KVH, Sk, 192), (B, KVH, Sk, 128))]


@pytest.mark.parametrize("B,H,KVH,Sq,Sk,causal,kv_len", MLA_CASES)
def test_flash_attention_mla_head_dims_within_bound(cuda, B, H, KVH, Sq, Sk,
                                                    causal, kv_len):
    q, k, v = _mla_operands(B, H, KVH, Sq, Sk, cuda, Sq + Sk)
    q = q * 2
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert tuple(got.shape) == (B, H, Sq, 128)
    want = flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    err = (got.double() - want.double()).abs()
    bound = flash_error_bound(q, k, v, want, kv_len=kv_len)
    assert bool(torch.isfinite(got).all())
    assert bool((err <= bound).all()), float((err / bound).max())


def test_flash_at_mla_head_dims_writes_only_its_value_columns(cuda):
    """An output view with guard columns past Dv 128 keeps them; the model
    layout of `attention.mla` (v a strided view of ``kv_b``'s output, k
    the concatenation of k_nope and k_rope) through `chunked_attention`
    gives the kernel's numbers on contiguous copies; an uninstantiated
    pair, and a window at 192 / 128 (instantiated without one), raise."""
    B, H, S = 1, 16, 1024
    q, k, v = _mla_operands(B, H, H, S, S, cuda, 31)
    want = flash_attention_plain(q, k, v)
    buf = torch.full((B, S, H, 136), 7.0, dtype=torch.bfloat16, device=cuda)
    flash_attention(q, k, v, out=buf[..., :128].transpose(1, 2))
    torch.cuda.synchronize()
    assert bool((buf[..., 128:] == 7.0).all())
    got = buf[..., :128].transpose(1, 2)
    assert bool(((got.double() - want.double()).abs()
                 <= flash_error_bound(q, k, v, want)).all())
    kvb = torch.randn((B, S, H, 256), device=cuda).to(torch.bfloat16)
    krope = torch.randn((B, S, 64), device=cuda).to(torch.bfloat16)
    km = torch.cat([kvb[..., :128], krope[:, :, None].expand(B, S, H, 64)],
                   dim=-1)
    vm = kvb[..., 128:]
    qm = q.transpose(1, 2).reshape(B, S, H, 1, 192)
    before = flash_attention.launches
    out = A.chunked_attention(qm, km, vm, kv_len=S)
    assert flash_attention.launches == before + 1
    ref = flash_attention(qm.reshape(B, S, H, 192).transpose(1, 2)
                          .contiguous(), km.transpose(1, 2).contiguous(),
                          vm.transpose(1, 2).contiguous(), kv_len=S)
    assert torch.equal(out, ref.transpose(1, 2).reshape(out.shape))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :128], k[..., :128], v[..., :64])
    with pytest.raises(ValueError, match="no window"):
        flash_attention(q, k, v, window=64)


#: (M, K, N, raw boundary) of deepseek-v2-lite's planned projections on
#: diana (max_cout 10944): wq, kv_a, kv_b, wo, the router, the shared
#: experts' up and down, the first dense layer's up and down, at decode
#: and a paged chunk's rows; kv_b also at a paged chunk's gathered latent
DEEPSEEK_SPLIT = [(m, k, n, raw) for m in (4, 128) for k, n, raw in (
    (2048, 3072, 45), (2048, 576, 15), (512, 4096, 60), (2048, 2048, 30),
    (2048, 64, 7), (2048, 2816, 45), (2816, 2048, 30), (2048, 10944, 165),
    (10944, 2048, 30))] + [(4 * 256, 512, 4096, 60)]


@pytest.mark.parametrize("m,k,n,raw", DEEPSEEK_SPLIT)
def test_split_ternary_at_deepseek_shapes(cuda, m, k, n, raw):
    """Through the op (the boundary aligned as a served layer's) on K-major
    codes, bit for bit."""
    x, w, t, sx, sw = _operands(m, k, n, k + n + m, cuda)
    cols = torch.arange(n, device=cuda)[None, :]
    b_al = min(ops.align_boundary(raw, 128), n)
    w_q = torch.where(cols < b_al, w, t).to(torch.int8)
    packed = pack_ternary(torch.where(cols >= b_al, t, 0).to(
        torch.int8).contiguous())
    got = ops.split_ternary_op(x, w_q.t().contiguous().t(), packed, sx, sw,
                               raw)
    assert torch.equal(got, split_ternary_plain(x, w_q, packed, sx, sw,
                                                b_al))


@pytest.mark.parametrize("m", [4, 128])
def test_quant_matmul_at_the_deepseek_head(cuda, m):
    x, w, _, sx, sw = _operands(m, 2048, 102400, m, cuda)
    got = quant_matmul(x, w.t().contiguous().t(), sx, sw)
    assert torch.equal(got, quant_matmul_plain(x, w, sx, sw))


def test_deepseek_long_prefill_on_the_card_launches_mla_flash(cuda):
    """Reduced deepseek (query / key dim 24 is no kernel instantiation, so
    the reduced MLA dims are widened to the full model's 128 nope + 64
    rope, v 128): a 2560-token prefill launches the kernel once per layer
    at 192 / 128; the logits are finite."""
    import dataclasses
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer as T
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("deepseek-v2-lite-16b"))
    cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128))
    params = T.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 2560), device=cuda,
                            generator=torch.Generator(device=cuda))
    shapes = []
    launch = A.flash_attention

    def recording(q, k, v, **kw):
        shapes.append((q.shape[-1], v.shape[-1]))
        return launch(q, k, v, **kw)
    A.flash_attention = recording
    try:
        before = flash_attention.launches
        logits, _ = T.prefill(params, cfg, prompts,
                              T.init_cache(cfg, 2, 3072, device=cuda))
        torch.cuda.synchronize()
    finally:
        A.flash_attention = launch
    assert flash_attention.launches == before + cfg.n_layers
    assert shapes == [(192, 128)] * cfg.n_layers
    assert tuple(logits.shape) == (2, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


#: (K, N, raw boundary) of xlstm-1.3b's planned projections on diana
#: (max_cout 16384): mLSTM's w_if (8 columns, below every column tile) and
#: sLSTM's w_in; and arctic-480b's router (128 columns)
XLSTM_ARCTIC_SPLIT = [(4096, 8, 7), (2048, 16384, 240), (7168, 128, 7)]


@pytest.mark.parametrize("m", [4, 128, 512])
@pytest.mark.parametrize("k,n,raw", XLSTM_ARCTIC_SPLIT)
@pytest.mark.parametrize("route", ["op", "kernel"])
def test_split_ternary_at_xlstm_and_arctic_shapes(cuda, m, k, n, raw,
                                                  route):
    """Through the op (the boundary aligned as a served layer's: all 8 of
    w_if's columns int8) and through the kernel itself at the raw
    boundary, on K-major codes with garbage in the codes at and above the
    boundary and in the packed bytes below it, bit for bit."""
    x, w, t, sx, sw = _operands(m, k, n, k + n + m, cuda)
    cols = torch.arange(n, device=cuda)[None, :]
    b = min(ops.align_boundary(raw, ops.block_n(128, n)), n) \
        if route == "op" else raw
    w_q = torch.where(cols < b, w, t).to(torch.int8)
    packed = pack_ternary(torch.where(cols >= b, t, 0).to(
        torch.int8).contiguous())
    probe = torch.where(cols < b, w_q, 99).to(torch.int8)
    probe_p = torch.where(cols < b, 0xFF, packed).to(torch.uint8)
    want = split_ternary_plain(x, w_q, packed, sx, sw, b)
    fn = ops.split_ternary_op if route == "op" else split_ternary
    got = fn(x, probe.t().contiguous().t(), probe_p, sx, sw, raw if route ==
             "op" else b)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("k,n", [(4096, 8), (2048, 16384), (2048, 50304),
                                 (7168, 32000)])
def test_quant_matmul_at_xlstm_and_arctic_shapes(cuda, m, k, n):
    """w_if and sLSTM's w_in as int8 layers, and both heads, K-major."""
    x, w, _, sx, sw = _operands(m, k, n, m + n, cuda)
    got = quant_matmul(x, w.t().contiguous().t(), sx, sw)
    assert torch.equal(got, quant_matmul_plain(x, w, sx, sw))


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "arctic-480b"])
def test_reduced_forward_on_the_card_matches_the_plain_backend(cuda, arch,
                                                               tmp_path):
    """Reduced xlstm-1.3b and arctic-480b planned on diana: a prefill of
    40 tokens (xLSTM's chunked mLSTM and sLSTM's step loop; arctic's MoE
    beside the dense residual) and 3 decode steps launch every planned
    layer's kernel once per forward, and the logits equal those of the
    plain versions (``reference=True``) bit for bit."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch.serve import (kv_cache_for,
                                          plan_mapping_execution)
    from repro_torch.launch.train import emit_static_mapping
    from repro_torch.models import transformer as T
    cfg = cfgbase.reduce_for_smoke(cfgbase.get(arch))
    params = T.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg)
    art = emit_static_mapping(params, cfg, "diana", tmp_path / "m.json",
                              max_cout=64, act_log_scale=2.0)
    plan, backend = plan_mapping_execution(params, art)
    assert not backend.unbound
    cfg = kv_cache_for(cfg, art)
    hist = plan.kernel_histogram()
    prompts = torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                            generator=torch.Generator(device=cuda))

    def run():
        caches = T.init_cache(cfg, 2, 48, device=cuda)
        with _backend.use(backend):
            out = [T.prefill(params, cfg, prompts, caches)[0]]
            for i in range(3):
                tok = out[-1].argmax(-1)
                out.append(T.decode_step(params, cfg, tok, caches,
                                         40 + i)[0])
        torch.cuda.synchronize()
        return out
    before = {k: getattr(ops, k).launches for k in hist}
    got = run()
    assert {k: getattr(ops, k).launches - before[k] for k in hist} == \
        {k: 4 * n for k, n in hist.items()}
    backend.reference = True
    want = run()
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


#: (K, N, raw boundary) of the frontend archs' planned projections on
#: diana: llama-3.2-vision-11b (max_cout 14336: wq / wo, wk / wv, gate /
#: up, down) and seamless-m4t-large-v2 (max_cout 8192: the attentions'
#: four, the FFN's up and down, encoder and decoder alike)
FRONTEND_SPLIT = [(4096, 4096, 60), (4096, 1024, 15), (4096, 14336, 210),
                  (14336, 4096, 60), (1024, 1024, 15), (1024, 8192, 120),
                  (8192, 1024, 15)]


@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("k,n,raw", FRONTEND_SPLIT)
@pytest.mark.parametrize("route", ["op", "kernel"])
def test_split_ternary_at_the_frontend_archs_shapes(cuda, m, k, n, raw,
                                                    route):
    """Through the op (the boundary aligned as a served layer's) and
    through the kernel itself at the raw boundary, on K-major codes with
    garbage in the codes at and above the boundary and in the packed bytes
    below it, bit for bit, on the decode GEMM (M 4) and the wgmma GEMM (M
    128)."""
    x, w, t, sx, sw = _operands(m, k, n, k + n + m, cuda)
    cols = torch.arange(n, device=cuda)[None, :]
    b = min(ops.align_boundary(raw, ops.block_n(128, n)), n) \
        if route == "op" else raw
    w_q = torch.where(cols < b, w, t).to(torch.int8)
    packed = pack_ternary(torch.where(cols >= b, t, 0).to(
        torch.int8).contiguous())
    probe = torch.where(cols < b, w_q, 99).to(torch.int8)
    probe_p = torch.where(cols < b, 0xFF, packed).to(torch.uint8)
    want = split_ternary_plain(x, w_q, packed, sx, sw, b)
    fn = ops.split_ternary_op if route == "op" else split_ternary
    got = fn(x, probe.t().contiguous().t(), probe_p, sx, sw, raw if route ==
             "op" else b)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("k,n", [(4096, 128256), (1024, 256206)])
def test_quant_matmul_at_the_frontend_archs_heads(cuda, m, k, n):
    """Both heads K-major, seamless's N 256206 odd (no multiple of a
    column tile, rows of the output off 16 bytes): the decode GEMM (M 4)
    and the wgmma GEMM (M 128) bit for bit, and nothing written past the
    output's last column."""
    x, w, _, sx, sw = _operands(m, k, n, m + n, cuda)
    out = torch.full((m * n + 64,), float("nan"), device=cuda)
    got = quant_matmul(x, w.t().contiguous().t(), sx, sw)
    out[:m * n] = got.reshape(-1)
    assert torch.equal(got, quant_matmul_plain(x, w, sx, sw))
    assert bool(out[m * n:].isnan().all())


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_reduced_frontend_forward_on_the_card_matches_the_plain_backend(
        cuda, arch, tmp_path):
    """Reduced llama-3.2-vision-11b (gates 1) and seamless-m4t-large-v2
    planned on diana: a prefill of 40 tokens with a frontend row per
    request (llama's cross wk / wv over the rows; seamless's encoder) and
    3 decode steps on the cached memory launch each planned layer as
    planned, and the logits equal those of the plain versions
    (``reference=True``) bit for bit."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch.serve import (frontend_rows, kv_cache_for,
                                          plan_mapping_execution)
    from repro_torch.launch.train import emit_static_mapping
    from repro_torch.models import transformer as T
    cfg = cfgbase.reduce_for_smoke(cfgbase.get(arch))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = T.init_lm(gen, cfg)
    if "cross" in cfg.pattern:
        params["units"][cfg.pattern.index("cross")]["gate"].fill_(1.0)
    art = emit_static_mapping(params, cfg, "diana", tmp_path / "m.json",
                              max_cout=64, act_log_scale=2.0)
    plan, backend = plan_mapping_execution(params, art)
    assert not backend.unbound
    cfg = kv_cache_for(cfg, art)
    prompts = torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                            generator=gen)
    rows = frontend_rows(cfg, 2, gen)

    def run():
        caches = T.init_cache(cfg, 2, 48, device=cuda)
        with _backend.use(backend):
            out = [T.prefill(params, cfg, prompts, caches,
                             cross_source=rows)[0]]
            for i in range(3):
                tok = out[-1].argmax(-1)
                out.append(T.decode_step(params, cfg, tok, caches,
                                         40 + i)[0])
        torch.cuda.synchronize()
        return out
    # a decode step runs neither the encoder nor the cross wk / wv: the
    # memory is cached
    kind = "cross" if "cross" in cfg.pattern else "dec"
    sub = f"units/{cfg.pattern.index(kind)}/" + \
        ("attn" if kind == "cross" else "xattn")
    want = dict.fromkeys(plan.kernel_histogram(), 0)
    for lp in plan.layers:
        prefill_only = lp.name.startswith(("enc_units/", f"{sub}/wk@",
                                           f"{sub}/wv@"))
        want[lp.kernel] += 1 if prefill_only else 4
    before = {k: getattr(ops, k).launches for k in want}
    got = run()
    assert {k: getattr(ops, k).launches - before[k] for k in want} == want
    backend.reference = True
    want = run()
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


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
    engine = Engine(cfg, params, max_batch=2, max_len=16, backend=backend,
                    kv_layout="dense")
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
    engine = Engine(cfg, params, max_batch=2, max_len=16, kv_layout="dense")
    res = {r.rid: r for r in engine.run(_engine_trace(cfg.vocab))}
    torch.cuda.synchronize()
    assert res[2].finish_reason == "length_cap"
    assert res[2].finished_step + 1 < min(res[3].finished_step,
                                          res[4].admitted_step)
    assert all(r.n_tokens >= 1 for r in res.values())
    assert bool(torch.isfinite(torch.ones(1, device=cuda)).all())


def _reduced_planned(dev, tmp_path):
    """Reduced yi-9b planned on diana (static scales, int8 KV) on ``dev``,
    from the same seed on every device: (cfg, params, backend, hist)."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch.serve import (kv_cache_for,
                                          plan_mapping_execution)
    from repro_torch.launch.train import emit_static_mapping
    from repro_torch.models import transformer as T
    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(to(v) for v in tree)
        return tree.to(dev)
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
    params = to(T.init_lm(torch.Generator().manual_seed(0), cfg))
    art = emit_static_mapping(params, cfg, "diana",
                              tmp_path / f"m_{dev.type}.json", max_cout=64,
                              act_log_scale=2.0)
    plan, backend = plan_mapping_execution(params, art)
    assert not backend.unbound
    return kv_cache_for(cfg, art), params, backend, plan.kernel_histogram()


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_paged_update_gather_on_the_card_match_the_cpu(cuda, dtype):
    """Scattered writes through shuffled page tables, masked and
    out-of-table ones among them (many rows onto the trash page): the pool
    outside the trash page and the gathered rows of mapped pages equal the
    CPU's."""
    rng = np.random.default_rng(9)
    ps, W, B, S, KVH, hd = 16, 8, 4, 40, 4, 128
    pages = np.zeros((B, W), np.int64)
    perm = rng.permutation(np.arange(1, 1 + B * W))
    for b in range(B):
        n = int(rng.integers(1, W + 1))
        pages[b, :n] = perm[b * W:b * W + n]
    val = torch.from_numpy(rng.integers(-127, 128, (B, S, KVH, hd))
                           .astype(np.float32) / 8).to(dtype)
    pool = torch.from_numpy(rng.integers(-127, 128, (1 + B * W, ps, KVH, hd))
                            .astype(np.float32) / 8).to(dtype)
    index = torch.from_numpy(rng.integers(0, W * ps, B))
    mask = torch.from_numpy(rng.random((B, S)) < 0.8)
    pages_t = torch.from_numpy(pages)
    want = A.paged_update(pool.clone(), val, pages_t, index, mask)
    got = A.paged_update(pool.to(cuda), val.to(cuda), pages_t.to(cuda),
                         index.to(cuda), mask.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got[1:].cpu(), want[1:])
    mapped = torch.from_numpy(np.repeat(pages > 0, ps, axis=1))
    view = A.paged_gather(got, pages_t.to(cuda)).cpu()
    assert torch.equal(view[mapped], A.paged_gather(want, pages_t)[mapped])


def test_prefill_chunk_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Chunks with mixed valid counts, then a decode step, on reduced
    yi-9b planned on diana: the card (the kernels) against the CPU (their
    plain versions) within 1e-4 on the live rows, int8 pools equal outside
    the trash page; every chunk launches each planned layer's kernel."""
    from repro_torch.models import transformer as T
    runs = []
    for dev in (torch.device("cpu"), cuda):
        cfg, params, backend, hist = _reduced_planned(dev, tmp_path)
        rng = np.random.default_rng(4)
        B, C, ps, W = 3, 8, 4, 8
        pages = torch.from_numpy(rng.permutation(np.arange(1, 1 + B * W))
                                 .reshape(B, W)).to(dev)
        caches = T.init_paged_cache(cfg, B, 1 + B * W, ps, device=dev)
        logits = []
        before = {k: getattr(ops, k).launches for k in hist}
        with _backend.use(backend):
            for index, valid in (([0, 0, 0], [8, 5, 0]),
                                 ([8, 5, 0], [3, 0, 8])):
                tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                                       (B, C))).to(dev)
                lg, caches = T.prefill_chunk(
                    params, cfg, tokens, caches,
                    torch.tensor(index, device=dev),
                    torch.tensor(valid, device=dev), pages)
                logits.append(lg.cpu())
            lg, caches = T.decode_step(
                params, cfg, torch.tensor([5, 6, 7], device=dev), caches,
                torch.tensor([11, 5, 8], device=dev),
                active=torch.tensor([True, True, False], device=dev),
                pages=pages)
            logits.append(lg.cpu())
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert {k: getattr(ops, k).launches - before[k] for k in hist} \
                == {k: 3 * n for k, n in hist.items()}
        runs.append((logits, {k: t.cpu() for k, t in
                              caches["units"][0].items()}))
    (want, want_pool), (got, got_pool) = runs
    for g, w, live in zip(got, want, ([0, 1], [0, 2], [0, 1])):
        assert bool(torch.isfinite(g[live]).all())
        assert float((g[live] - w[live]).abs().max()) < 1e-4
    for key in ("k", "v"):
        assert torch.equal(got_pool[key][:, 1:], want_pool[key][:, 1:])


def test_engine_paged_planned_on_diana_launches_kernels_like_the_plain_run(
        cuda, tmp_path):
    """The paged engine on the card: every chunk call and decode step
    launches each planned layer's kernel, the tokens equal those of the
    plain versions (``reference=True``), and a slot retired at the length
    cap writes nothing out of range."""
    from repro_torch.serving import Engine
    cfg, params, backend, hist = _reduced_planned(cuda, tmp_path)
    trace = _engine_trace(cfg.vocab)
    engine = Engine(cfg, params, max_batch=2, max_len=16, page_size=4,
                    backend=backend)
    before = {k: getattr(ops, k).launches for k in hist}
    got = engine.run(trace)
    torch.cuda.synchronize()
    forwards = engine.stats["prefill_calls"] + engine.stats["decode_steps"]
    assert {k: getattr(ops, k).launches - before[k] for k in hist} == \
        {k: n * forwards for k, n in hist.items()}
    backend.reference = True
    want = Engine(cfg, params, max_batch=2, max_len=16, page_size=4,
                  backend=backend).run(trace)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert "length_cap" in {r.finish_reason for r in got}


# --------------------------------------------------------------------------
# the CNN serving path's shapes (im2col'd convs, K and N held padded)
# --------------------------------------------------------------------------

#: (M, K held padded to 16, N) of the CNNs' layers on the kernel that runs
#: them: the resnet18 stem at batch 256 (M 1,048,576, K 27 -> 32), resnet20
#: and resnet18 convs and their heads at batch 1 and 256, mobilenet's
#: expanded depthwise convs (K 72 -> 80) and pointwise ones (K 8 -> 16)
CNN_INT8_SHAPES = {
    "ternary_matmul": [(1048576, 32, 64), (262144, 144, 16), (1024, 32, 16),
                       (65536, 288, 32), (64, 576, 64), (256, 576, 64),
                       (16384, 2304, 256), (1, 4608, 512)],
    "quant_matmul": [(589824, 80, 8), (147456, 144, 16), (36864, 16, 16),
                     (2304, 2304, 256), (256, 256, 2), (1, 256, 2),
                     (16, 64, 10)],
}
#: (M, K padded, N padded to 16, raw boundary): resnet20's head (N 10 in
#: 16) and a proj conv, resnet18's head (N 200 in 208, ternary above 128),
#: mobilenet's pointwise layers with ternary columns
CNN_SPLIT_SHAPES = [(1, 64, 16, 10), (256, 64, 16, 10),
                    (65536, 16, 32, 0), (256, 512, 208, 100),
                    (9216, 128, 256, 90), (576, 256, 256, 100)]


def _padded_codes(m, k, n, seed, dev, n_real=None):
    """int8 operands as `runtime.execute.prepare_layer` holds a padded
    layer: x (M, K), the codes as the K-major (K, N) view; columns past
    ``n_real`` zero."""
    x, w, t, sx, sw = _operands(m, k, n, seed, dev)
    if n_real is not None:
        w[:, n_real:] = 0
        t[:, n_real:] = 0
    return x, w.t().contiguous().t(), t.t().contiguous().t(), sx, sw


@pytest.mark.parametrize("m,k,n", CNN_INT8_SHAPES["ternary_matmul"])
def test_ternary_matmul_at_cnn_shapes(cuda, m, k, n):
    """Bit for bit, no weight copy, at the CNNs' shapes: K 32 inside the
    wgmma GEMM's 128-K stage (the TMA box past the tensor), N 16-64 inside
    its 128-column tile, M past 10**6."""
    x, _, t, sx, sw = _padded_codes(m, k, n, 20, cuda)
    copies = ternary_matmul.transposed_copies
    got = ternary_matmul(x, t, sx, sw)
    torch.cuda.synchronize()
    assert ternary_matmul.transposed_copies == copies
    assert torch.equal(got, ternary_matmul_plain(x, t, sx, sw))


@pytest.mark.parametrize("m,k,n", CNN_INT8_SHAPES["quant_matmul"])
def test_quant_matmul_at_cnn_shapes(cuda, m, k, n):
    x, w, _, sx, sw = _padded_codes(m, k, n, 21, cuda)
    copies = quant_matmul.transposed_copies
    got = quant_matmul(x, w, sx, sw)
    torch.cuda.synchronize()
    assert quant_matmul.transposed_copies == copies
    assert torch.equal(got, quant_matmul_plain(x, w, sx, sw))


@pytest.mark.parametrize("m,k,n,raw", CNN_SPLIT_SHAPES)
def test_split_ternary_at_cnn_shapes(cuda, m, k, n, raw):
    """Through the op (the boundary aligned to the 128-column block, as a
    served layer's), on codes and a packed stream held N-padded."""
    x, w, t, sx, sw = _padded_codes(m, k, n, 22, cuda)
    cols = torch.arange(n, device=cuda)[None, :]
    b_al = min(ops.align_boundary(raw, 128), n)
    w_q = torch.where(cols < b_al, w, t).t().contiguous().t()
    # packed from row-major codes, as `prepare_layer` packs them
    packed = pack_ternary(torch.where(cols >= b_al, t, 0).to(
        torch.int8).contiguous())
    copies = ops.split_ternary.transposed_copies
    got = ops.split_ternary_op(x, w_q, packed, sx, sw, raw)
    torch.cuda.synchronize()
    assert ops.split_ternary.transposed_copies == copies
    assert torch.equal(got, split_ternary_plain(x, w_q, packed, sx, sw,
                                                b_al))


@pytest.mark.parametrize("m,k,n,raw", [
    (1, 64, 16, 10), (256, 64, 16, 10), (65536, 16, 32, 20),
    (262144, 32, 16, 9), (256, 256, 16, 1), (9216, 128, 256, 200)])
def test_split_precision_at_cnn_shapes(cuda, m, k, n, raw):
    """At the CNNs' shapes the boundary rounds up to N (bn 128): every
    column runs int8, bit for bit; the bf16 weight is never read (NaN)."""
    x_q, w, _, sx, sw = _padded_codes(m, k, n, 23, cuda)
    x = torch.randn((m, k), device=cuda).to(torch.bfloat16)
    w_b = torch.full((k, n), float("nan"), device=cuda,
                     dtype=torch.bfloat16)
    copies = split_precision.transposed_copies
    got = ops.split_precision_op(x, x_q, sx, w_b, w, sw, raw)
    torch.cuda.synchronize()
    assert split_precision.transposed_copies == copies
    assert torch.equal(got, split_precision_plain(x, x_q, sx, w_b, w, sw,
                                                  n))


@pytest.mark.parametrize("name,platform", [("resnet20", "diana"),
                                           ("resnet20", "gpu_tc_like"),
                                           ("mobilenetv1_025", "diana"),
                                           ("mobilenetv1_025",
                                            "gpu_tc_like")])
def test_cnn_planned_on_the_card_launches_kernels_like_the_plain_run(
        cuda, tmp_path, name, platform):
    """A full-width CNN at batch 8, planned: every layer launches its
    kernel once per forward, no weight is copied, and the logits equal the
    plain versions' (``reference=True``) bit for bit."""
    from repro_torch.launch.serve import plan_mapping_execution
    from repro_torch.launch.train import emit_static_mapping
    from repro_torch.models import cnn as C
    cfg = C.get_config(name)
    init_fn, apply_fn, _ = C.get_model(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_fn(gen, cfg)
    art = emit_static_mapping(params, cfg, platform, tmp_path / "m.json",
                              plan_hints=C.plan_hints(cfg))
    plan, backend = plan_mapping_execution(params, art)
    assert not backend.unbound
    hist = plan.kernel_histogram()
    x = torch.randn((8, *cfg.img_hw, cfg.in_ch), generator=gen, device=cuda)
    kernels = ("quant_matmul", "ternary_matmul", "split_ternary",
               "split_precision")
    before = {k: getattr(ops, k).launches for k in kernels}
    copies = {k: getattr(ops, k).transposed_copies for k in kernels}
    with _backend.use(backend):
        got = apply_fn(params, x, cfg)
        torch.cuda.synchronize()
        assert {k: getattr(ops, k).launches - before[k] for k in kernels} \
            == {k: hist.get(k, 0) for k in kernels}
        assert {k: getattr(ops, k).transposed_copies for k in kernels} == \
            copies
        backend.reference = True
        want = apply_fn(params, x, cfg)
    assert not backend.runtime_declines
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())


# --------------------------------------------------------------------------
# the precision bank and the engine features on it
# --------------------------------------------------------------------------

def _reduced_bank(dev, tmp_path):
    """Reduced yi-9b on ``dev`` (float32 params, bf16 KV cache) and the
    bank the chip smoke serves, at reduced width: target diana
    (quant_matmul 5 + split_ternary 10), draft all-ternary diana
    (quant_matmul 5 + ternary_matmul 10).  Returns (cfg, params, bank)."""
    import dataclasses
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch.serve import build_planset
    from repro_torch.launch.train import emit_static_mapping
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(cfgbase.reduce_for_smoke(cfgbase.get("yi-9b")),
                              param_dtype="float32")
    params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    arts = {v: emit_static_mapping(params, cfg, "diana",
                                   tmp_path / f"{v}.json", max_cout=64,
                                   act_log_scale=2.0, bias=bias)
            for v, bias in (("target", None), ("draft", ("aimc", 1.0)))}
    _, bank = build_planset(params, arts, "target")
    assert bank.fully_covered
    return cfg, params, bank


def test_planset_bank_on_the_card_shares_and_launches_per_variant(
        cuda, tmp_path):
    """The bank on the card: the pinned layers' prepared tensors are shared
    (dedup_saved_bytes > 0), and a prefill under each variant launches that
    variant's kernels, with the plain versions' logits."""
    from repro_torch.models import transformer as T
    cfg, params, bank = _reduced_bank(cuda, tmp_path)
    rep = bank.memory_report()
    assert rep["dedup_saved_bytes"] > 0 and len(rep["shared_layers"]) == 3
    tokens = torch.arange(12, device=cuda).reshape(1, 12) % cfg.vocab
    want = {"target": {"quant_matmul": 5, "split_ternary": 10},
            "draft": {"quant_matmul": 5, "ternary_matmul": 10}}
    for variant, hist in want.items():
        out = {}
        for reference in (False, True):
            bank.reference = reference
            before = {k: getattr(ops, k).launches for k in hist}
            with _backend.use(bank):
                out[reference], _ = T.prefill(
                    params, cfg, tokens, T.init_cache(cfg, 1, 16,
                                                      device=cuda),
                    variant=variant)
            torch.cuda.synchronize()
            got = {k: getattr(ops, k).launches - before[k] for k in hist}
            assert got == (dict.fromkeys(hist, 0) if reference else hist)
        bank.reference = False
        assert torch.equal(out[False], out[True])


def test_speculative_rounds_on_the_card_launch_per_formula(cuda, tmp_path):
    """Speculation on the card: per round k draft steps (quant_matmul +
    ternary_matmul) and one verify chunk (quant_matmul + split_ternary);
    the tokens are the target-only run's and the plain versions'."""
    from repro_torch.serving import Engine, synthetic_trace
    cfg, params, bank = _reduced_bank(cuda, tmp_path)
    trace = synthetic_trace(4, vocab=cfg.vocab, seed=3, min_prompt=4,
                            max_prompt=10, min_new=4, max_new=10)
    k = 4
    names = ("quant_matmul", "ternary_matmul", "split_ternary")
    before = {n: getattr(ops, n).launches for n in names}
    spec = Engine(cfg, params, max_batch=2, max_len=64, backend=bank,
                  speculate=("draft", "target"), draft_k=k)
    got = spec.run(trace)
    torch.cuda.synchronize()
    chunks, rounds = spec.stats["prefill_calls"], spec.stats["spec_rounds"]
    assert {n: getattr(ops, n).launches - before[n] for n in names} == {
        "quant_matmul": 5 * (chunks + rounds * (k + 1)),
        "ternary_matmul": 10 * k * rounds,
        "split_ternary": 10 * (chunks + rounds)}
    assert spec.stats["spec_committed"] == sum(r.n_tokens - 1 for r in got)
    target = Engine(cfg, params, max_batch=2, max_len=64,
                    backend=bank).run(trace)
    bank.reference = True
    plain = Engine(cfg, params, max_batch=2, max_len=64, backend=bank,
                   speculate=("draft", "target"), draft_k=k).run(trace)
    bank.reference = False
    assert [r.tokens for r in got] == [r.tokens for r in target] == \
        [r.tokens for r in plain]


@pytest.mark.parametrize("kind", ["nonfinite_logits", "corrupt_page",
                                  "stuck"])
def test_fault_of_each_kind_contained_on_the_card(cuda, tmp_path, kind):
    """An injected fault on the card (the NaN added on the device, NaN in
    the bf16 KV pages, a stuck slot) is detected, the request requeued
    once, and its tokens are a clean run's."""
    from repro_torch.serving import Engine, FaultEvent, FaultInjector, \
        Request
    cfg, params, bank = _reduced_bank(cuda, tmp_path)
    req = Request(rid="f0", prompt=np.arange(8) % cfg.vocab,
                  max_new_tokens=10)
    kw = dict(max_batch=1, max_len=48, page_size=8, backend=bank)
    (clean,) = Engine(cfg, params, **kw).run([req])
    inj = FaultInjector(events=[FaultEvent(kind, 4, 0, duration=100)])
    eng = Engine(cfg, params, injector=inj, heartbeat_steps=4, **kw)
    (r,) = eng.run([req])
    assert r.requeues == 1 and r.tokens == clean.tokens
    assert eng.stats["faults_injected"] == 1
    key = "heartbeat_trips" if kind == "stuck" else "faults_detected"
    assert eng.stats[key] >= 1


@pytest.fixture
def no_tf32():
    """TF32 off for the test's float32 convs and matmuls, then restored."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _update_rel_by_group(old, new, want):
    """Relative L2 of the card's update ``new - old`` against the CPU's
    ``want - old``, by leaf group (the leaves' last key); a group the CPU
    leaves still must stay still on the card."""
    from repro_torch.core import tree as T
    groups = {}
    for (path, o), n, w in zip(T.leaves_with_paths(old), T.leaves(new),
                               T.leaves(want)):
        o = o.cpu()
        g = groups.setdefault(path[-1], ([], []))
        g[0].append((n.cpu() - o).ravel())
        g[1].append((w - o).ravel())
    rel = {}
    for key, (a, b) in groups.items():
        a, b = torch.cat(a).double(), torch.cat(b).double()
        if not bool(b.any()):
            assert not bool(a.any()), key
            continue
        rel[key] = float((a - b).norm() / b.norm())
    return rel


# dtype -> (loss and task loss rtol, update rtol by leaf group)
_SEARCH_STEP_TOL = {torch.float64: (1e-6, 1e-4),
                    torch.float32: (1e-3, 0.3)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_search_train_steps_on_the_card_match_the_cpu(cuda, no_tf32, dtype):
    """Three search-mode train steps of `SearchPipeline` on ResNet20_tiny
    (diana, lambda 1e-6) on the card, each repeated on the CPU from the
    card's params, AdamW state and batch: the regularizer within 1e-5
    relative, all params finite, and by dtype:

    * float64, where no fake-quant rounding goes the other way: the loss
      and the task loss within 1e-6 relative, each leaf group's update
      within 1e-4 relative L2 of the CPU's (AdamW computes in float32;
      readings on an H100 up to 3.5e-7);
    * float32: cuDNN sums in another order, and a rounding that goes the
      other way moves the loss by up to 3e-4 (second step on an H100), so
      the losses within 1e-3 and each group's update within 0.3 relative
      L2.  Readings on an H100, six runs: up to 0.133 for the 22
      activation scales of the second step and 0.069 for every other
      group; a skipped step reads 1, a step at half the rate 0.5.  The
      readings are printed.
    """
    from repro_torch import api as A
    from repro_torch.core import tree as T
    from repro_torch.data.pipeline import ImageTaskConfig, image_batch
    from repro_torch.models import cnn as C
    from repro_torch.optim import adamw
    loss_tol, upd_tol = _SEARCH_STEP_TOL[dtype]
    handle = A.cnn_handle(C.RESNET20_TINY)
    scfg = A.SearchConfig(lam=1e-6, batch=8)
    task = ImageTaskConfig(n_classes=10, img_hw=(16, 16))
    ctx = {dev: A.SearchPipeline(handle, "diana", config=scfg, data_fn=None,
                                 device=dev)._build_context()
           for dev in ("cpu", "cuda")}
    p = T.tree_map(lambda t: t.to(dtype), handle.init(
        torch.Generator(device="cuda").manual_seed(0), ctx["cuda"].spec))
    opt = adamw.init(p, ctx["cuda"].ocfg)
    to_cpu = lambda tree: T.tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    for i in range(3):
        x, y = image_batch(task, A.pipeline.SEARCH_DATA_OFFSET + i, 8)
        x = x.to(dtype)
        tau = float(A.pipeline.odimo.tau_schedule(i, 3, ctx["cuda"].spec))
        cpu = ctx["cpu"].train_step(
            to_cpu(p), adamw.AdamWState(opt.step.cpu(), to_cpu(opt.mu),
                                        to_cpu(opt.nu)),
            (x.cpu(), y.cpu()), tau, scfg.lr, "search")
        old = p
        p, opt, l, task_l, reg = ctx["cuda"].train_step(
            p, opt, (x, y), tau, scfg.lr, "search")
        assert all(bool(torch.isfinite(t).all()) for t in T.leaves(p))
        assert {t.dtype for t in T.leaves(p)} == {dtype}
        np.testing.assert_allclose(float(reg), float(cpu[4]), rtol=1e-5)
        np.testing.assert_allclose([float(l), float(task_l)],
                                   [float(cpu[2]), float(cpu[3])],
                                   rtol=loss_tol)
        rel = _update_rel_by_group(old, p, cpu[0])
        print(f"{dtype} step {i}: loss {float(l)} (CPU {float(cpu[2])}), "
              f"update relative L2 by leaf group "
              f"{ {k: f'{v:.3g}' for k, v in rel.items()} }")
        assert max(rel.values()) < upd_tol, (i, rel)


def _train_cfg(arch):
    import dataclasses
    from repro_torch.configs import base as cfgbase
    return dataclasses.replace(cfgbase.reduce_for_smoke(cfgbase.get(arch)),
                               param_dtype="float32")


def test_train_lm_loss_and_grads_on_the_card_match_the_cpu(cuda, no_tf32):
    """Reduced float32 zamba2 (Mamba2 blocks, the shared attention block):
    the loss within 1e-5 relative and every gradient leaf within 1e-4 of
    the leaf's largest CPU gradient (+ 1e-6), remat on; no leaf's
    gradient all zero."""
    from repro_torch.core import tree as T
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models import transformer as TR
    cfg = _train_cfg("zamba2-1.2b")
    params = TR.init_lm(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))
             for k in ("tokens", "targets")}
    got = {}
    for dev in ("cpu", "cuda"):
        p = T.tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        got[dev] = value_and_grad(
            lambda q: TR.lm_loss(q, cfg, b, remat=True), p)
    (lc, gc), (lg, gg) = got["cpu"], got["cuda"]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    for (path, c), g in zip(T.leaves_with_paths(gc), T.leaves(gg)):
        g = g.cpu()
        assert bool(g.ne(0).any()), path
        assert float((g - c).abs().max()) <= \
            1e-4 * float(c.abs().max()) + 1e-6, path


def test_train_kernel_wrappers_refuse_autograd(cuda):
    """Each hand-written kernel's wrapper raises on an input that
    requires grad under grad mode (the kernels have no backward pass), and
    launches under torch.no_grad()."""
    x, w, t, sx, sw = _operands(8, 256, 128, 0, cuda)
    packed = pack_ternary(t)
    sxg = sx.clone().requires_grad_(True)
    xb = torch.randn((8, 256), device=cuda, dtype=torch.bfloat16)
    wb = torch.randn((256, 128), device=cuda, dtype=torch.bfloat16)
    q = torch.randn((1, 4, 128, 128), device=cuda, dtype=torch.bfloat16)
    calls = {
        "quant_matmul": lambda s: quant_matmul(x, w, s, sw),
        "ternary_matmul": lambda s: ternary_matmul(x, t, s, sw),
        "split_ternary": lambda s: split_ternary(x, w, packed, s, sw, 64),
        "ternary_packed": lambda s: ternary_packed_matmul(x, packed, s, sw),
        "split_precision": lambda s: split_precision(xb, x, s, wb, w, sw, 64),
        "flash_attention": lambda s: flash_attention(
            q.requires_grad_(s.requires_grad), q, q),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}.*no backward"):
            call(sxg)
        with torch.no_grad():
            call(sxg)
        call(sx)


def test_train_lm_loss_past_2048_tokens_raises_on_the_card(cuda):
    """Above 2048 tokens lm_loss takes the chunked attention, the flash
    kernel on the card, which has no backward pass: under autograd that
    is a NotImplementedError naming it, not a silent detach."""
    from repro_torch.models import transformer as TR
    cfg = _train_cfg("yi-9b")
    params = TR.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg)
    tok = torch.zeros((1, 3072), dtype=torch.long, device=cuda)
    with pytest.raises(NotImplementedError, match="flash"):
        TR.lm_loss(params, cfg, {"tokens": tok, "targets": tok})


# ---------------------------------------------------------------- dry run

DRY_TINY = {"tiny_decode": dict(kind="decode", seq=256, batch=2),
            "tiny_prefill": dict(kind="prefill", seq=128, batch=2),
            "tiny_train": dict(kind="train", seq=64, batch=2)}


@pytest.mark.parametrize("arch,shape,variant", [
    ("yi-9b", "tiny_decode", "base"), ("yi-9b", "tiny_prefill", "kvwq8"),
    ("zamba2-1.2b", "tiny_decode", "kvwq8"), ("xlstm-1.3b", "tiny_decode",
                                              "base"),
    ("deepseek-v2-lite-16b", "tiny_decode", "wq8"),
    ("h2o-danube-3-4b", "tiny_train", "base")])
def test_dryrun_on_the_card_equals_a_real_run(cuda, monkeypatch, tmp_path,
                                               arch, shape, variant):
    """`run_cell` on the card's (1, 1) mesh (fake tensors, nothing
    launched) against the same step run for real on the card on a reduced
    config: FLOPs and argument bytes equal, the real peak less the
    arguments within 10 % or 256 MiB of the dry run's temp."""
    import dataclasses
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as SP
    for k, v in DRY_TINY.items():
        monkeypatch.setitem(SP.SHAPES, k, v)
    red = cfgbase.reduce_for_smoke(cfgbase.get(arch))
    name = f"tiny-{arch}"
    monkeypatch.setitem(cfgbase._REGISTRY, name,
                        dataclasses.replace(red, name=name))
    rec = D.run_cell(name, shape, M.single_gpu_mesh(), tmp_path,
                     variant=variant)
    assert rec["status"] == "ok" and rec["device"] == \
        torch.cuda.get_device_name(0)
    cfg = D.cell_config(name, variant)
    step, _ = D.cell_step(cfg, shape)
    args = D.concrete_args(cfg, shape,
                           torch.Generator(device=cuda).manual_seed(0))
    mem = rec["memory_analysis"]
    assert D.tree_bytes(args) == mem["argument_size_in_bytes"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - before
    assert fc.get_total_flops() == rec["cost_analysis"]["flops"] > 0
    assert abs(temp - mem["temp_size_in_bytes"]) <= max(
        0.1 * mem["temp_size_in_bytes"], 256 * 2**20)
    del out


def _deploy_assignment(n, kind, rng):
    """All int8, all bf16, or a random half bf16 whose int8 count is off
    the 128-column block (the sort's boundary is not a multiple of 128)."""
    if kind in ("int8", "bf16"):
        return np.full(n, int(kind == "bf16"), np.int64)
    a = np.ones(n, np.int64)
    a[rng.choice(n, n // 2 + 37, replace=False)] = 0
    return a


@pytest.mark.parametrize("kind", ["random", "int8", "bf16"])
@pytest.mark.parametrize("m", [4, 128, 512])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008)])
def test_odimo_deployed_dense_on_the_card(cuda, k, n, m, kind):
    """`ops.odimo_deployed_dense` at yi-9b's widths: one split_precision
    launch and no weight copy per call; against the plain version in the
    ORIGINAL column order, the columns the aligned boundary runs int8 bit
    for bit, the others within `bf16_error_bound`."""
    from repro_torch.core import quant
    rng = np.random.default_rng(m + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.02)
                         .astype(np.float32))
    assign = _deploy_assignment(n, kind, rng)
    x, w = x.to(cuda), w.to(cuda)
    wls, xls = quant.init_log_scale(w), quant.init_log_scale(x)
    launches = split_precision.launches
    copies = split_precision.transposed_copies
    got = ops.odimo_deployed_dense(x, w, assign, wls, xls)
    torch.cuda.synchronize()
    assert split_precision.launches == launches + 1
    assert split_precision.transposed_copies == copies
    perm = np.argsort(assign, kind="stable")
    b_al = min(ops.align_boundary(int((assign == 0).sum()), 128), n)
    int8 = torch.from_numpy(np.argsort(perm) < b_al).to(cuda)
    if kind == "random":
        assert 0 < int(int8.sum()) < n and (assign == 0).sum() % 128
    levels = quant.qlevels(8)
    sx = (torch.exp(xls) / levels).reshape(1)
    sw = (torch.exp(wls) / levels).reshape(1).expand(n)
    lo = quant_matmul_plain(quant.quantize_int(x, xls, 8),
                            quant.quantize_int(w, wls, 8), sx, sw)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    hi = (xb.double() @ wb.double()).float()
    assert torch.equal(got[:, int8], lo[:, int8])
    err = (got.double() - hi.double()).abs()
    bound = bf16_error_bound(xb, wb, hi)
    assert bool((err <= bound)[:, ~int8].all())
