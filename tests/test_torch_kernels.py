"""Plain versions of the port's kernels against the JAX package's ops
(Pallas in interpret mode on the CPU) and oracles, plus the 2-bit packing
layout.  Integer contractions agree bit for bit; the bf16 columns of
split_precision agree within the float32 summation bound
``K * 2**-24 * sum_k |x * w| + 2**-24 * |y|`` (the JAX kernel sums in
float32, the port's plain version in float64).  Inputs are made with
numpy from a seed and handed to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ternary_packed as jpacked  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.kernels.split_precision import (  # noqa: E402
    bf16_error_bound, split_precision)
from repro_torch.kernels.split_ternary import split_ternary  # noqa: E402
from repro_torch.kernels.ternary_matmul import ternary_matmul  # noqa: E402
from repro_torch.kernels.ternary_packed import (pack_ternary,  # noqa: E402
                                                unpack_ternary)

# (M, K, N): M=1 decode rows, K % 4 != 0, N not a multiple of 128
SHAPES = [(1, 37, 200), (5, 64, 130), (3, 20, 256)]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _operands(m, k, n, boundary, seed):
    """x int8, per-domain codes (int8 below ``boundary``, ternary at and
    above), the K-padded ternary codes of the packed stream, sx, sw."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (m, k), dtype=np.int8)
    w8 = rng.integers(-127, 128, (k, n), dtype=np.int8)
    wt = rng.integers(-1, 2, (k, n), dtype=np.int8)
    cols = np.arange(n)[None, :]
    w_q = np.where(cols < boundary, w8, wt).astype(np.int8)
    k4 = -(-k // 4) * 4
    w_t4 = np.zeros((k4, n), np.int8)
    w_t4[:k] = np.where(cols >= boundary, wt, 0)
    sx = np.float32(rng.uniform(0.01, 0.1))
    sw = rng.uniform(1e-3, 0.5, n).astype(np.float32)
    return x, w_q, w_t4, sx, sw


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quant_matmul_plain_matches_jax_bit_exact(m, k, n):
    x, w_q, _, sx, sw = _operands(m, k, n, n, 0)
    want_op = np.asarray(jops.quant_matmul_op(x, w_q, jnp.float32(sx), sw))
    want_ref = np.asarray(jref.quant_matmul_ref(x, w_q, jnp.float32(sx), sw))
    before = quant_matmul.launches
    got = quant_matmul(_t(x), _t(w_q), _t(sx), _t(sw)).numpy()
    assert quant_matmul.launches == before   # CPU tensors: plain version
    np.testing.assert_array_equal(got, want_op)
    np.testing.assert_array_equal(got, want_ref)
    got_op = ops.quant_matmul_op(_t(x), _t(w_q), _t(sx), _t(sw)).numpy()
    np.testing.assert_array_equal(got_op, want_op)


def test_quant_matmul_plain_exact_at_large_k():
    """127**2 * K > 2**24: a float32 product would round; the plain version
    must not."""
    k = 11008
    x = np.full((2, k), 127, np.int8)
    w = np.full((k, 3), -127, np.int8)
    w[0, 0] = 126
    got = quant_matmul(_t(x), _t(w), torch.tensor(1.0), torch.ones(3))
    acc = x.astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), acc.astype(np.float32))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("where", ["zero", "raw7", "raw130", "all"])
def test_split_ternary_plain_matches_jax_bit_exact(m, k, n, where):
    boundary = {"zero": 0, "raw7": 7, "raw130": min(130, n), "all": n}[where]
    x, w_q, w_t4, sx, sw = _operands(m, k, n, boundary, 1)
    w_p = np.asarray(jpacked.pack_ternary(jnp.asarray(w_t4)))
    want = np.asarray(jops.split_ternary_op(x, w_q, w_p, jnp.float32(sx),
                                            sw, boundary))
    before = split_ternary.launches
    got = ops.split_ternary_op(_t(x), _t(w_q), _t(w_p), _t(sx), _t(sw),
                               boundary).numpy()
    assert split_ternary.launches == before
    np.testing.assert_array_equal(got, want)
    b_al = min(ops.align_boundary(boundary, ops.block_n(128, n)), n)
    want_ref = np.asarray(jref.split_ternary_matmul_ref(
        x, w_q, w_q, jnp.float32(sx), sw, b_al))
    got_ref = ref.split_ternary_matmul_ref(_t(x), _t(w_q), _t(w_q), _t(sx),
                                           _t(sw), b_al).numpy()
    np.testing.assert_array_equal(got_ref, want_ref)
    np.testing.assert_array_equal(got, want_ref)


def test_split_ternary_reads_packed_stream_above_boundary():
    """Codes of w_q at and above the aligned boundary do not reach the
    output: those columns come from the packed stream."""
    m, k, n, boundary = 3, 36, 300, 7
    x, w_q, w_t4, sx, sw = _operands(m, k, n, boundary, 2)
    w_p = pack_ternary(_t(w_t4))
    clean = ops.split_ternary_op(_t(x), _t(w_q), w_p, _t(sx), _t(sw),
                                 boundary)
    probe = w_q.copy()
    probe[:, 128:] = 99
    got = ops.split_ternary_op(_t(x), _t(probe), w_p, _t(sx), _t(sw),
                               boundary)
    assert torch.equal(got, clean)


@pytest.mark.parametrize("m", [3, 20])
@pytest.mark.parametrize("n", [130, 200])
@pytest.mark.parametrize("where", ["zero", "raw7", "all"])
def test_split_ternary_kernel_operands_match_jax(m, n, where):
    """The operands the wrapper hands the kernel at N off 16 (x and the
    K-major codes with K padded to 16, both streams and sw with N padded to
    16 for the wgmma GEMM at M 20, to 4 for the decode one at M 3), through
    the plain version's arithmetic, give the JAX op's output bit for bit on
    the first N columns."""
    from repro_torch.kernels import split_ternary as st
    from repro_torch.kernels.quant_matmul import _pad_to
    boundary = {"zero": 0, "raw7": 7, "all": n}[where]
    k = 37
    x, w_q, w_t4, sx, sw = _operands(m, k, n, boundary, 5)
    w_p = np.asarray(jpacked.pack_ternary(jnp.asarray(w_t4)))
    want = np.asarray(jops.split_ternary_op(x, w_q, w_p, jnp.float32(sx),
                                            sw, boundary))
    xq, wk, wp, swp = st.kernel_operands(_t(x), _t(w_q), _t(w_p), _t(sw))
    n_pad = -(-n // (16 if m > 16 else 4)) * (16 if m > 16 else 4)
    assert tuple(xq.shape) == (m, 48) and tuple(wk.shape) == (n_pad, 48)
    assert tuple(wp.shape) == (10, n_pad) and tuple(swp.shape) == (n_pad,)
    b_al = min(ops.align_boundary(boundary, ops.block_n(128, n)), n)
    w_t = _pad_to(unpack_ternary(wp), 16, 0)    # rows past 4 Kp: zero
    got = ref.split_ternary_matmul_ref(xq, wk.t(), w_t, _t(sx), swp, b_al)
    np.testing.assert_array_equal(got[:, :n].numpy(), want)


@pytest.mark.parametrize("k,n", [(4, 1), (36, 130), (64, 7)])
def test_pack_ternary_bit_identical_to_jax(k, n):
    rng = np.random.default_rng(k * n)
    w_t = rng.integers(-1, 2, (k, n), dtype=np.int8)
    want = np.asarray(jpacked.pack_ternary(jnp.asarray(w_t)))
    got = pack_ternary(_t(w_t))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(unpack_ternary(got).numpy(), w_t)
    np.testing.assert_array_equal(
        unpack_ternary(got).numpy(),
        np.asarray(jpacked.unpack_ternary(jnp.asarray(want))))


@pytest.mark.parametrize("b,bn", [(0, 128), (7, 128), (128, 128),
                                  (300, 128), (5, 64)])
def test_align_boundary_matches_jax(b, bn):
    assert ops.align_boundary(b, bn) == jops.align_boundary(b, bn)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_ternary_matmul_plain_matches_jax_bit_exact(m, k, n):
    x, w_t, _, sx, sw = _operands(m, k, n, 0, 4)   # every column ternary
    want_op = np.asarray(jops.ternary_matmul_op(x, w_t, jnp.float32(sx),
                                                sw))
    want_ref = np.asarray(jref.ternary_matmul_ref(x, w_t, jnp.float32(sx),
                                                  sw))
    before = ternary_matmul.launches
    got = ops.ternary_matmul_op(_t(x), _t(w_t), _t(sx), _t(sw)).numpy()
    assert ternary_matmul.launches == before   # CPU tensors: plain version
    np.testing.assert_array_equal(got, want_op)
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(
        ref.ternary_matmul_ref(_t(x), _t(w_t), _t(sx), _t(sw)).numpy(),
        want_ref)


def _split_operands(m, k, n, seed):
    """bf16 activations and weights (as exact float32 values), int8
    activations and codes, sx, sw; the two domains' weights are
    independent, so a split at the wrong column shows."""
    rng = np.random.default_rng(seed)
    bf16 = lambda a: torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    x = bf16(rng.normal(0, 1.5, (m, k)))
    w_b = bf16(rng.normal(0, 0.05, (k, n)))
    x_q = rng.integers(-127, 128, (m, k), dtype=np.int8)
    w_q = rng.integers(-127, 128, (k, n), dtype=np.int8)
    sx = np.float32(rng.uniform(0.01, 0.1))
    sw = rng.uniform(1e-3, 0.5, n).astype(np.float32)
    return x, x_q, sx, w_b, w_q, sw


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _assert_split_close(got, want, x, w_b, b_al):
    """int8 columns bit for bit, bf16 columns within the float32 summation
    bound of `bf16_error_bound` (with ``y`` = ``want``)."""
    got, want = np.array(got), np.array(want)
    np.testing.assert_array_equal(got[:, :b_al], want[:, :b_al])
    bound = bf16_error_bound(_bf16(x), _bf16(w_b),
                             torch.from_numpy(want)).numpy()
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err[:, b_al:] <= bound[:, b_al:]), \
        float((err - bound)[:, b_al:].max())


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("where", ["zero", "raw7", "raw130", "all"])
@pytest.mark.parametrize("bn", [128, 16])
def test_split_precision_plain_matches_jax(m, k, n, where, bn):
    boundary = {"zero": 0, "raw7": 7, "raw130": min(130, n), "all": n}[where]
    x, x_q, sx, w_b, w_q, sw = _split_operands(m, k, n, 5)
    want = np.asarray(jops.split_precision_op(
        jnp.asarray(x, jnp.bfloat16), x_q, jnp.float32(sx),
        jnp.asarray(w_b, jnp.bfloat16), w_q, sw, boundary, bn=bn))
    b_al = min(ops.align_boundary(boundary, ops.block_n(bn, n)), n)
    want_ref = np.asarray(jref.split_precision_matmul_ref(
        jnp.asarray(x, jnp.bfloat16), x_q, jnp.float32(sx),
        jnp.asarray(w_b, jnp.bfloat16), w_q, sw, b_al))
    before = split_precision.launches
    got = ops.split_precision_op(_bf16(x), _t(x_q), _t(sx), _bf16(w_b),
                                 _t(w_q), _t(sw), boundary, bn=bn).numpy()
    assert split_precision.launches == before
    _assert_split_close(got, want, x, w_b, b_al)
    _assert_split_close(got, want_ref, x, w_b, b_al)
    got_ref = ref.split_precision_matmul_ref(
        _bf16(x), _t(x_q), _t(sx), _bf16(w_b), _t(w_q), _t(sw), b_al)
    np.testing.assert_array_equal(got_ref.numpy(), got)


@pytest.mark.parametrize("n,bn,boundary", [(130, 128, 7), (130, 128, 130),
                                           (64, 16, 43), (300, 16, 130),
                                           (300, 128, 0), (40, 16, 40),
                                           (512, 128, 342)])
def test_split_precision_splits_where_jax_does(n, bn, boundary):
    """The alignment contract: the JAX op and the port's op switch from
    int8 to bf16 at the same column, ``min(align_boundary(b, block_n(bn,
    n)), n)``.  x = 0 and all codes 1 make int8 columns K and bf16 columns
    0."""
    m, k = 2, 8
    x = np.zeros((m, k), np.float32)
    x_q = np.ones((m, k), np.int8)
    w_q = np.ones((k, n), np.int8)
    w_b = np.ones((k, n), np.float32)
    sw = np.ones(n, np.float32)
    jout = np.asarray(jops.split_precision_op(
        jnp.asarray(x, jnp.bfloat16), x_q, jnp.float32(1.0),
        jnp.asarray(w_b, jnp.bfloat16), w_q, sw, boundary, bn=bn))
    got = ops.split_precision_op(_bf16(x), _t(x_q), torch.tensor(1.0),
                                 _bf16(w_b), _t(w_q), _t(sw), boundary,
                                 bn=bn).numpy()
    split = min(ops.align_boundary(boundary, ops.block_n(bn, n)), n)
    assert ops.block_n(bn, n) == min(bn, max(128, n))
    assert int((jout[0] == k).sum()) == split
    np.testing.assert_array_equal(got, jout)


def test_split_precision_reads_each_domain_on_its_side():
    """The split probe: int8 codes at and above the aligned boundary and
    bf16 weights below it do not reach the output."""
    m, k, n, boundary, bn = 3, 36, 300, 130, 16
    x, x_q, sx, w_b, w_q, sw = _split_operands(m, k, n, 6)
    b_al = min(ops.align_boundary(boundary, ops.block_n(bn, n)), n)
    args = (_bf16(x), _t(x_q), _t(sx))
    clean = ops.split_precision_op(*args, _bf16(w_b), _t(w_q), _t(sw),
                                   boundary, bn=bn)
    probe_q, probe_b = w_q.copy(), w_b.copy()
    probe_q[:, b_al:] = 99
    probe_b[:, :b_al] = np.nan
    got = ops.split_precision_op(*args, _bf16(probe_b), _t(probe_q),
                                 _t(sw), boundary, bn=bn)
    assert b_al == 144 and torch.equal(got, clean)


def test_cuda_wrappers_reject_bad_operands():
    x = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        quant_matmul(x, torch.zeros((9, 4), dtype=torch.int8),
                     torch.tensor(1.0), torch.ones(4))
    with pytest.raises(TypeError):
        quant_matmul(x.float(), torch.zeros((8, 4), dtype=torch.int8),
                     torch.tensor(1.0), torch.ones(4))
    with pytest.raises(ValueError):
        split_ternary(x, torch.zeros((8, 4), dtype=torch.int8),
                      torch.zeros((1, 4), dtype=torch.uint8),
                      torch.tensor(1.0), torch.ones(4), 0)
    with pytest.raises(TypeError):
        ternary_matmul(x, torch.zeros((8, 4), dtype=torch.int8),
                       torch.tensor(1.0), torch.ones(4, dtype=torch.float64))
    xb, wb = x.to(torch.bfloat16), torch.zeros((8, 4), dtype=torch.bfloat16)
    w_q = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(TypeError):
        split_precision(xb.float(), x, torch.tensor(1.0), wb, w_q,
                        torch.ones(4), 0)
    with pytest.raises(ValueError):
        split_precision(xb, x, torch.tensor(1.0), wb[:, :3], w_q,
                        torch.ones(4), 0)
    with pytest.raises(ValueError):
        split_precision(xb, x, torch.tensor(1.0), wb, w_q, torch.ones(4), 5)


#: the (K, N) of every decode call on the served paths (yi-9b's layers;
#: ternary_packed's entry-point run takes the same), and N / K off them
SERVED_KN = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096),
             (4096, 64000)]


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n", SERVED_KN + [(11008, 1000), (1000, 1000)])
def test_decode_plan_fills_the_card_and_covers_k(m, k, n):
    """The decode GEMM's plan on an H100's 132 SMs: at least one block per
    SM at every served shape; its blocks' and warps' K slices cover K
    exactly, in order, and a block's slice fits its staged x."""
    from repro_torch.kernels.quant_matmul import (DECODE_CHUNK, DECODE_SPAN,
                                                  DECODE_WARPS,
                                                  decode_k_slices,
                                                  decode_plan)
    sms = 132
    bn, split = decode_plan(m, k, n, sms)
    assert bn in (16, 32, 64, 128) and split in (1, 2, 4, 8)
    assert -(-n // bn) * split >= sms
    slices = decode_k_slices(k, bn, split)
    wpg = DECODE_WARPS // (bn // 16)
    assert len(slices) == split * wpg
    ordered = [slices[(r, w)] for r in range(split) for w in range(wpg)]
    assert ordered[0][0] == 0 and ordered[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ordered, ordered[1:]))
    for r in range(split):
        lo, hi = slices[(r, 0)][0], slices[(r, wpg - 1)][1]
        assert hi - lo <= DECODE_SPAN * DECODE_CHUNK


def test_decode_plan_prefers_wide_tiles_and_few_splits():
    """Two blocks per SM with the widest tile and then the fewest splits;
    where no plan reaches that, the largest grid; M outside 1 .. 16 and K
    past 8 splits of the staged slice are refused."""
    from repro_torch.kernels.quant_matmul import decode_plan
    assert decode_plan(4, 4096, 64000, 132) == (128, 2)
    assert decode_plan(4, 4096, 11008, 132) == (128, 4)
    assert decode_plan(4, 4096, 4096, 132) == (64, 8)
    assert decode_plan(4, 4096, 512, 132) == (16, 8)
    assert decode_plan(4, 64, 64000, 132) == (128, 1)
    with pytest.raises(ValueError):
        decode_plan(17, 4096, 4096, 132)
    with pytest.raises(ValueError):
        decode_plan(4, 32768, 4096, 132)


@pytest.mark.parametrize("m", [3, 20])
@pytest.mark.parametrize("n", [130, 200])
@pytest.mark.parametrize("where", ["zero", "raw7", "all"])
def test_split_precision_kernel_operands_match_jax(m, n, where):
    """The operands the wrapper hands the kernel (x, x_q and w_bf16 with K
    37 padded to 48, the K-major codes, w_bf16 and sw with N padded to 16
    for the wgmma GEMM at M 20, to 4 for the decode GEMM at M 3), through
    the plain version's arithmetic, give the JAX op's output on the first
    N columns: int8 columns bit for bit, bf16 columns within the bound."""
    from repro_torch.kernels import split_precision as sp
    boundary = {"zero": 0, "raw7": 7, "all": n}[where]
    k = 37
    x, x_q, sx, w_b, w_q, sw = _split_operands(m, k, n, 9)
    want = np.asarray(jops.split_precision_op(
        jnp.asarray(x, jnp.bfloat16), x_q, jnp.float32(sx),
        jnp.asarray(w_b, jnp.bfloat16), w_q, sw, boundary, bn=16))
    b_al = min(ops.align_boundary(boundary, ops.block_n(16, n)), n)
    xb, xq, wb, wk, swp = sp.kernel_operands(_bf16(x), _t(x_q), _bf16(w_b),
                                             _t(w_q), _t(sw))
    na = 16 if m > 16 else 4
    n_pad = -(-n // na) * na
    assert tuple(xb.shape) == (m, 48) and tuple(xq.shape) == (m, 48)
    assert tuple(wk.shape) == (n_pad, 48) and tuple(wb.shape) == (48, n_pad)
    assert tuple(swp.shape) == (n_pad,)
    got = sp.split_precision_plain(xb, xq, _t(sx), wb, wk.t(), swp, b_al)
    _assert_split_close(got[:, :n].numpy(), want, x, w_b, b_al)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_ternary_matmul_kernel_operands_match_jax(m, k, n):
    """x_q with K padded to 16 and the K-major codes the kernel reads,
    through the plain version, give the JAX op's output bit for bit."""
    from repro_torch.kernels import ternary_matmul as tm
    x, w_t, _, sx, sw = _operands(m, k, n, 0, 10)
    want = np.asarray(jops.ternary_matmul_op(x, w_t, jnp.float32(sx), sw))
    xq, wk = tm.kernel_operands(_t(x), _t(w_t))
    assert tuple(xq.shape) == (m, -(-k // 16) * 16) and wk.is_contiguous()
    got = tm.ternary_matmul_plain(xq, wk.t(), _t(sx), _t(sw))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n", [(512, 4096, 512), (17, 4096, 512),
                                   (300, 4096, 1008), (12288, 4096, 512),
                                   (100, 256, 208), (512, 1008, 1008)])
def test_split_precision_wgmma_split(m, k, n):
    """split_precision's wgmma GEMM (M > 16) splits K over a cluster of
    at most 4 until its grid holds a block per SM of an H100 (132), never
    leaving a split fewer than 4 stages of 64 K; the served prefill (M 512
    x N 512, 16 tiles) takes 4."""
    from repro_torch.kernels.split_precision import (WGMMA_MIN_STAGES,
                                                     WGMMA_STAGE_K,
                                                     wgmma_split)
    sms = 132
    split = wgmma_split(m, k, n, sms)
    tiles = -(-m // 128) * -(-n // 128)
    stages = -(-k // WGMMA_STAGE_K)
    assert split in (1, 2, 4)
    assert split == 1 or stages >= WGMMA_MIN_STAGES * split
    if split < 4 and stages >= WGMMA_MIN_STAGES * 2 * split:
        assert tiles * split >= sms
    if (m, k, n) == (512, 4096, 512):
        assert split == 4


#: every M > 16 of ternary_matmul on the served paths (prefill 512, the long
#: prefill's 12288) and of chip_smoke.py's checks (17, 100, 300)
TERNARY_WGMMA_M = [17, 100, 300, 512, 12288]


@pytest.mark.parametrize("m", TERNARY_WGMMA_M)
@pytest.mark.parametrize("k,n", SERVED_KN + [(11008, 1000), (1008, 1000)])
def test_ternary_matmul_wgmma_split(m, k, n):
    """ternary_matmul's wgmma GEMM (M > 16, 128 K bytes per stage) on an
    H100's 132 SMs: an allowed split, at least `WGMMA_MIN_STAGES` stages
    per rank, the ranks' K slices (as the kernel computes them) covering K
    exactly in order; the fewest splits whose grid holds a block per SM,
    else the largest; the served prefill (M 512 x N 512, 16 tiles) splits
    4 ways, the fastest in chip_smoke.py's sweep."""
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.kernels.split_precision import (WGMMA_MIN_STAGES,
                                                     WGMMA_SPLITS,
                                                     wgmma_k_slices,
                                                     wgmma_split)
    sms = 132
    split = wgmma_split(m, k, n, sms, tm.WGMMA_STAGE_K)
    assert split in WGMMA_SPLITS
    stages = -(-k // tm.WGMMA_STAGE_K)
    slices = wgmma_k_slices(k, split, tm.WGMMA_STAGE_K)
    assert len(slices) == split
    assert slices[0][0] == 0 and slices[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    per_rank = [-(-hi // tm.WGMMA_STAGE_K) - lo // tm.WGMMA_STAGE_K
                for lo, hi in slices]
    assert sum(per_rank) == stages
    assert split == 1 or min(per_rank) >= WGMMA_MIN_STAGES
    tiles = -(-m // 128) * -(-n // 128)
    if split < max(WGMMA_SPLITS):
        bigger = [s for s in WGMMA_SPLITS if s > split]
        assert tiles * split >= sms or \
            stages < WGMMA_MIN_STAGES * bigger[0]
    if (m, k, n) == (512, 4096, 512):
        assert tiles * split >= sms or split == max(WGMMA_SPLITS)
        assert split == 4


@pytest.mark.parametrize("m", [1, 4, 16, 17, 512])
@pytest.mark.parametrize("k,n", [(4096, 512), (4096, 64000), (1008, 1000)])
def test_launch_args_keep_the_decode_plan(monkeypatch, m, k, n):
    """ternary_matmul's launch arguments at M <= 16 are the decode GEMM's
    plan (`decode_args`), above it ``(0, wgmma_split)``; quant_matmul's
    above 16 rows stay ``(0, 0)`` (no K split)."""
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.kernels.split_precision import wgmma_split
    monkeypatch.setattr(qm, "_sm_count", lambda index: 132)
    dev = torch.device("cuda", 0)
    args = tm.launch_args(m, k, n, dev)
    if m <= qm.DECODE_M:
        assert args == qm.decode_args(m, k, n, dev) == \
            qm.decode_plan(m, k, n, 132)
    else:
        assert qm.decode_args(m, k, n, dev) == (0, 0)
        assert args == (0, wgmma_split(m, k, n, 132, tm.WGMMA_STAGE_K))
