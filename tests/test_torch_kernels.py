"""Plain versions of the port's kernels against the JAX package's ops
(Pallas in interpret mode on the CPU) and oracles, bit for bit, plus the
2-bit packing layout.  Inputs are made with numpy from a seed and handed
to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ternary_packed as jpacked  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.kernels.split_ternary import split_ternary  # noqa: E402
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
