"""The plain version of the port's ``ternary_packed_matmul`` against the
JAX package's Pallas kernel in interpret mode and against the port's
``ternary_matmul`` on the unpacked codes, bit for bit (both contract the
integer codes exactly and apply the epilogue ``f32(acc) * sx * sw[n]`` in
that order); and its operand checks.  Inputs are made with numpy from a
seed and handed to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ternary_packed as jpacked  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.quant_matmul import (  # noqa: E402
    quant_matmul_plain)
from repro_torch.kernels.ternary_matmul import (  # noqa: E402
    ternary_matmul_plain)
from repro_torch.kernels.ternary_packed import (  # noqa: E402
    pack_ternary, ternary_packed_matmul, ternary_packed_plain,
    unpack_ternary)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _operands(m, k, n, seed):
    """int8 x (M, K), ternary codes zero-padded to K4 = ceil(K/4) * 4 rows,
    sx, sw."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (m, k), dtype=np.int8)
    k4 = -(-k // 4) * 4
    w_t = np.zeros((k4, n), np.int8)
    w_t[:k] = rng.integers(-1, 2, (k, n), dtype=np.int8)
    sx = np.float32(rng.uniform(0.01, 0.1))
    sw = rng.uniform(1e-3, 0.5, n).astype(np.float32)
    return x, w_t, sx, sw


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("m,k,n,bm,bk", [(8, 64, 128, 8, 64),
                                         (128, 512, 256, 128, 512),
                                         (16, 1024, 128, 8, 256)])
def test_plain_bit_identical_to_jax_interpret(m, k, n, bm, bk):
    x, w_t, sx, sw = _operands(m, k, n, m + k)
    w_p = np.asarray(jpacked.pack_ternary(jnp.asarray(w_t)))
    want = np.asarray(jpacked.ternary_packed_matmul(
        jnp.asarray(x), jnp.asarray(w_p), jnp.float32(sx), jnp.asarray(sw),
        bm=bm, bn=128, bk=bk, interpret=True))
    before = ternary_packed_matmul.launches
    got = ops.ternary_packed_matmul_op(_t(x), _t(w_p), _t(sx), _t(sw))
    assert ternary_packed_matmul.launches == before   # CPU: plain version
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n", [(1, 37, 200), (5, 64, 130), (3, 22, 7),
                                   (17, 4096, 512)])
def test_ragged_shapes_match_ternary_matmul_on_unpacked_codes(m, k, n):
    """K % 4 != 0 (the packed stream has ceil(K/4) rows, the codes past K
    are 0), N not a multiple of 4 or 128, M of one decode row."""
    x, w_t, sx, sw = _operands(m, k, n, 7 * m + n)
    w_p = pack_ternary(_t(w_t))
    got = ops.ternary_packed_matmul_op(_t(x), w_p, _t(sx), _t(sw))
    want = ternary_matmul_plain(_t(x), unpack_ternary(w_p)[:k], _t(sx),
                                _t(sw))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert torch.equal(got, want)
    assert torch.equal(ternary_packed_plain(_t(x), w_p, _t(sx), _t(sw)),
                       want)


@pytest.mark.parametrize("m,k,n", [(3, 37, 130), (20, 37, 130),
                                   (40, 64, 200), (17, 100, 8)])
def test_kernel_operands_match_jax_oracle(m, k, n):
    """The operands the wrapper hands the kernel at N off 16 (x with K
    padded to 16; the stream and sw with N padded to 16 for the wgmma GEMM
    at M > 16, to 4 for the decode one), through the plain version's
    arithmetic, give the JAX oracle's output bit for bit on the first N
    columns; padding the stream counts one copy."""
    from repro_torch.kernels import ternary_packed as tp
    from repro_torch.kernels.quant_matmul import _pad_to
    x, w_t, sx, sw = _operands(m, k, n, 3 * m + k)
    w_p = np.asarray(jpacked.pack_ternary(jnp.asarray(w_t)))
    # the Pallas kernel takes only whole blocks: at these shapes the JAX
    # package's oracle on its own unpacking of the stream is the reference
    want = np.asarray(jref.ternary_matmul_ref(
        jnp.asarray(x), jpacked.unpack_ternary(jnp.asarray(w_p))[:k],
        jnp.float32(sx), jnp.asarray(sw)))
    before = tp.ternary_packed_matmul.padded_copies
    xq, wp, swp = tp.kernel_operands(_t(x), _t(w_p), _t(sw))
    align = 16 if m > 16 else 4
    n_pad = -(-n // align) * align
    assert tp.ternary_packed_matmul.padded_copies == before + (n_pad != n)
    assert tuple(xq.shape) == (m, -(-k // 16) * 16)
    assert tuple(wp.shape) == (w_p.shape[0], n_pad)
    assert tuple(swp.shape) == (n_pad,) and not swp[n:].any()
    w_u = _pad_to(unpack_ternary(wp), 16, 0)     # rows past 4 Kp: zero
    got = quant_matmul_plain(xq, w_u, _t(sx), swp)
    np.testing.assert_array_equal(got[:, :n].numpy(), want)


def test_packed_stream_copies_only_off_alignment():
    from repro_torch.kernels.ternary_packed import packed_stream
    w_p = torch.zeros((4, 32), dtype=torch.uint8)
    assert packed_stream(w_p, 16) == (w_p, False)
    got, copied = packed_stream(w_p[:, :20], 4)       # strided view
    assert copied and got.is_contiguous() and tuple(got.shape) == (4, 20)
    got, copied = packed_stream(w_p[:, :20], 16)      # N 20 -> 32
    assert copied and tuple(got.shape) == (4, 32)


def test_rejects_bad_operands():
    x = torch.zeros((2, 8), dtype=torch.int8)
    w_p = torch.zeros((2, 4), dtype=torch.uint8)
    sx, sw = torch.tensor(1.0), torch.ones(4)
    with pytest.raises(ValueError):      # 3 packed rows for K = 8
        ternary_packed_matmul(x, torch.zeros((3, 4), dtype=torch.uint8),
                              sx, sw)
    with pytest.raises(TypeError):       # int8 codes, not packed bytes
        ternary_packed_matmul(x, w_p.to(torch.int8), sx, sw)
    with pytest.raises(TypeError):
        ternary_packed_matmul(x.float(), w_p, sx, sw)
    with pytest.raises(TypeError):
        ternary_packed_matmul(x, w_p, sx, torch.ones(5))
    with pytest.raises(TypeError):
        ternary_packed_matmul(x, w_p, sx.double(), sw)
