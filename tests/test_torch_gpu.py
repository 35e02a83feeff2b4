"""The port's CUDA kernels against their plain PyTorch versions on the
card (marker ``gpu``): bit for bit for the integer contractions, within
the float32 summation bound ``K * 2**-24 * sum_k |x * w| + 2**-24 * |y|``
for the bf16 columns of split_precision.  Each test decides inside its fixture
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
from repro_torch.kernels.ternary_packed import pack_ternary  # noqa: E402

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


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quant_matmul_kernel_bit_exact(cuda, m, k, n):
    x, w, _, sx, sw = _operands(m, k, n, 0, cuda)
    before = quant_matmul.launches
    got = quant_matmul(x, w, sx, sw)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert torch.equal(got, quant_matmul_plain(x, w, sx, sw))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("where", ["zero", "raw", "aligned", "all"])
def test_split_ternary_kernel_bit_exact(cuda, m, k, n, where):
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
    x4 = torch.nn.functional.pad(x, (0, k4 - k))
    w_q4 = torch.nn.functional.pad(w_q, (0, 0, 0, k4 - k))
    # columns read from the packed stream hold garbage in w_q: the kernel
    # must not read them
    probe = torch.where(cols < boundary, w_q4, 99)
    before = split_ternary.launches
    got = split_ternary(x4, probe, w_p, sx, sw, boundary)
    torch.cuda.synchronize()
    assert split_ternary.launches == before + 1
    want = split_ternary_plain(x4, w_q4, w_p, sx, sw, boundary)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_ternary_matmul_kernel_bit_exact(cuda, m, k, n):
    x, _, t, sx, sw = _operands(m, k, n, 2, cuda)
    before = ternary_matmul.launches
    got = ternary_matmul(x, t, sx, sw)
    torch.cuda.synchronize()
    assert ternary_matmul.launches == before + 1
    assert torch.equal(got, ternary_matmul_plain(x, t, sx, sw))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("where", ["zero", "raw", "aligned16", "all"])
def test_split_precision_kernel(cuda, m, k, n, where):
    """int8 columns bit for bit, bf16 columns within the summation bound;
    the boundary lands inside a 64-column tile for ``aligned16``.  w_q
    holds 99 at and above the boundary and w_bf16 NaN below it (the split
    probe): neither may reach the output."""
    x_q, w_q, _, sx, sw = _operands(m, k, n, 3, cuda)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1.5, (m, k)).astype(np.float32))
    w_b = torch.from_numpy(rng.normal(0, 0.05, (k, n)).astype(np.float32))
    x, w_b = (a.to(cuda).to(torch.bfloat16) for a in (x, w_b))
    raw = min(7, n)
    boundary = {"zero": 0, "raw": raw, "all": n,
                "aligned16": min(ops.align_boundary(raw + 40, 16), n)}[where]
    cols = torch.arange(n, device=cuda)[None, :]
    probe_q = torch.where(cols < boundary, w_q, 99).to(torch.int8)
    probe_b = torch.where(cols >= boundary, w_b,
                          float("nan")).to(torch.bfloat16)
    before = split_precision.launches
    got = split_precision(x, x_q, sx, probe_b, probe_q, sw, boundary)
    torch.cuda.synchronize()
    assert split_precision.launches == before + 1
    want = split_precision_plain(x, x_q, sx, w_b, w_q, sw, boundary)
    assert torch.equal(got[:, :boundary], want[:, :boundary])
    err = (got.double() - want.double()).abs()
    bound = bf16_error_bound(x, w_b, want)
    assert bool((err[:, boundary:] <= bound[:, boundary:]).all())


def test_cuda_wrappers_reject_mixed_devices(cuda):
    x, w, t, sx, sw = _operands(4, 64, 32, 5, cuda)
    with pytest.raises(ValueError):
        ternary_matmul(x, t, sx, sw.cpu())
    with pytest.raises(ValueError):
        split_precision(x.to(torch.bfloat16).cpu(), x, sx,
                        w.to(torch.bfloat16), w, sw, 0)
