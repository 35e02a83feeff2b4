"""The port's CUDA kernels against their plain PyTorch versions on the
card, bit for bit (marker ``gpu``).  Each test decides inside its fixture
whether a card is present and skips here otherwise; run them on a machine
with an H100 with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.quant_matmul import (quant_matmul,  # noqa: E402
                                              quant_matmul_plain)
from repro_torch.kernels.split_ternary import (split_ternary,  # noqa: E402
                                               split_ternary_plain)
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
