"""The flash kernel's plain version with a sliding window and at head dim
120 (h2o-danube-3-4b) against the JAX package on the CPU: against JAX's
``chunked_attention(window=)`` (the function the kernel ports on the card;
the Pallas kernel has no window), and without a window against JAX's
``flash_attention_op`` in interpret mode at D 120.  With a value head dim
of its own (deepseek's MLA: query / key 192, value 128), the plain version
and the oracle against JAX's ``chunked_attention``, which takes ``vd !=
hd``.

Tolerances as in ``test_torch_attention.py``: float32 within atol 1e-5
(the frameworks sum in other orders), and the JAX algorithm's bf16 copy
(`chunked_attention_plain`) within one bf16 step of the output's largest
magnitude.  The plain version rounds ``p`` against the row max where JAX's
chunks round it against a running max, so in bf16 the two are different
valid roundings: it is held to JAX in float32 only."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS, flash_attention, flash_attention_plain)
from repro_torch.models import attention as A  # noqa: E402

#: (B, H, KVH, S): G 2; S past the largest window below
B, H, KVH, S = 1, 4, 2, 1280
CHUNK = 256


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model_layout(D, seed, dtype="float32", sq=S, sk=S):
    """q (B, Sq, KVH, G, D), k / v (B, Sk, KVH, D) as (torch, jax)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, sq, KVH, H // KVH, D),
                                  dtype=np.float32) * 2,
              rng.standard_normal((B, sk, KVH, D), dtype=np.float32),
              rng.standard_normal((B, sk, KVH, D), dtype=np.float32)]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return [(torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt))
            for a in arrays]


def _bhsd(t):
    """A model-layout q / k / v as the kernel's (B, H, S, D)."""
    if t.dim() == 5:
        b, s, kvh, g, d = t.shape
        return t.reshape(b, s, kvh * g, d).transpose(1, 2)
    return t.transpose(1, 2)


def _jax_chunked(jq, jk, jv, window, kv_len=None):
    return np.asarray(JA.chunked_attention(
        jq, jk, jv, causal=True, window=window, q_chunk=CHUNK,
        k_chunk=CHUNK, kv_len=kv_len), np.float32)


@pytest.mark.parametrize("D", [16, 120])
@pytest.mark.parametrize("window", [16, 1000, None])
def test_flash_plain_with_window_matches_jax_chunked(D, window):
    (tq, jq), (tk, jk), (tv, jv) = _model_layout(D, D + (window or 0))
    want = _jax_chunked(jq, jk, jv, window)
    got = flash_attention_plain(_bhsd(tq), _bhsd(tk), _bhsd(tv),
                                causal=True, window=window)
    got = got.transpose(1, 2).reshape(want.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the model-layout wrapper and the op on the CPU are the same numbers
    assert torch.equal(A.attention_plain(tq, tk, tv, causal=True,
                                         kv_len=None, window=window),
                       got)
    assert torch.equal(flash_attention(_bhsd(tq), _bhsd(tk), _bhsd(tv),
                                       window=window),
                       flash_attention_plain(_bhsd(tq), _bhsd(tk),
                                             _bhsd(tv), window=window))


@pytest.mark.parametrize("D", [16, 120])
@pytest.mark.parametrize("window", [16, 1000, None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_plain_with_window_matches_jax(D, window, dtype):
    (tq, jq), (tk, jk), (tv, jv) = _model_layout(D, 7 * D + (window or 0),
                                                 dtype)
    want = _jax_chunked(jq, jk, jv, window)
    got = A.chunked_attention(tq, tk, tv, causal=True, window=window,
                              q_chunk=CHUNK, k_chunk=CHUNK)
    assert got.dtype == tq.dtype
    atol = 1e-5 if dtype == "float32" else \
        2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("window", [100, 1000])
def test_flash_plain_window_and_kv_len_match_jax(window):
    """A 1024-query prefill in a 1280-slot cache (``kv_len`` 1024), as the
    chunked prefill calls it, at D 120."""
    (tq, jq), (tk, jk), (tv, jv) = _model_layout(120, window, sq=1024)
    want = _jax_chunked(jq, jk, jv, window, kv_len=1024)
    got = flash_attention_plain(_bhsd(tq), _bhsd(tk), _bhsd(tv), causal=True,
                                kv_len=1024, window=window)
    np.testing.assert_allclose(got.transpose(1, 2).reshape(want.shape),
                               want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_op_at_head_dim_120_matches_jax_interpret(causal):
    """B 1, H 4, KVH 2, S 256, bq = bk = 128: the Pallas kernel in
    interpret mode at h2o-danube's head dim."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((1, 4, 256, 120), dtype=np.float32)
    k = rng.standard_normal((1, 2, 256, 120), dtype=np.float32)
    v = rng.standard_normal((1, 2, 256, 120), dtype=np.float32)
    want = jops.flash_attention_op(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal, bq=128,
                                   bk=128, interpret=True)
    got = ops.flash_attention_op(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal, bq=128,
                                 bk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_window_of_one_is_the_diagonal_and_ref_agrees():
    """Window 1 leaves each row its own key: the output is v at the row;
    the oracle masks the window alike."""
    (tq, _), (tk, _), (tv, _) = _model_layout(16, 3, sq=64, sk=64)
    q, k, v = _bhsd(tq), _bhsd(tk), _bhsd(tv)
    got = flash_attention_plain(q, k, v, window=1)
    want = v.repeat_interleave(H // KVH, dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        ref.flash_attention_ref(q, k, v, window=1).numpy(), want.numpy(),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("fn", ["plain", "ref"])
def test_a_row_with_no_key_left_is_zero(fn, causal):
    """kv_len below a row's window: no key is left, and the plain version
    and the oracle store 0 there, as the kernel does (never NaN, never the
    mean of v); the other rows agree between the two."""
    (tq, _), (tk, _), (tv, _) = _model_layout(16, 5, sq=64, sk=64)
    q, k, v = _bhsd(tq), _bhsd(tk), _bhsd(tv)
    f = flash_attention_plain if fn == "plain" else ref.flash_attention_ref
    got = f(q, k, v, causal=causal, kv_len=8, window=16)
    other = flash_attention_plain(q, k, v, causal=causal, kv_len=8,
                                  window=16)
    np.testing.assert_allclose(got.numpy(), other.numpy(), rtol=0, atol=1e-6)
    assert bool(torch.isfinite(got).all())
    assert bool((got[:, :, 23:] == 0).all())
    assert bool((got[:, :, :23].abs().sum(-1) > 0).all())


@pytest.mark.parametrize("window", [0, -3, "tensor"])
def test_flash_rejects_a_bad_window(window):
    (tq, _), (tk, _), (tv, _) = _model_layout(16, 1, sq=8, sk=8)
    if window == "tensor":
        window = torch.tensor([4])
    with pytest.raises(ValueError, match="window"):
        flash_attention(_bhsd(tq), _bhsd(tk), _bhsd(tv), window=window)


#: (D, Dv): a reduced pair and deepseek-v2-lite's MLA (128 nope + 64 rope,
#: value 128)
VALUE_DIM_PAIRS = [(24, 16), (192, 128)]


@pytest.mark.parametrize("kv_len", [None, 512])
@pytest.mark.parametrize("D,Dv", VALUE_DIM_PAIRS)
def test_flash_plain_and_ref_at_a_value_dim_of_its_own_match_jax(D, Dv,
                                                                 kv_len):
    """q, k at D and v at Dv, G 1 as MLA calls it, causal; with ``kv_len``
    a 512-query prefill in a 768-key cache.  The plain version (what the
    card's kernel is held to) and the oracle against JAX's
    ``chunked_attention`` within atol 1e-5 (float32); the output is
    (B, H, Sq, Dv) and the op on the CPU is the plain version."""
    heads, sq = 4, 512
    sk = sq if kv_len is None else 768
    rng = np.random.default_rng(D + Dv + (kv_len or 0))
    qa = rng.standard_normal((1, sq, heads, 1, D), dtype=np.float32) * 2
    ka = rng.standard_normal((1, sk, heads, D), dtype=np.float32)
    va = rng.standard_normal((1, sk, heads, Dv), dtype=np.float32)
    want = np.asarray(JA.chunked_attention(
        jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va), causal=True,
        q_chunk=CHUNK, k_chunk=CHUNK, kv_len=kv_len), np.float32)
    assert want.shape == (1, sq, heads, 1, Dv)
    q, k, v = (_bhsd(torch.from_numpy(a)) for a in (qa, ka, va))
    for f in (flash_attention_plain, ref.flash_attention_ref):
        got = f(q, k, v, causal=True, kv_len=kv_len)
        assert tuple(got.shape) == (1, heads, sq, Dv)
        np.testing.assert_allclose(got.transpose(1, 2).reshape(want.shape),
                                   want, rtol=0, atol=1e-5)
    assert torch.equal(flash_attention(q, k, v, kv_len=kv_len),
                       flash_attention_plain(q, k, v, kv_len=kv_len))


def test_head_dims_take_h2o_danube():
    assert 120 in HEAD_DIMS and 48 not in HEAD_DIMS


def test_the_build_instantiates_the_shapes_of_the_list(tmp_path):
    """The source's dispatch list is written from `SHAPES` (the one list
    of instantiated (D, Dv, windowed)) into a header the build includes;
    192 / 128 is instantiated without the window."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import SHAPES
    assert (192, 128, False) in SHAPES and (128, 128, True) in SHAPES
    flags = _build.include_flags("flash_attention", tmp_path / "f.h")
    assert flags == ["-include", str(tmp_path / "f.h")]
    want = " ".join(f"X({d}, {dv}, {str(w).lower()})" for d, dv, w in SHAPES)
    assert (tmp_path / "f.h").read_text() == \
        f"#define FLASH_SHAPES {want}\n"
    assert _build.include_flags("quant_matmul", tmp_path / "q.h") == []
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert "FLASH_SHAPES" in src and "D == 192" not in src
