"""The port's attention for long prompts against the JAX package on the
CPU: ``chunked_attention`` against ``repro.models.attention``, the flash
kernel's oracle and op against ``repro.kernels`` (the Pallas kernel in
interpret mode), and the long prefill (Sq > 2048, which takes the chunked
path) of reduced yi-9b, fp and planned on diana.

Tolerances: float32 attention within atol 1e-5 (the two frameworks sum in
other orders; softmax outputs are below 4 here, so that is about 30
float32 steps).  bfloat16 attention within one bf16 step of the output's
largest magnitude: both round the chunk scores and PV to bf16 at the same
places, so a difference of one rounding is all that may remain.

Long prefill logits planned on diana within atol 1e-4, the bar of
``test_torch_model.py``: the planned projections are integer-exact in both
packages, so k and v enter the cache bit for bit alike and only the
attention and the float arithmetic around it differ.  With float32
projections (fp) they do not: the two frameworks' float32 matmuls differ
in the last bits, and rounding k and v into the int8 or bf16 cache turns
that into a whole code step now and then, more often the longer the
prompt.  That happens before attention and on the unchunked path as well:
at Sq 2048 (full attention) the fp logits already differ from JAX's by
1.7e-4 with the int8 cache and 7.6e-4 with the bf16 one, and at Sq 512 by
3.3e-5 and 1e-6 (measured on the CPU).  The fp case is held to atol 5e-4
(int8) and 2.5e-3 (bf16), twice what Sq 2560 shows.  On the logits' scale:
the reduced float32 yi-9b's prefill logits at Sq 2560 have max |logit|
3.75 (fp, int8 KV) and 3.70 (fp, bf16 KV), RMS 1.03, and 2.59 planned on
diana (RMS 1.1), so the fp bars are 1.3e-4 and 6.8e-4 of the largest
logit and the planned one 3.9e-5."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.configs import base as jcfgbase  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.managed import matmul_backend  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import _backend  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(a, dtype):
    """numpy float32 ``a`` as (torch, jax) arrays of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _qkv(B, Sq, Sk, KVH, G, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, KVH, G, hd), dtype=np.float32)
    k = rng.standard_normal((B, Sk, KVH, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KVH, hd), dtype=np.float32)
    return [_both(a, dtype) for a in (q, k, v)]


def _bf16_step(x):
    """One bf16 step at the largest magnitude of ``x``."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(x).max()))) - 7)


def _assert_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    atol = 1e-5 if dtype == "float32" else _bf16_step(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("case", ["causal", "kv_len", "window",
                                  "non_causal"])
def test_chunked_attention_matches_jax(dtype, G, case):
    kw = {"causal": case != "non_causal", "q_chunk": 32, "k_chunk": 32}
    if case == "kv_len":
        kw["kv_len"] = 75
    if case == "window":
        kw["window"] = 24
    (tq, jq), (tk, jk), (tv, jv) = _qkv(2, 64, 96, 2, G, 16, dtype, G)
    want = JA.chunked_attention(jq, jk, jv, **kw)
    got = A.chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and tuple(got.shape) == tuple(want.shape)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("Sq,Sk,kw", [
    (48, 64, {"q_chunk": 32}),      # 48 % 32
    (64, 80, {"k_chunk": 32}),      # 80 % 32
    (600, 1024, {}),                # 600 % 512
    (512, 1500, {}),                # 1500 % 1024
])
def test_chunked_attention_rejects_what_jax_asserts(Sq, Sk, kw):
    (tq, jq), (tk, jk), (tv, jv) = _qkv(1, Sq, Sk, 1, 1, 16, "float32")
    with pytest.raises(AssertionError):
        JA.chunked_attention(jq, jk, jv, **kw)
    with pytest.raises(ValueError, match="multiple"):
        A.chunked_attention(tq, tk, tv, **kw)


def test_attention_plain_is_the_flash_plain_version_on_the_model_layout():
    (tq, _), (tk, _), (tv, _) = _qkv(2, 40, 56, 2, 4, 16, "bfloat16", 3)
    got = A.attention_plain(tq, tk, tv, causal=True, kv_len=50)
    want = flash_attention_plain(tq.reshape(2, 40, 8, 16).transpose(1, 2),
                                 tk.transpose(1, 2), tv.transpose(1, 2),
                                 causal=True, kv_len=50)
    assert torch.equal(got, want.transpose(1, 2).reshape(2, 40, 2, 4, 16))


def _bhsd(B, H, KVH, Sq, Sk, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, KVH, Sk, D), dtype=np.float32)
    v = rng.standard_normal((B, KVH, Sk, D), dtype=np.float32)
    return [_both(a, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_and_op_match_jax(causal):
    """B 1, H 4, KVH 2, S 256, D 64, bq = bk = 128 as tests/test_kernels.py
    runs the Pallas kernel: the port's oracle against JAX's, and the op
    (the plain version on the CPU) against JAX's op in interpret mode."""
    (tq, jq), (tk, jk), (tv, jv) = _bhsd(1, 4, 2, 256, 256, 64, "float32")
    np.testing.assert_allclose(
        ref.flash_attention_ref(tq, tk, tv, causal=causal).numpy(),
        np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal)),
        rtol=0, atol=1e-5)
    want = jops.flash_attention_op(jq, jk, jv, causal=causal, bq=128, bk=128,
                                   interpret=True)
    got = ops.flash_attention_op(tq, tk, tv, causal=causal, bq=128, bk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_flash_op_bf16_matches_jax_interpret():
    """bf16 operands: the plain version rounds p to bf16 before PV as the
    Pallas kernel does; one bf16 step of the output's magnitude."""
    (tq, jq), (tk, jk), (tv, jv) = _bhsd(1, 4, 2, 256, 256, 64, "bfloat16", 5)
    want = jops.flash_attention_op(jq, jk, jv, causal=True, bq=128, bk=128,
                                   interpret=True)
    got = ops.flash_attention_op(tq, tk, tv, causal=True, bq=128, bk=128)
    _assert_close(got, want, "bfloat16")


@pytest.mark.parametrize("Sq,Sk", [(200, 200), (136, 200)])
def test_flash_op_masks_padded_keys_when_not_causal(Sq, Sk):
    """bk = 128 pads Sk = 200 to 256 zero keys; non-causal, the JAX op lets
    them take probability mass, the port's op masks them (kv_len = Sk)."""
    (tq, jq), (tk, jk), (tv, jv) = _bhsd(1, 4, 2, Sq, Sk, 64, "float32", 7)
    want = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=False))
    got = ops.flash_attention_op(tq, tk, tv, causal=False, bq=128, bk=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    jax_op = np.asarray(jops.flash_attention_op(
        jq, jk, jv, causal=False, bq=128, bk=128, interpret=True))
    assert np.abs(jax_op - want).max() > 1e-2


def test_flash_kv_len_masks_keys_like_a_shorter_cache():
    (tq, _), (tk, _), (tv, _) = _bhsd(2, 8, 2, 40, 96, 16, "float32", 9)
    for causal in (True, False):
        got = flash_attention(tq, tk, tv, causal=causal, kv_len=60)
        want = flash_attention_plain(tq, tk[:, :, :60], tv[:, :, :60],
                                     causal=causal)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(
            got.numpy(), ref.flash_attention_ref(
                tq, tk[:, :, :60], tv[:, :, :60], causal=causal).numpy(),
            rtol=0, atol=1e-5)


@pytest.mark.parametrize("bad", ["kv_len0", "kv_len_tensor", "heads",
                                 "no_keys"])
def test_flash_rejects_bad_arguments(bad):
    (tq, _), (tk, _), (tv, _) = _bhsd(1, 4, 2, 8, 8, 16, "float32")
    kw = {}
    if bad == "kv_len0":
        kw["kv_len"] = 0
    if bad == "kv_len_tensor":
        kw["kv_len"] = torch.tensor([4])
    if bad == "heads":
        tq = tq[:, :3]
    if bad == "no_keys":
        tk, tv = tk[:, :, :0], tv[:, :, :0]
    with pytest.raises(ValueError):
        flash_attention(tq, tk, tv, **kw)


# ------------------------------------------------------------- long prefill
PROMPT, CACHE = 2560, 3072


def _reduced(kv):
    jcfgbase.load_all()
    over = dict(param_dtype="float32", kv_cache_dtype=kv)
    jcfg = dataclasses.replace(
        jcfgbase.reduce_for_smoke(jcfgbase.get("yi-9b")), **over)
    cfg = dataclasses.replace(
        cfgbase.reduce_for_smoke(cfgbase.get("yi-9b")), **over)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, T.params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
@pytest.mark.parametrize("planned", [False, True])
def test_long_prefill_takes_the_chunked_path_and_matches_jax(
        kv, planned, monkeypatch, tmp_path):
    jcfg, cfg, jparams, params = _reduced(kv)
    jbackend = backend = None
    if planned:
        art = j_emit(jparams, jcfg, "diana", tmp_path / "m.json",
                     max_cout=64, act_log_scale=2.0)
        jbackend = jrt.PlannedBackend(jrt.lower(art, params=jparams),
                                      jparams, reference=True)
        plan = rt.lower(art.to_dict(), params=params)
        assert plan.kernel_histogram() == {"quant_matmul": 5,
                                           "split_ternary": 10}
        backend = rt.PlannedBackend(plan, params)
    calls = {"chunked": 0, "full": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped
    monkeypatch.setattr(A, "chunked_attention",
                        counting("chunked", A.chunked_attention))
    monkeypatch.setattr(A, "full_attention",
                        counting("full", A.full_attention))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (1, PROMPT),
                                                dtype=np.int32)
    with matmul_backend(jbackend), _backend.use(backend):
        jl, _ = JT.prefill(jparams, jcfg, jnp.asarray(prompts),
                           JT.init_cache(jcfg, 1, CACHE))
        tl, _ = T.prefill(params, cfg, torch.from_numpy(prompts).long(),
                          T.init_cache(cfg, 1, CACHE, device="cpu"))
    assert calls == {"chunked": cfg.n_layers, "full": 0}
    atol = 1e-4 if planned else {"int8": 5e-4, "bfloat16": 2.5e-3}[kv]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=atol)


def test_long_prefill_with_lengths_matches_jax(tmp_path):
    """A right-padded prompt (``lengths=``) takes the chunked path too; the
    logits at its last valid position match JAX's."""
    jcfg, cfg, jparams, params = _reduced("int8")
    art = j_emit(jparams, jcfg, "diana", tmp_path / "m.json", max_cout=64,
                 act_log_scale=2.0)
    jbackend = jrt.PlannedBackend(jrt.lower(art, params=jparams), jparams,
                                  reference=True)
    backend = rt.PlannedBackend(rt.lower(art.to_dict(), params=params),
                                params)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (1, PROMPT),
                                                dtype=np.int32)
    lengths = np.array([2100], np.int32)
    with matmul_backend(jbackend), _backend.use(backend):
        jl, _ = JT.prefill(jparams, jcfg, jnp.asarray(prompts),
                           JT.init_cache(jcfg, 1, CACHE),
                           lengths=jnp.asarray(lengths))
        tl, _ = T.prefill(params, cfg, torch.from_numpy(prompts).long(),
                          T.init_cache(cfg, 1, CACHE, device="cpu"),
                          lengths=torch.from_numpy(lengths).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)


def test_serve_cli_takes_a_long_prompt_of_any_length():
    """A 2100-token prompt (no multiple of 512) streams through the paged
    engine's chunks, which have no chunked-attention contract."""
    tokens, stats = serve.main(["--arch", "yi-9b", "--reduce", "--device",
                                "cpu", "--requests", "1", "--prompt-len",
                                "2100", "--gen-len", "2"])
    assert tuple(tokens.shape) == (1, 2)
    vocab = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b")).vocab
    assert 0 <= int(tokens.min()) and int(tokens.max()) < vocab
    assert stats["prefill_s"] > 0 and stats["tok_per_s"] > 0
