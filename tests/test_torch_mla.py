"""The port's multi-head latent attention (`repro_torch.models.attention
.mla`) against the JAX package's ``repro.models.attention.mla`` on the same
numpy inputs: deepseek-v2-lite's reduced MLA (4 heads, latent 32, nope 16,
rope 8, v 16, d_model 64), float32 parameters.

Paths: no cache; prefill into the latent cache then the absorbed decode,
on the dense and the paged cache, with bf16 and int8 latents; the chunked
(flash) prefill; a planned backend, which runs ``kv_b`` at prefill and
whose absorbed decode reads ``kv_b``'s weight itself.

Tolerances: outputs within 1e-5 (float32 with a float32 or int8 cache:
the same operations, the einsums summed in other orders); with the bf16
cache within 1e-4 (a last-bit difference of the two frameworks' float32
projections can round a cached latent to the neighbouring bf16 value).
The int8 caches are equal code for code, the bf16 ones within one bf16
step."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.models import _backend  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

B, S, STEPS = 2, 12, 3


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs():
    cfg = T._mla_cfg(cfgbase.reduce_for_smoke(
        cfgbase.get("deepseek-v2-lite-16b")))
    return JA.MLAConfig(**dataclasses.asdict(cfg)), cfg


def _params(seed=0):
    jcfg, cfg = _cfgs()
    jp = JA.init_mla(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, cfg, jp, T.params_from_jax(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _x(n, s, seed):
    return np.random.default_rng(seed).standard_normal((n, s, 64),
                                                       dtype=np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _cache_equal(got, want):
    if got.dtype == torch.int8:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:   # bf16: within one bf16 step
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   rtol=2.0**-7, atol=1e-30)


def test_init_mla_tree_matches_jax():
    jcfg, cfg = _cfgs()
    jp = JA.init_mla(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    p = A.init_mla(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    assert [k for k, _ in flat] == [k for k, _ in jflat]
    for (path, leaf), (_, jleaf) in zip(flat, jflat):
        assert tuple(leaf.shape) == tuple(jleaf.shape), path


def test_mla_without_cache_matches_jax():
    jcfg, cfg, jp, p = _params()
    x = _x(B, S, 1)
    pos = np.arange(S)[None]
    jo, _ = JA.mla(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
    o, cache = A.mla(p, torch.from_numpy(x), torch.from_numpy(pos), cfg)
    assert cache is None
    _close(o, jo, 1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_mla_prefill_then_absorbed_decode_dense_matches_jax(dtype):
    """A ragged prefill of 12 tokens at index 0, then 3 absorbed decode
    steps at per-slot positions (slot 1 three behind): outputs and the
    latent cache against JAX's."""
    jcfg, cfg, jp, p = _params(1)
    smax = S + STEPS
    jdt, dt = (jnp.int8, torch.int8) if dtype == "int8" else \
        (jnp.bfloat16, torch.bfloat16)
    r = cfg.kv_lora_rank + cfg.qk_rope_dim
    jc = {"latent": jnp.zeros((B, smax, r), jdt)}
    c = {"latent": torch.zeros((B, smax, r), dtype=dt)}
    x = _x(B, S, 2)
    pos = np.arange(S)[None]
    jo, jc = JA.mla(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, cache=jc,
                    cache_index=0)
    o, c = A.mla(p, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                 cache=c, cache_index=0)
    tol = 1e-5 if dtype == "int8" else 1e-4
    _close(o, jo, tol)
    _cache_equal(c["latent"], jc["latent"])
    index = np.array([S, S - 3])
    for i in range(STEPS):
        xd = _x(B, 1, 10 + i)
        pos = (index + i)[:, None]
        jo, jc = JA.mla(jp, jnp.asarray(xd), jnp.asarray(pos), jcfg,
                        cache=jc, cache_index=jnp.asarray(index + i))
        o, c = A.mla(p, torch.from_numpy(xd), torch.from_numpy(pos), cfg,
                     cache=c, cache_index=torch.from_numpy(index + i))
        _close(o, jo, tol)
        _cache_equal(c["latent"], jc["latent"])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_mla_paged_chunk_then_absorbed_decode_matches_jax(dtype):
    """Chunks of 6 with mixed valid counts into shuffled page tables (the
    expanded path over the gathered pages), then absorbed paged decode
    with one slot masked: the live rows' outputs and the pools outside the
    trash page against JAX's."""
    jcfg, cfg, jp, p = _params(2)
    rng = np.random.default_rng(3)
    Bc, C, ps, W, rows = 3, 6, 4, 5, 13
    pages = np.zeros((Bc, W), np.int32)
    perm = rng.permutation(np.arange(1, rows))
    pages[0, :4], pages[1, :2], pages[2, :4] = perm[:4], perm[4:6], \
        perm[6:10]
    jdt, dt = (jnp.int8, torch.int8) if dtype == "int8" else \
        (jnp.bfloat16, torch.bfloat16)
    r = cfg.kv_lora_rank + cfg.qk_rope_dim
    jc = {"latent": jnp.zeros((rows, ps, r), jdt)}
    c = {"latent": torch.zeros((rows, ps, r), dtype=dt)}
    tol = 1e-5 if dtype == "int8" else 1e-4
    steps = [([0, 0, 0], [6, 4, 0]), ([6, 4, 0], [6, 0, 6]),
             ([12, 4, 6], [1, 1, 0]), ([13, 5, 6], [1, 0, 1])]
    for index, live in steps:
        index, live = np.array(index), np.array(live)
        s = C if live.max() > 1 else 1
        x = _x(Bc, s, int(index.sum()))
        pos = index[:, None] + np.arange(s)[None]
        mask = np.arange(s)[None] < live[:, None]
        jo, jc = JA.mla(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, cache=jc,
                        cache_index=jnp.asarray(index),
                        pages=jnp.asarray(pages),
                        write_mask=jnp.asarray(mask))
        o, c = A.mla(p, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                     cache=c, cache_index=torch.from_numpy(index),
                     pages=torch.from_numpy(pages).long(),
                     write_mask=torch.from_numpy(mask))
        for b in np.nonzero(live)[0]:
            _close(o[b, :live[b]], np.asarray(jo)[b, :live[b]], tol)
        _cache_equal(c["latent"][1:], np.asarray(jc["latent"])[1:])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_mla_chunked_prefill_matches_jax(dtype):
    """``chunked=True``: the double-chunked attention over the whole cache
    (Sq 64 in a 128-slot cache, so keys past kv_len are masked), at query
    / key dim 24 and value dim 16 in both packages, against JAX's and
    against the port's own unchunked path (within 1e-5).  Over 64 tokens
    a last-bit difference of the two frameworks' float32 ``kv_a`` rounds
    an int8 latent code the other way now and then (ROADMAP Queue 3): at
    most one code may differ, by one, and then the outputs agree within
    1e-2 (a code is 1/16)."""
    jcfg, cfg, jp, p = _params(3)
    x = _x(1, 64, 4)
    pos = np.arange(64)[None]
    jdt, dt = (jnp.int8, torch.int8) if dtype == "int8" else \
        (jnp.bfloat16, torch.bfloat16)
    r = cfg.kv_lora_rank + cfg.qk_rope_dim
    jo, jc = JA.mla(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                    cache={"latent": jnp.zeros((1, 128, r), jdt)},
                    cache_index=0, chunked=True)
    calls = []

    def counting(q, k, v, **kw):
        calls.append((q.shape[-1], v.shape[-1], kw["kv_len"]))
        return chunked(q, k, v, **kw)
    chunked = A.chunked_attention
    A.chunked_attention = counting
    try:
        o, c = A.mla(p, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                     cache={"latent": torch.zeros((1, 128, r), dtype=dt)},
                     cache_index=0, chunked=True)
    finally:
        A.chunked_attention = chunked
    assert calls == [(24, 16, 64)]
    full, _ = A.mla(p, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                    cache={"latent": torch.zeros((1, 128, r), dtype=dt)},
                    cache_index=0)
    _close(o, full.numpy(), 1e-5)
    if dtype == "int8":
        flips = np.abs(c["latent"].numpy().astype(np.int32)
                       - np.asarray(jc["latent"]).astype(np.int32))
        assert flips.max() <= 1 and flips.sum() <= 1
        _close(o, jo, 1e-5 if flips.sum() == 0 else 1e-2)
    else:
        _close(o, jo, 1e-4)


def test_mla_planned_kv_b_runs_at_prefill_and_not_at_decode():
    """Under a matmul backend ``kv_b`` is a backend call on the expanded
    path only: the absorbed decode folds ``p["kv_b"]["w"]`` itself (as the
    JAX package does), so a decode step calls wq, kv_a and wo."""
    _, cfg, _, p = _params(4)
    names = []

    def recording(name, p_, x, **kw):
        names.append(name.rsplit("/", 1)[-1])
        return None
    r = cfg.kv_lora_rank + cfg.qk_rope_dim
    c = {"latent": torch.zeros((B, S + 1, r), dtype=torch.int8)}
    with _backend.use(recording):
        A.mla(p, torch.from_numpy(_x(B, S, 5)), torch.arange(S)[None], cfg,
              cache=c, cache_index=0, name="units/0/attn")
        assert names == ["wq", "kv_a", "kv_b", "wo"]
        names.clear()
        A.mla(p, torch.from_numpy(_x(B, 1, 6)), torch.full((B, 1), S), cfg,
              cache=c, cache_index=S, name="units/0/attn")
        assert names == ["wq", "kv_a", "wo"]
