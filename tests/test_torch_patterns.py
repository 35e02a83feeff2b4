"""Block patterns that no shipped config uses, against the JAX package on
the CPU: each block kind is built and run on its own in both packages, so
a reduced float32 yi-9b given the pattern ``("mamba", "attn")`` or
``("mlstm", "slstm")`` prefills and decodes with JAX's logits within
1e-4 (on JAX's params, both caches held in float32: a bfloat16 KV
cache rounds a k that the two packages sum in another order to the other
side of a bfloat16 step, 5.8e-4 on the logits of ``("mamba", "attn")``'s
prefill, and JAX's spec gives the conv carries the KV dtype), and only
what the JAX package refuses is refused."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _load():
    jbase.load_all()
    cfgbase.load_all()


def _configs(pattern):
    over = dict(param_dtype="float32", pattern=pattern,
                n_layers=2 * len(pattern))
    jcfg = dataclasses.replace(jbase.reduce_for_smoke(jbase.get("yi-9b")),
                               **over)
    cfg = dataclasses.replace(
        cfgbase.reduce_for_smoke(cfgbase.get("yi-9b")), **over)
    return jcfg, cfg


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float32),
                               np.asarray(b, dtype=np.float32), atol=TOL,
                               rtol=0)


def _jax_cache(jcfg, B, S_max):
    return jax.tree.map(lambda leaf: leaf.astype(jnp.float32)
                        if leaf.dtype == jnp.bfloat16 else leaf,
                        JT.init_cache(jcfg, B, S_max))


@pytest.fixture()
def float32_caches(monkeypatch):
    spec = T._block_cache_spec
    monkeypatch.setattr(T, "_block_cache_spec", lambda *a: {
        key: (shape, torch.float32 if dt == torch.bfloat16 else dt)
        for key, (shape, dt) in spec(*a).items()})


@pytest.mark.parametrize("pattern", [("mamba", "attn"), ("mlstm", "slstm")])
def test_unused_pattern_prefills_and_decodes_as_jax(float32_caches,
                                                    pattern):
    jcfg, cfg = _configs(pattern)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    B, S, S_max = 2, 8, 16
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    with torch.no_grad():
        lg, caches = T.prefill(params, cfg, torch.from_numpy(tokens),
                               T.init_cache(cfg, B, S_max, "cpu"))
    jlg, jcaches = JT.prefill(jparams, jcfg, jnp.asarray(tokens),
                              _jax_cache(jcfg, B, S_max))
    _close(lg.numpy(), jlg)
    tok = np.argmax(np.asarray(jlg), -1)
    for i in range(3):
        with torch.no_grad():
            lg, caches = T.decode_step(params, cfg, torch.from_numpy(tok),
                                       caches, S + i)
        jlg, jcaches = JT.decode_step(jparams, jcfg, jnp.asarray(tok),
                                      jcaches, jnp.int32(S + i))
        _close(lg.numpy(), jlg)
        tok = np.argmax(np.asarray(jlg), -1)


def test_only_what_jax_refuses_is_refused():
    jcfg, cfg = _configs(("attn", "ffn"))
    with pytest.raises(ValueError):
        JT.init_lm(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError, match="unknown block kind"):
        T.init_lm(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(0)
    for pattern in (("mamba", "attn"), ("mlstm", "slstm"),
                    ("attn", "cross"), ("mamba",) * 2 + ("mlstm",)):
        T.init_lm(gen, _configs(pattern)[1])
