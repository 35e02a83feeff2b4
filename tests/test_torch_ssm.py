"""The port's Mamba2 primitives and the hybrid zamba2 model
(``repro_torch.models.ssm``, ``repro_torch.models.transformer``) against
the JAX package's on the same numpy inputs.

Primitives in float32 within 1e-5 (the two frameworks sum in other
orders): the depthwise causal conv with and without a carry, ragged
lengths (0 included, which keeps the carry bit for bit); the chunked SSD
at S {5, 33, 300} x chunk {4, 16, 256}; `mamba2` at S > 1 and S = 1 with
and without a ``length_mask`` (5e-5 at S 300, past one 256-step chunk,
where the decay subtracts two float32 cumulative sums near -200).  The
port's SSD also equals its own per-step recurrence.

Model on float32 reduced zamba2 (6 + 2 blocks, d_model 64) with the JAX
package's parameters: the parameter tree, `cache_specs`,
`paged_cache_specs`, `cache_kv_axes` and `cache_batch_axes` equal JAX's
leaf for leaf (shapes, and dtypes but the Mamba2 conv carry's, which the
port keeps in the activation dtype); ``prefill`` with and without
``lengths``, decode steps with ``active`` on the dense cache, and a run
of ``prefill_chunk`` calls with mixed valid counts then paged decode steps
match JAX's logits within 1e-4 (the bound of ``test_torch_model.py``), fp
and planned on diana with static activation scales (JAX on its plain
oracles), with the recurrent state alike; `scatter_cache` round trip;
`copy_pages` touches only page leaves."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.configs import base as jcfgbase  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.managed import matmul_backend  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.models import _backend  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=atol, atol=atol)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("carry,lengths", [
    (False, None), (True, None), (False, [7, 3, 0]), (True, [0, 7, 1])])
def test_causal_conv_matches_jax(carry, lengths):
    rng = np.random.default_rng(1)
    B, S_, C, K = 3, 7, 10, 4
    x = rng.standard_normal((B, S_, C), dtype=np.float32)
    w = rng.standard_normal((K, C), dtype=np.float32)
    b = rng.standard_normal(C, dtype=np.float32)
    st = rng.standard_normal((B, K - 1, C), dtype=np.float32) \
        if carry else None
    ln = None if lengths is None else np.asarray(lengths)
    jo, jst = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if st is None else jnp.asarray(st),
                              lengths=None if ln is None else jnp.asarray(ln))
    to, tst = S._causal_conv(_t(x), _t(w), _t(b),
                             None if st is None else _t(st),
                             lengths=None if ln is None else _t(ln))
    _close(to, jo, 1e-5)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    if ln is not None and carry:
        for row in np.nonzero(ln == 0)[0]:       # kept bit for bit
            np.testing.assert_array_equal(tst[row].numpy(), st[row])


def _ssd_inputs(seed, B, S_, H, P, N):
    """x, B and C at the magnitude of the model's (silu of a conv whose
    taps are 0.2-scaled: ~0.25), dt a softplus, A = -exp(0.3 N(0, 1))."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    xs, Bt, Ct = (0.25 * f(B, S_, H, P), 0.25 * f(B, S_, N),
                  0.25 * f(B, S_, N))
    dt = np.log1p(np.exp(f(B, S_, H))).astype(np.float32)
    A = -np.exp(0.3 * f(H)).astype(np.float32)
    h0 = f(B, H, P, N)
    return xs, Bt, Ct, dt, (dt * A).astype(np.float32), h0


@pytest.mark.parametrize("S_", [5, 33, 300])
@pytest.mark.parametrize("chunk", [4, 16, 256])
def test_ssd_chunked_matches_jax(S_, chunk):
    ins = _ssd_inputs(S_ + chunk, 2, S_, 3, 8, 5)
    jh, jy = JS._ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    th, ty = S._ssd_chunked(*map(_t, ins), chunk=chunk)
    _close(th, jh, 1e-5)
    _close(ty, jy, 1e-5)


def _recurrence(xs, Bt, Ct, dt, la, h0):
    """The per-step recurrence (``tests/test_ssm.py``'s reference)."""
    h, ys = h0, []
    for i in range(xs.shape[1]):
        dBx = torch.einsum("bhp,bn,bh->bhpn", xs[:, i], Bt[:, i], dt[:, i])
        h = h * torch.exp(la[:, i])[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", h, Ct[:, i]))
    return h, torch.stack(ys, 1)


@pytest.mark.parametrize("S_,chunk", [(5, 4), (33, 16), (64, 8)])
def test_ssd_chunked_equals_its_recurrence(S_, chunk):
    ins = [_t(a) for a in _ssd_inputs(7 * S_, 2, S_, 3, 8, 5)]
    h, y = S._ssd_chunked(*ins, chunk=chunk)
    hr, yr = _recurrence(*ins)
    torch.testing.assert_close(y, yr, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(h, hr, rtol=3e-4, atol=3e-4)


def _mamba_params(seed, d_model=64):
    """JAX-initialised Mamba2 params (float32) with A_log, D and dt_bias
    drawn away from their constant inits, and the port's copy."""
    mcfg = JS.Mamba2Config(d_model=d_model)
    jp = JS.init_mamba2(jax.random.PRNGKey(seed), mcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    H = mcfg.n_heads
    jp = dict(jp, A_log=jnp.asarray(rng.normal(0, 0.1, H), jnp.float32),
              D=jnp.asarray(rng.normal(1, 0.3, H), jnp.float32),
              dt_bias=jnp.asarray(rng.normal(0, 0.1, H), jnp.float32),
              conv_b=jnp.asarray(rng.normal(0, 0.1, mcfg.conv_dim),
                                 jnp.float32))
    return mcfg, jp, T.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("S_,masked,state", [
    (37, False, False), (37, True, True), (300, True, False),
    (1, False, True), (1, True, True)])
def test_mamba2_matches_jax(S_, masked, state):
    """The SSD path (S > 1) and the per-step recurrence (S = 1); masked
    rows (length 0 included) keep their state bit for bit."""
    mcfg, jp, tp = _mamba_params(S_ + masked)
    rng = np.random.default_rng(S_)
    B = 3
    x = rng.standard_normal((B, S_, mcfg.d_model), dtype=np.float32)
    st = None
    if state:
        st = {"ssm": rng.standard_normal(
                  (B, mcfg.n_heads, mcfg.head_dim, mcfg.d_state),
                  dtype=np.float32),
              "conv": rng.standard_normal(
                  (B, mcfg.conv_kernel - 1, mcfg.conv_dim),
                  dtype=np.float32)}
    mask = None
    if masked:
        lens = np.array([S_, max(S_ // 2, 1), 0])
        mask = np.arange(S_)[None, :] < lens[:, None]
    jy, jst = JS.mamba2(jp, jnp.asarray(x), mcfg,
                        state=None if st is None else
                        jax.tree.map(jnp.asarray, st),
                        length_mask=None if mask is None else
                        jnp.asarray(mask))
    ty, tst = S.mamba2(tp, _t(x), mcfg,
                       state=None if st is None else
                       {k: _t(v) for k, v in st.items()},
                       length_mask=None if mask is None else _t(mask))
    live = np.ones((B, S_), bool) if mask is None else mask
    # past one SSD chunk (256 steps) the decay exp(ca_t - ca_s) subtracts
    # cumulative sums near -200, each rounded to ~1e-5 in float32
    tol = 1e-5 if S_ <= S.SSD_CHUNK else 5e-5
    _close(ty[torch.from_numpy(live)], np.asarray(jy)[live], tol)
    for key in ("ssm", "conv"):
        _close(tst[key], jst[key], tol)
    if masked and state:
        for key in ("ssm", "conv"):
            np.testing.assert_array_equal(tst[key][2].numpy(), st[key][2])


# --------------------------------------------------------------------------
# model: reduced zamba2, float32
# --------------------------------------------------------------------------

_MODELS = {}


def zamba(planned, tmp_path_factory):
    """(jcfg, cfg, jparams, params, jbackend, backend): fp, or planned on
    diana with static activation scales; both on the int8 KV cache, as
    ``test_torch_model.py`` holds fp parity: with a bf16 cache the two
    frameworks' float32 last bits now and then round a k or v to
    neighbouring bf16 values (ROADMAP Queue 3), which moves the logits of
    this 8-block model by up to ~2e-3."""
    if planned in _MODELS:
        return _MODELS[planned]
    jcfgbase.load_all()
    over = dict(param_dtype="float32", kv_cache_dtype="int8")
    jcfg = dataclasses.replace(
        jcfgbase.reduce_for_smoke(jcfgbase.get("zamba2-1.2b")), **over)
    cfg = dataclasses.replace(
        cfgbase.reduce_for_smoke(cfgbase.get("zamba2-1.2b")), **over)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jbackend = backend = None
    if planned:
        path = tmp_path_factory.mktemp("zamba") / "m.json"
        art = j_emit(jparams, jcfg, "diana", path, act_log_scale=2.0)
        jbackend = jrt.PlannedBackend(jrt.lower(art, params=jparams),
                                      jparams, reference=True)
        backend = rt.PlannedBackend(rt.lower(art.to_dict(), params=params),
                                    params)
        assert not backend.unbound
    _MODELS[planned] = (jcfg, cfg, jparams, params, jbackend, backend)
    return _MODELS[planned]


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "diana"])
def model(request, tmp_path_factory):
    return zamba(request.param, tmp_path_factory)


def _paths(tree, prefix=""):
    """``{path: leaf}`` of a dict / tuple / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _jpaths(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tdtype(jdtype):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}[str(jdtype)]


def test_params_and_cache_trees_match_jax(tmp_path_factory):
    """init_lm's tree and shapes, params_from_jax (tuples and lists kept),
    and every cache tree's paths, shapes and dtypes (the conv carry in the
    activation dtype), markers and batch axes."""
    jcfg, cfg, jparams, params, _, _ = zamba(True, tmp_path_factory)
    assert isinstance(params["units"], tuple) and \
        isinstance(params["rem"], list) and len(params["rem"]) == 2
    mine = _paths(T.init_lm(torch.Generator().manual_seed(0), cfg))
    conv = _paths(params)
    want = _jpaths(jparams)
    assert sorted(mine) == sorted(conv) == sorted(want)
    for k, leaf in want.items():
        assert tuple(mine[k].shape) == tuple(leaf.shape), k
        assert conv[k].dtype == mine[k].dtype == _tdtype(leaf.dtype), k
        np.testing.assert_array_equal(conv[k].numpy(), np.asarray(leaf))
    for got, exp in ((T.cache_specs(cfg, 3, 24),
                      JT.cache_specs(jcfg, 3, 24)),
                     (T.paged_cache_specs(cfg, 3, 9, 4),
                      JT.paged_cache_specs(jcfg, 3, 9, 4))):
        got, exp = _paths(got), _jpaths(exp)
        assert sorted(got) == sorted(exp)
        for k, leaf in exp.items():
            assert tuple(got[k].shape) == tuple(leaf.shape), k
            want_dt = (torch.float32 if k.endswith("conv")
                       else _tdtype(leaf.dtype))
            assert got[k].dtype == want_dt, k
    assert _paths(T.cache_kv_axes(cfg)) == _jpaths(JT.cache_kv_axes(jcfg))
    caches = T.init_cache(cfg, 2, 8, device="cpu")
    assert _paths(T.cache_batch_axes(caches)) == _jpaths(
        JT.cache_batch_axes(JT.init_cache(jcfg, 2, 8)))


def test_pattern_repeats_allows_a_remainder_only_with_a_shared_block():
    """zamba2's 38 blocks over its 6-block pattern give JAX's 6 repeats
    (and 2 remainder blocks) whatever the config's name; a pattern without
    the shared block must tile the layers."""
    cfg = cfgbase.get("zamba2-1.2b")
    assert cfg.pattern_repeats == \
        jcfgbase.get("zamba2-1.2b").pattern_repeats == 6
    assert dataclasses.replace(cfg, name="hybrid-38").pattern_repeats == 6
    plain = dataclasses.replace(cfg, pattern=("mamba",) * 5 + ("attn",))
    with pytest.raises(ValueError, match="do not tile the pattern"):
        plain.pattern_repeats


def _state_close(jcaches, caches, atol):
    """Recurrent state leaves within ``atol``."""
    want = _jpaths(jcaches)
    for k, leaf in _paths(caches).items():
        if k.endswith(("ssm", "conv")):
            np.testing.assert_allclose(
                leaf.float().numpy(), np.asarray(want[k]).astype(np.float32),
                rtol=atol, atol=atol, err_msg=k)


def test_prefill_and_dense_decode_match_jax(model):
    """prefill without and with ``lengths`` (right-padded, ragged), then
    decode steps on the dense cache with one slot inactive, whose state
    must not move."""
    jcfg, cfg, jparams, params, jbackend, backend = model
    rng = np.random.default_rng(2)
    B, Sq = 3, 20
    tok = rng.integers(0, cfg.vocab, (B, Sq))
    with matmul_backend(jbackend), _backend.use(backend):
        for lengths in (None, np.array([20, 11, 3])):
            jc, tc = JT.init_cache(jcfg, B, 32), T.init_cache(cfg, B, 32,
                                                              "cpu")
            jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(tok, jnp.int32),
                                jc, lengths=None if lengths is None
                                else jnp.asarray(lengths))
            tl, tc = T.prefill(params, cfg, _t(tok), tc,
                               lengths=None if lengths is None
                               else _t(lengths))
            _close(tl, jl, 1e-4)
            _state_close(jc, tc, 1e-4)
        index = lengths
        for act in ([True, False, True], [True, True, False]):
            act = np.array(act)
            frozen = {k: v.clone() for k, v in _paths(tc).items()}
            token = rng.integers(0, cfg.vocab, B)
            jl, jc = JT.decode_step(jparams, jcfg,
                                    jnp.asarray(token, jnp.int32), jc,
                                    jnp.asarray(index),
                                    active=jnp.asarray(act))
            tl, tc = T.decode_step(params, cfg, _t(token), tc, _t(index),
                                   active=_t(act))
            _close(tl[_t(act)], np.asarray(jl)[act], 1e-4)
            _state_close(jc, tc, 1e-4)
            off = int(np.nonzero(~act)[0][0])
            axes = _paths(T.cache_batch_axes(tc))
            for k, leaf in _paths(tc).items():
                if k.endswith(("ssm", "conv")):
                    assert torch.equal(leaf.select(axes[k], off),
                                       frozen[k].select(axes[k], off)), k
            index = index + act


def test_prefill_chunks_and_paged_decode_match_jax(model):
    """Three chunks of five with mixed valid counts (a slot with valid 0
    carries its state through a chunk) into shuffled page tables, then
    paged decode steps with one slot masked: logits of the live rows
    within 1e-4, recurrent state alike."""
    jcfg, cfg, jparams, params, jbackend, backend = model
    rng = np.random.default_rng(3)
    B, C, ps, W, rows = 3, 5, 4, 6, 17
    pages = np.zeros((B, W), np.int32)
    perm = rng.permutation(np.arange(1, rows))
    pages[0, :4], pages[1, :2], pages[2, :4] = perm[:4], perm[4:6], \
        perm[6:10]
    jc = JT.init_paged_cache(jcfg, B, rows, ps)
    tc = T.init_paged_cache(cfg, B, rows, ps, device="cpu")
    steps = [("chunk", [0, 0, 0], [5, 3, 0]), ("chunk", [5, 3, 0], [5, 0, 4]),
             ("chunk", [10, 3, 4], [2, 0, 5]),
             ("decode", [12, 3, 9], [1, 1, 0]),
             ("decode", [13, 4, 9], [1, 0, 1])]
    with matmul_backend(jbackend), _backend.use(backend):
        for kind, index, live in steps:
            index = np.array(index)
            if kind == "chunk":
                tokens = rng.integers(0, cfg.vocab, (B, C))
                jl, jc = JT.prefill_chunk(
                    jparams, jcfg, jnp.asarray(tokens, jnp.int32), jc,
                    jnp.asarray(index, jnp.int32),
                    jnp.asarray(live, jnp.int32), jnp.asarray(pages))
                tl, tc = T.prefill_chunk(
                    params, cfg, _t(tokens), tc, _t(index),
                    torch.tensor(live), _t(pages).long())
            else:
                token = rng.integers(0, cfg.vocab, B)
                act = np.array(live, bool)
                jl, jc = JT.decode_step(
                    jparams, jcfg, jnp.asarray(token, jnp.int32), jc,
                    jnp.asarray(index, jnp.int32), active=jnp.asarray(act),
                    pages=jnp.asarray(pages))
                tl, tc = T.decode_step(
                    params, cfg, _t(token), tc, _t(index), active=_t(act),
                    pages=_t(pages).long())
            rows_live = np.nonzero(np.array(live))[0]
            _close(tl[rows_live], np.asarray(jl)[rows_live], 1e-4)
            _state_close(jc, tc, 1e-4)


def test_prefill_then_decode_equals_one_long_prefill(model):
    """Decode continuity: prefill of 12 tokens then 4 decode steps gives
    the logits of prefills of 13..16 tokens (the SSD and the recurrence
    sum in other orders: within 1e-4)."""
    jcfg, cfg, jparams, params, jbackend, backend = model
    rng = np.random.default_rng(4)
    tok = _t(rng.integers(0, cfg.vocab, (2, 16)))
    with _backend.use(backend):
        c = T.init_cache(cfg, 2, 16, "cpu")
        _, c = T.prefill(params, cfg, tok[:, :12], c)
        for i in range(12, 16):
            step, c = T.decode_step(params, cfg, tok[:, i], c, i)
            full, _ = T.prefill(params, cfg, tok[:, :i + 1],
                                T.init_cache(cfg, 2, 16, "cpu"))
            torch.testing.assert_close(step, full, rtol=1e-4, atol=1e-4)


def test_scatter_cache_roundtrip():
    """`scatter_cache` writes a k-request cache into the right slots of
    the pool, on the stacked and the remainder leaves, and leaves other
    slots untouched (the JAX package's test)."""
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("zamba2-1.2b"))
    pool = T._tree_map(lambda m: torch.ones(m.shape, dtype=m.dtype),
                       T.cache_specs(cfg, 3, 8))
    sub = T._tree_map(lambda m: torch.full(m.shape, 2, dtype=m.dtype),
                      T.cache_specs(cfg, 2, 8))
    out = T.scatter_cache(pool, sub, torch.tensor([2, 0]))
    assert out is pool
    axes = _paths(T.cache_batch_axes(pool))
    assert set(axes.values()) == {0, 1}
    for k, leaf in _paths(out).items():
        for slot, val in ((0, 2.0), (1, 1.0), (2, 2.0)):
            assert bool((leaf.select(axes[k], slot).float() == val).all()), k


def test_copy_pages_touches_only_page_leaves():
    """Copy-on-write copies page rows of the attention KV, as the JAX
    engine's ``copy_pages_fn``: the per-slot state, whose axis 1 is a slot
    and not a page, is left alone."""
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("zamba2-1.2b"))
    caches = T._tree_map(lambda m: torch.randn(m.shape).to(m.dtype),
                         T.paged_cache_specs(cfg, 4, 5, 2))
    before = {k: v.clone() for k, v in _paths(caches).items()}
    kv_axes = T.cache_kv_axes(cfg)
    T.copy_pages(caches, torch.tensor([1, 3]), torch.tensor([2, 0]),
                 kv_axes)
    markers = _paths(kv_axes)
    for k, leaf in _paths(caches).items():
        if markers[k].startswith("page"):
            assert torch.equal(leaf[:, 2], before[k][:, 1]), k
            assert torch.equal(leaf[:, 0], before[k][:, 3]), k
            assert torch.equal(leaf[:, 1], before[k][:, 1]), k
        else:
            assert torch.equal(leaf, before[k]), k
