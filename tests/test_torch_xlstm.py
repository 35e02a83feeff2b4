"""xlstm-1.3b in the port against the JAX package: mLSTM and sLSTM blocks
(``repro_torch.models.ssm``) and the xLSTM[7:1] model, reduced by
``reduce_for_smoke`` (16 blocks: two repeats of seven mLSTM and one sLSTM,
d_model 64, 4 heads of d_inner / 4 = 32) with float32 parameters imported
from the JAX package through numpy.

Primitives in float32 on the same numpy inputs: `_mlstm_chunked` at S
{1, 17, 256, 300} with and without a carried state, its end state within
1e-5, its h within 1e-5 up to S 17 and within ``tests/test_ssm.py``'s 5e-4
beyond (see `_h_tol`); `mlstm` at S > 1 (the chunked form) and S = 1 (the
recurrent step), with and without state and ``length_mask``, within 1e-5
after its norm and down projection (5e-5 at S 300, past one 256-step
chunk, the bound of zamba2's Mamba2 test); `slstm` (a Python loop over
the steps; masked steps select the old carry, bit for bit) within 1e-5.  The port's chunked form equals
its own step recurrence within ``tests/test_ssm.py``'s 5e-4: the
reference's decode and prefill differ at the denominator clamp, so the
model tests hold chunked against JAX's chunked and step against JAX's
step, never one against the other.

Model: the parameter and cache trees equal JAX's leaf for leaf (the mLSTM
conv carry in the activation dtype, ROADMAP Queue 3); ``prefill`` with
and without ``lengths`` then dense decode steps with one slot inactive,
and chunks with mixed valid counts then paged decode, match JAX's logits
within 1e-4, fp and planned on diana (static activation scales, JAX on its
plain oracles), on the int8 KV cache.  Mapping: names, counts,
assignments and the lowered plans' histograms equal JAX's.  Engines:
tokens, finish reasons, steps and stats equal JAX's `Engine`, dense (JAX's
pool holding the conv carry in the activation dtype) and paged; the dense
and paged engines agree under int8 KV; the prefix cache is gated off; the
speculative bank (digital target, 5 %-ternary draft) gives target-only's
and JAX's tokens and stats with partial accepts replayed over the
restored mLSTM and sLSTM state; the serve CLI serves the reduced arch."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro import serving as js  # noqa: E402
from repro.configs import base as jcfgbase  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.managed import matmul_backend  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch import serving as ts  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import emit_static_mapping  # noqa: E402
from repro_torch.models import _backend  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "xlstm-1.3b"
#: the reduced model's diana plans (max_cout 512: every projection
#: searched): 14 mLSTM blocks x (up, w_if, down) + 2 sLSTM blocks x
#: (w_in, down) + the head
N_LAYERS = 14 * 3 + 2 * 2 + 1
BIASES = {"diana": None, "target": ("digital", 1.0), "draft": ("aimc", 0.05)}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want), rtol=atol, atol=atol)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def _mlstm_inputs(seed, B, S_, H, hd, state):
    """q, v ~ N(0, 1), k ~ N(0, 1) hd**-0.5 (pre-scaled, as `mlstm`
    passes it), the input gate ~ N(0, 1), the forget gate ~ N(2, 1), and a
    carried state (C, n ~ N(0, 1), m ~ N(0, 1)) or zeros."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    ins = (f(B, S_, H, hd), f(B, S_, H, hd) * np.float32(hd ** -0.5),
           f(B, S_, H, hd), f(B, S_, H), f(B, S_, H) + np.float32(2.0))
    if state:
        st = (f(B, H, hd, hd), f(B, H, hd), f(B, H))
    else:
        st = (np.zeros((B, H, hd, hd), np.float32),
              np.zeros((B, H, hd), np.float32), np.zeros((B, H), np.float32))
    return ins, st


def _h_tol(S_):
    """Bound on h of the chunked form: 1e-5 up to S 17; at S 256 and 300
    ``tests/test_ssm.py``'s 5e-4 between two valid summations, since h =
    num / max(|den|, exp(-m)) amplifies the last-bit differences of num
    and den where |den| is small (the largest seen: 3.7e-4 on |h| ~ 25)."""
    return 1e-5 if S_ <= 17 else 5e-4


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "carry"])
@pytest.mark.parametrize("S_", [1, 17, 256, 300])
def test_mlstm_chunked_matches_jax(S_, state):
    """h within `_h_tol`; the end state (C, n, m) within 1e-5 at every S."""
    ins, st = _mlstm_inputs(S_ + state, 2, S_, 3, 8, state)
    (jC, jn, jm), jh = JS._mlstm_chunked(*map(jnp.asarray, ins),
                                         tuple(map(jnp.asarray, st)))
    (C, n, m), h = S._mlstm_chunked(*map(_t, ins), tuple(map(_t, st)))
    _close(h, jh, _h_tol(S_))
    for got, want in ((C, jC), (n, jn), (m, jm)):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("S_,chunk", [(5, 4), (33, 8), (64, 16)])
def test_mlstm_chunked_equals_its_step_recurrence(S_, chunk):
    """The port's chunked form against its own recurrent step, within the
    bound of the JAX package's ``tests/test_ssm.py`` (5e-4; m 1e-5)."""
    ins, st = _mlstm_inputs(3 * S_, 2, S_, 3, 8, False)
    q, k, v, ig, fg = map(_t, ins)
    carry, hs = tuple(map(_t, st)), []
    for i in range(S_):
        carry, h = S._mlstm_step(q[:, i:i + 1], k[:, i:i + 1],
                                 v[:, i:i + 1], ig[:, i:i + 1],
                                 fg[:, i:i + 1], carry)
        hs.append(h)
    (C, n, m), h = S._mlstm_chunked(q, k, v, ig, fg, tuple(map(_t, st)),
                                    chunk=chunk)
    torch.testing.assert_close(h, torch.cat(hs, 1), rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(C, carry[0], rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(m, carry[2], rtol=1e-5, atol=1e-5)


def _xlstm_params(seed, init, d_model=32):
    """JAX-initialised float32 params of an mLSTM or sLSTM block (the conv
    bias drawn away from its zero init), and the port's copy."""
    xcfg = JS.XLSTMConfig(d_model=d_model, n_heads=4)
    jp = getattr(JS, f"init_{init}")(jax.random.PRNGKey(seed), xcfg,
                                     jnp.float32)
    if init == "mlstm":
        rng = np.random.default_rng(seed)
        jp = dict(jp, conv_b=jnp.asarray(rng.normal(0, 0.1, xcfg.d_inner),
                                         jnp.float32))
    return xcfg, jp, T.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _mask(S_, B):
    lens = np.array([S_, max(S_ // 2, 1), 0][:B])
    return np.arange(S_)[None, :] < lens[:, None]


@pytest.mark.parametrize("S_,masked,state", [
    (17, False, False), (17, True, True), (300, True, False),
    (1, False, True), (1, True, True)])
def test_mlstm_matches_jax(S_, masked, state):
    """The chunked form (S > 1) and the recurrent step (S = 1); masked
    rows keep their C, n and conv carry bit for bit."""
    xcfg, jp, tp = _xlstm_params(S_ + masked, "mlstm")
    rng = np.random.default_rng(S_)
    B, H, hd = 3, xcfg.n_heads, xcfg.head_dim
    x = rng.standard_normal((B, S_, xcfg.d_model), dtype=np.float32)
    st = None
    if state:
        st = {"C": rng.standard_normal((B, H, hd, hd), dtype=np.float32),
              "n": rng.standard_normal((B, H, hd), dtype=np.float32),
              "m": rng.standard_normal((B, H), dtype=np.float32),
              "conv": rng.standard_normal(
                  (B, xcfg.conv_kernel - 1, xcfg.d_inner),
                  dtype=np.float32)}
    mask = _mask(S_, B) if masked else None
    jy, jst = JS.mlstm(jp, jnp.asarray(x), xcfg,
                       state=None if st is None else
                       jax.tree.map(jnp.asarray, st),
                       length_mask=None if mask is None else
                       jnp.asarray(mask))
    ty, tst = S.mlstm(tp, _t(x), xcfg,
                      state=None if st is None else
                      {k: _t(v) for k, v in st.items()},
                      length_mask=None if mask is None else _t(mask))
    live = np.ones((B, S_), bool) if mask is None else mask
    # past one 256-step chunk the carried state sums in other orders too
    # (the bound of zamba2's Mamba2 test at S 300)
    tol = 1e-5 if S_ <= S.MLSTM_CHUNK else 5e-5
    _close(ty[torch.from_numpy(live)], np.asarray(jy)[live], tol)
    for key in ("C", "n", "m", "conv"):
        _close(tst[key], jst[key], tol)
    if masked and state:
        for key in ("C", "n", "conv"):
            np.testing.assert_array_equal(tst[key][2].numpy(), st[key][2])


@pytest.mark.parametrize("S_,masked,state", [
    (9, False, False), (9, True, True), (1, True, True)])
def test_slstm_matches_jax(S_, masked, state):
    """The step loop against JAX's scan; at a masked step the carry is
    selected unchanged, bit for bit."""
    xcfg, jp, tp = _xlstm_params(40 + S_, "slstm")
    rng = np.random.default_rng(S_ + 1)
    B, H, hd = 3, xcfg.n_heads, xcfg.head_dim
    x = rng.standard_normal((B, S_, xcfg.d_model), dtype=np.float32)
    st = None
    if state:
        st = {k: rng.standard_normal((B, H, hd), dtype=np.float32)
              for k in ("c", "h")}
        st["n"] = np.abs(rng.standard_normal((B, H, hd),
                                             dtype=np.float32))
        st["m"] = rng.standard_normal((B, H), dtype=np.float32)
    mask = _mask(S_, B) if masked else None
    jy, jst = JS.slstm(jp, jnp.asarray(x), xcfg,
                       state=None if st is None else
                       jax.tree.map(jnp.asarray, st),
                       length_mask=None if mask is None else
                       jnp.asarray(mask))
    ty, tst = S.slstm(tp, _t(x), xcfg,
                      state=None if st is None else
                      {k: _t(v) for k, v in st.items()},
                      length_mask=None if mask is None else _t(mask))
    live = np.ones((B, S_), bool) if mask is None else mask
    _close(ty[torch.from_numpy(live)], np.asarray(jy)[live], 1e-5)
    for key in ("c", "n", "h", "m"):
        _close(tst[key], jst[key], 1e-5)
    if masked and state:
        for key in ("c", "n", "h", "m"):
            np.testing.assert_array_equal(tst[key][2].numpy(), st[key][2])


# --------------------------------------------------------------------------
# model: reduced xlstm-1.3b, float32
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xlstm(tmp_path_factory):
    """(jcfg, cfg, jparams, params, JAX artifacts, port artifacts) of
    float32 reduced xlstm on the int8 KV cache: diana's min-cost split,
    the all-digital target and the 5 %-ternary draft, static activation
    scales."""
    tmp = tmp_path_factory.mktemp("xlstm")
    jcfgbase.load_all()
    over = dict(param_dtype="float32", kv_cache_dtype="int8")
    jcfg = dataclasses.replace(
        jcfgbase.reduce_for_smoke(jcfgbase.get(ARCH)), **over)
    cfg = dataclasses.replace(cfgbase.reduce_for_smoke(cfgbase.get(ARCH)),
                              **over)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jarts = {k: j_emit(jparams, jcfg, "diana", tmp / f"j_{k}.json",
                       act_log_scale=2.0, bias=b) for k, b in BIASES.items()}
    arts = {k: emit_static_mapping(params, cfg, "diana", tmp / f"{k}.json",
                                   act_log_scale=2.0, bias=b)
            for k, b in BIASES.items()}
    return jcfg, cfg, jparams, params, jarts, arts


def _backends(xlstm, planned):
    jcfg, cfg, jparams, params, jarts, _ = xlstm
    if not planned:
        return None, None
    art = jarts["diana"]
    return (jrt.PlannedBackend(jrt.lower(art, params=jparams), jparams,
                               reference=True),
            rt.PlannedBackend(rt.lower(art.to_dict(), params=params),
                              params))


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


def test_params_and_cache_trees_match_jax(xlstm):
    """init_lm's tree, shapes and dtypes (eight stacked pattern positions
    of two repeats, each block's weights under ``core``), params_from_jax,
    and every cache tree's paths, shapes and dtypes (the mLSTM conv carry
    in the activation dtype, the rest float32), markers and batch axes."""
    jcfg, cfg, jparams, params, _, _ = xlstm
    fresh = T.init_lm(torch.Generator().manual_seed(0), cfg)
    assert isinstance(fresh["units"], tuple) and len(fresh["units"]) == 8
    mine, conv, want = _paths(fresh), _paths(params), _jpaths(jparams)
    assert sorted(mine) == sorted(conv) == sorted(want)
    for k, leaf in want.items():
        assert tuple(mine[k].shape) == tuple(leaf.shape), k
        assert conv[k].dtype == mine[k].dtype == _tdtype(leaf.dtype), k
        np.testing.assert_array_equal(conv[k].numpy(), np.asarray(leaf))
    assert fresh["units"][0]["core"]["wq_bd"].shape == (2, 4, 32, 32)
    assert fresh["units"][7]["core"]["r"].shape == (2, 4, 32, 128)
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
    markers = _paths(T.cache_kv_axes(cfg))
    assert markers == _jpaths(JT.cache_kv_axes(jcfg))
    assert set(markers.values()) == {"slot1"}
    caches = T.init_cache(cfg, 2, 8, device="cpu")
    assert _paths(T.cache_batch_axes(caches)) == _jpaths(
        JT.cache_batch_axes(JT.init_cache(jcfg, 2, 8)))


def _state_close(jcaches, caches, atol):
    want = _jpaths(jcaches)
    for k, leaf in _paths(caches).items():
        np.testing.assert_allclose(
            leaf.float().numpy(), np.asarray(want[k]).astype(np.float32),
            rtol=atol, atol=atol, err_msg=k)


@pytest.mark.parametrize("planned", [False, True], ids=["fp", "diana"])
def test_prefill_and_dense_decode_match_jax(xlstm, planned):
    """prefill without and with ``lengths`` (right-padded, ragged), then
    decode steps on the dense cache with one slot inactive, whose state
    moves by at most mLSTM's padding step (C, n, the conv carry and the
    sLSTM state bit for bit)."""
    jcfg, cfg, jparams, params, _, _ = xlstm
    jbackend, backend = _backends(xlstm, planned)
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
                got, was = (t.select(axes[k], off) for t in (leaf,
                                                             frozen[k]))
                if k.split("/")[1] != "7" and k.endswith("/m"):
                    # mLSTM's m: m + log sigmoid(80) (-1.8e-35)
                    torch.testing.assert_close(got, was, rtol=0,
                                               atol=1e-30)
                else:
                    assert torch.equal(got, was), k
            index = index + act


@pytest.mark.parametrize("planned", [False, True], ids=["fp", "diana"])
def test_prefill_chunks_and_paged_decode_match_jax(xlstm, planned):
    """Three chunks of five with mixed valid counts (a slot with valid 0
    carries its state through a chunk), then paged decode steps with one
    slot masked: logits of the live rows within 1e-4, the state alike."""
    jcfg, cfg, jparams, params, _, _ = xlstm
    jbackend, backend = _backends(xlstm, planned)
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


# --- mapping artifacts -----------------------------------------------------

@pytest.mark.parametrize("name", sorted(BIASES))
def test_mapping_names_counts_and_kernels_match_jax(xlstm, name):
    """The port's emission names the projections under ``core``, as JAX's
    (the block-diagonal q / k / v, the conv and sLSTM's ``r`` are no
    layers), with JAX's counts and assignments, and the plans lower to
    JAX's histograms."""
    jcfg, cfg, jparams, params, jarts, arts = xlstm
    jd, td = jarts[name].to_dict(), arts[name].to_dict()
    names = [l["name"] for l in td["layers"]]
    assert names == [l["name"] for l in jd["layers"]]
    assert len(names) == N_LAYERS
    assert {"units/0/core/up@0", "units/0/core/w_if@1",
            "units/6/core/down@1", "units/7/core/w_in@0",
            "units/7/core/down@1", "head"} <= set(names)
    for a, b in zip(td["layers"], jd["layers"]):
        assert a["counts"] == b["counts"], a["name"]
        assert a["assignment"] == b["assignment"], a["name"]
    hist = rt.lower(td, params=params).kernel_histogram()
    assert hist == jrt.lower(jarts[name], params=jparams).kernel_histogram()
    if name == "diana":
        assert hist == {"split_ternary": N_LAYERS}


# --- engines ---------------------------------------------------------------

def _tokens(results):
    return {r.rid: [int(t) for t in r.tokens] for r in results}


def _trace(m, vocab, **kw):
    """A mixed trace: prompts 3-29 tokens, 2-8 new, two arrivals a step."""
    rng = np.random.default_rng(kw.pop("seed", 1))
    return [m.Request(rid=i, prompt=rng.integers(0, vocab, int(
        rng.integers(3, 30))).astype(np.int32),
        max_new_tokens=int(rng.integers(2, 9)), arrival_step=i // 2)
        for i in range(kw.pop("n", 6))]


ENGINE_STATS = ("decode_steps", "prefill_calls", "kv_capacity_bytes",
                "kv_peak_bytes", "resumes", "preemptions")
PAGED_STATS = ("kv_peak_pages", "kv_page_bytes", "prefix_lookups",
               "prefix_hit_requests", "prefix_hit_tokens", "cow_copies",
               "page_evictions")


def _activation_dtype_carry(monkeypatch, jcfg):
    """Route around a quirk of the reference (ROADMAP Queue 3): JAX's
    dense engine scatters its first admission group's mLSTM conv carry
    into a pool leaf of the KV dtype, which truncates it under int8 KV.
    Give that pool the activation dtype's carry from the start, as the
    port holds it."""
    init = JT.init_cache

    def init_cache(cfg, B, S_max):
        return jax.tree_util.tree_map_with_path(
            lambda path, leaf: leaf.astype(jcfg.param_dtype)
            if getattr(path[-1], "key", None) == "conv" else leaf,
            init(cfg, B, S_max))
    monkeypatch.setattr(JT, "init_cache", init_cache)


def _engines(xlstm, layout, planned):
    jcfg, cfg, jparams, params, _, _ = xlstm
    jbackend, backend = _backends(xlstm, planned)
    kw = dict(max_batch=3, max_len=48, page_size=4, kv_layout=layout)
    return (js.Engine(jcfg, jparams, backend=jbackend, **kw),
            ts.Engine(cfg, params, backend=backend, **kw))


@pytest.mark.parametrize("layout,planned", [
    ("dense", False), ("dense", True), ("paged", False), ("paged", True)],
    ids=["dense-fp", "dense-diana", "paged-fp", "paged-diana"])
def test_engine_matches_jax(xlstm, layout, planned, monkeypatch):
    """Tokens, finish reasons, admitted / finished steps and the engine's
    stats identical to JAX's `Engine` on a mixed trace (int8 KV): slots
    retire and refill while others decode (dense: ragged group prefills
    scattered into the pool; paged: chunks of 8 carrying the state, each
    admitted slot's state zeroed)."""
    if layout == "dense":
        _activation_dtype_carry(monkeypatch, xlstm[0])
    jeng, eng = _engines(xlstm, layout, planned)
    vocab = xlstm[1].vocab
    jres = jeng.run(_trace(js, vocab))
    res = eng.run(_trace(ts, vocab))
    assert eng._has_recurrent and jeng._has_recurrent
    assert len(res) == len(jres) == 6
    for a, b in zip(res, jres):
        assert (a.rid, a.tokens, a.finish_reason, a.admitted_step,
                a.finished_step) == (b.rid, [int(t) for t in b.tokens],
                                     b.finish_reason, b.admitted_step,
                                     b.finished_step)
    keys = ENGINE_STATS + (PAGED_STATS if layout == "paged" else ())
    for key in keys:
        assert eng.stats[key] == jeng.stats[key], key


def test_dense_and_paged_agree_under_int8_kv(xlstm):
    """The port holds the conv carry in the activation dtype in both
    layouts, so under the int8 KV cache its dense engine gives the paged
    engines' tokens (JAX's paged engine's too)."""
    jpaged, paged = _engines(xlstm, "paged", True)
    _, dense = _engines(xlstm, "dense", True)
    vocab = xlstm[1].vocab
    want = _tokens(jpaged.run(_trace(js, vocab)))
    assert _tokens(paged.run(_trace(ts, vocab))) == want
    assert _tokens(dense.run(_trace(ts, vocab))) == want


def test_prefix_cache_is_gated_off_for_recurrent_state(xlstm):
    """mLSTM and sLSTM state is not page-resident: both packages turn the
    prefix cache off, and a shared-prefix trace gives JAX's tokens with no
    prefix hit."""
    jcfg, cfg, jparams, params, _, _ = xlstm
    kw = dict(max_batch=2, max_len=64, page_size=4, kv_layout="paged",
              prefix_cache=True)
    jeng = js.Engine(jcfg, jparams, **kw)
    eng = ts.Engine(cfg, params, **kw)
    assert not eng.prefix_cache and not jeng.prefix_cache
    trace = dict(n=4, vocab=cfg.vocab, seed=2, min_prompt=4, max_prompt=8,
                 min_new=2, max_new=4, shared_prefix=12)
    jres = jeng.run(js.synthetic_trace(**trace))
    res = eng.run(ts.synthetic_trace(**trace))
    assert _tokens(res) == _tokens(jres)
    assert eng.stats["prefix_hit_tokens"] == 0 == \
        jeng.stats["prefix_hit_tokens"]


def test_speculative_replay_matches_target_only_and_jax(xlstm):
    """A 5 %-ternary draft accepts part of its tokens, so rounds replay
    the committed tokens over the restored mLSTM and sLSTM state.  Tokens
    equal target-only's and JAX's, every speculative stat equals JAX's,
    and replays ran."""
    jcfg, cfg, jparams, params, jarts, _ = xlstm
    variants = {v: jarts[v] for v in ("target", "draft")}
    jbank = jrt.PlanSet({v: jrt.lower(a, params=jparams)
                         for v, a in variants.items()}, jparams,
                        default="target", reference=True)
    bank = rt.PlanSet({v: rt.lower(a.to_dict(), params=params)
                       for v, a in variants.items()}, params,
                      default="target")
    trace = dict(vocab=cfg.vocab, seed=3, min_prompt=4, max_prompt=10,
                 min_new=4, max_new=10)
    eng = dict(max_batch=2, max_len=64, kv_layout="paged")
    jspec = js.Engine(jcfg, jparams, backend=jbank,
                      speculate=("draft", "target"), draft_k=4, **eng)
    spec = ts.Engine(cfg, params, backend=bank,
                     speculate=("draft", "target"), draft_k=4, **eng)
    replays = []
    replay = spec._replay

    def counting(x, drafted, caches, snap, valid):
        replays.append(valid.copy())
        return replay(x, drafted, caches, snap, valid)
    spec._replay = counting
    ref = ts.Engine(cfg, params, backend=bank, **eng)
    got = _tokens(spec.run(ts.synthetic_trace(4, **trace)))
    want = _tokens(ref.run(ts.synthetic_trace(4, **trace)))
    jgot = _tokens(jspec.run(js.synthetic_trace(4, **trace)))
    assert got == want == jgot
    st, jst = spec.stats, jspec.stats
    for key in ("spec_rounds", "spec_drafted", "spec_accepted",
                "spec_committed", "spec_acceptance", "spec_tokens_per_round",
                "decode_steps", "prefill_calls"):
        assert st[key] == jst[key], key
    assert 0 < st["spec_acceptance"] < 1
    assert replays and all(0 < v.max() <= 4 for v in replays)


# --- the serve CLI ---------------------------------------------------------

def test_serve_cli_planned_batch_and_engine(tmp_path, capsys):
    """``serve --arch xlstm-1.3b --reduce --device cpu`` on the artifact
    of the params it builds (seed 0) at full coverage, through serve_batch
    and through ``--engine``."""
    cfg = cfgbase.reduce_for_smoke(cfgbase.get(ARCH))
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    path = tmp_path / "m.json"
    emit_static_mapping(params, cfg, "diana", path)
    args = ["--arch", ARCH, "--reduce", "--device", "cpu", "--mapping",
            str(path), "--require-full-coverage"]
    tokens, _ = serve.main(args + ["--requests", "2", "--prompt-len", "16",
                                   "--gen-len", "4"])
    out = capsys.readouterr().out
    assert tuple(tokens.shape) == (2, 4)
    assert 0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab
    for want in ("per-layer planned execution", ", 0 unbound",
                 "split_ternary"):
        assert want in out, want
    serve.main(args + ["--engine", "--requests", "4", "--prompt-len", "12",
                       "--gen-len", "4", "--max-batch", "2"])
    out = capsys.readouterr().out
    for want in ("engine[continuous]", "ttft p50", "paged kv:"):
        assert want in out, want
