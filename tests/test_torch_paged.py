"""The port's paged KV layout (``repro_torch.serving.Engine(kv_layout=
"paged")``, `PagePool`, ``paged_update`` / ``paged_gather``,
``transformer.prefill_chunk``) against the JAX package's on the same numpy
inputs.

Mechanics with no model: a seeded random sequence of `PagePool`
operations (admission with prefix match and copy-on-write pin, prompt
registration, release, purge, eviction under pressure) gives the same
returns, refcounts, free list, LRU and stats in both packages; the paged
KV writes and gathers match JAX's exactly on int8 and bf16 pools (outside
the trash page, where several masked writes land and which one wins is
left undefined).  Model steps on a reduced yi-9b with the JAX package's
float32 parameters, fp and planned on diana with static activation scales
(``act_log_scale=2.0``; the JAX planned runs use its plain oracles,
``PlannedBackend(reference=True)``): ``prefill_chunk`` and ``decode_step
(pages=, active=)`` logits within 1e-4, the bound of
``test_torch_model.py``, over several chunks with mixed valid counts, and
the page pools equal outside the trash page.  Engine runs: tokens, finish
reasons, admitted and finished steps, decode steps, chunk calls and every
paged stat identical to the JAX ``Engine(kv_layout="paged")`` on a skewed
trace, a shared-prefix trace cold and then warm, a prompt beyond the
dense ``max_len``, a pool small enough to evict, deadline preemption and
the queue-depth and page-watermark sheds, fp and planned.  One JAX and one
port engine per configuration are shared by the module's tests (JAX jits
each engine's steps once); the paged pool and the allocator's stats
persist across `run` calls in both packages alike."""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro import serving as js  # noqa: E402
from repro.configs import base as jcfgbase  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.managed import matmul_backend  # noqa: E402
from repro.serving.paged import PagePool as JPagePool  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch import serving as ts  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import _backend  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.batch import BatchState  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# PagePool, scheduler and batch-state mechanics (no model)
# --------------------------------------------------------------------------

def _pool_state(pool):
    return (pool.ref.tolist(), list(pool.free), list(pool.lru),
            dict(pool.by_hash), {p: list(k) for p, k in pool.keys_of.items()},
            pool.in_use, dict(pool.stats), pool.available())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pagepool_random_operations_match_jax(seed):
    """Requests over a bank of prompts that share prefixes, on a pool too
    small for all of them: every return and the whole allocator state
    agree after each operation."""
    rng = np.random.default_rng(seed)
    ps = 4
    stem = rng.integers(0, 50, 12).astype(np.int32)
    bank = [np.concatenate([stem[:rng.integers(0, 13)],
                            rng.integers(0, 50, rng.integers(1, 9))
                            .astype(np.int32)]) for _ in range(8)]
    pools = [JPagePool(14, ps), ts.PagePool(14, ps)]
    held = []                                # [(pages, prompt)]
    for _ in range(60):
        op = rng.choice(["admit", "admit", "release", "purge"])
        if op == "admit":
            prompt = bank[rng.integers(len(bank))]
            need = pools[0].pages_for(len(prompt) + int(rng.integers(1, 5)))
            if need > pools[0].available():
                op = "release"
            else:
                outs = []
                completed = rng.random() < 0.8       # prefill completed
                for pool in pools:
                    hit, shared, cow = pool.match(prompt)
                    pages = shared + pool.alloc(need - len(shared))
                    if cow is not None:
                        pool.release_cow(cow)
                    if completed:
                        for key, end in pool.prompt_keys(prompt):
                            pool.register(pages[(end - 1) // ps], key)
                    outs.append((hit, shared, cow, pages))
                assert outs[0] == outs[1]
                held.append((outs[0][3], prompt))
        if op in ("release", "purge") and held:
            pages, _ = held.pop(int(rng.integers(len(held))))
            for pool in pools:
                if op == "purge":
                    pool.purge(pages)
                pool.release(pages)
        assert _pool_state(pools[0]) == _pool_state(pools[1])
    assert pools[1].stats["hit_requests"] > 0
    if seed == 0:
        assert pools[1].stats["evictions"] > 0


def test_pagepool_errors_match_jax():
    for mk in (JPagePool, ts.PagePool):
        with pytest.raises(ValueError, match="num_pages"):
            mk(0, 4)
        pool = mk(2, 4)
        with pytest.raises(RuntimeError, match="exhausted"):
            pool.alloc(3)
        (page,) = pool.alloc(1)
        pool.release([page])
        with pytest.raises(RuntimeError, match="unreferenced"):
            pool.decref(page)


def _req(R, rid, plen=4, new=4, arrival=0):
    return R(rid=rid, prompt=np.arange(plen) % 7, max_new_tokens=new,
             arrival_step=arrival)


def test_queue_push_front_and_scheduler_preempts_match_jax():
    for m in (js, ts):
        q = m.RequestQueue()
        for rid in "abc":
            q.push(_req(m.Request, rid))
        q.push_front(_req(m.Request, "z"))
        assert [r.rid for r in q] == ["z", "a", "b", "c"]
        assert [p for p in m.POLICIES if m.Scheduler(p).preempts] == \
            ["deadline"]


def test_batchstate_paged_lifecycle():
    """A prefilling slot is busy but not active: not free, not decoded;
    `assign` after a resume continues the token count and position."""
    bs = BatchState(3, caches=None, pages_per_slot=4)
    req = _req(ts.Request, "a", plen=6, new=5)
    bs.start_prefill(1, req, [3, 7], hit_len=4, t_ready=0.0, step=2)
    assert bs.prefilling[1] and not bs.active[1] and bs.n_busy == 1
    assert bs.free_slots() == [0, 2] and bs.any_busy() and not bs.any_active()
    assert bs.page_table[1].tolist() == [3, 7, 0, 0]
    assert bs.fill_pos[1] == bs.lengths[1] == 4
    with pytest.raises(RuntimeError, match="busy"):
        bs.start_prefill(1, req, [], 0, 0.0, 0)
    st = bs.assign(1, req, 9, t_ready=0.0, t_first=0.5, step=2,
                   prompt_len=8, prior_tokens=[4, 5])
    assert st.tokens == [4, 5, 9] and bs.n_gen[1] == 3 and bs.lengths[1] == 8
    assert bs.active[1] and not bs.prefilling[1] and bs.pending[1] is None
    bs.retire(1)
    assert bs.free_slots() == [0, 1, 2] and bs.n_busy == 0


# --------------------------------------------------------------------------
# paged_update / paged_gather
# --------------------------------------------------------------------------

KV_DTYPES = {"int8": (torch.int8, jnp.int8), "bfloat16": (torch.bfloat16,
                                                          jnp.bfloat16)}


def _values(rng, shape, kv):
    if kv == "int8":
        return rng.integers(-127, 128, shape).astype(np.float32)
    return (rng.integers(-64, 65, shape) / 8.0).astype(np.float32)


def _both_update(kv, pool, val, pages, index, mask=None):
    """(JAX pool after `paged_update`, its gather; the port's)."""
    tdt, jdt = KV_DTYPES[kv]
    jpool = JA.paged_update(jnp.asarray(pool, jdt), jnp.asarray(val, jdt),
                            jnp.asarray(pages), jnp.asarray(index),
                            mask=None if mask is None else jnp.asarray(mask))
    tpool = torch.from_numpy(pool).to(tdt)
    out = A.paged_update(tpool, torch.from_numpy(val).to(tdt),
                         torch.from_numpy(pages), torch.from_numpy(index),
                         None if mask is None else torch.from_numpy(mask))
    assert out is tpool
    jview = JA.paged_gather(jpool, jnp.asarray(pages))
    tview = A.paged_gather(tpool, torch.from_numpy(pages))
    return (np.asarray(jpool).astype(np.float32),
            np.asarray(jview).astype(np.float32),
            tpool.float().numpy(), tview.float().numpy())


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_paged_update_gather_match_jax(kv):
    """Round trip through shuffled page tables with masked writes: the
    pool outside the trash page and the gathered rows of mapped pages are
    JAX's exactly, and the masked writes left the slots' pages alone."""
    rng = np.random.default_rng(5)
    ps, W, B, S, KVH, hd = 4, 5, 3, 6, 2, 3
    pool = _values(rng, (1 + 12, ps, KVH, hd), kv)
    pages = np.zeros((B, W), np.int32)
    perm = rng.permutation(np.arange(1, 13))
    pages[0, :4], pages[1, :5], pages[2, :3] = perm[:4], perm[4:9], \
        perm[9:12]
    val = _values(rng, (B, S, KVH, hd), kv)
    index = np.array([2, 13, 0], np.int64)
    mask = rng.random((B, S)) < 0.7
    jpool, jview, tpool, tview = _both_update(kv, pool, val, pages, index,
                                              mask)
    np.testing.assert_array_equal(tpool[1:], jpool[1:])
    mapped = np.repeat(pages > 0, ps, axis=1)
    np.testing.assert_array_equal(tview[mapped], jview[mapped])
    for b in range(B):
        for s in range(S):
            pos = index[b] + s
            if mask[b, s] and pos < W * ps and pages[b, pos // ps]:
                np.testing.assert_array_equal(tview[b, pos], val[b, s])
    untouched = np.ones(pool.shape[0], bool)
    untouched[0] = False
    for b in range(B):
        for s in range(S):
            pos = index[b] + s
            if mask[b, s] and pos < W * ps:
                untouched[pages[b, pos // ps]] = False
    np.testing.assert_array_equal(tpool[untouched], pool[untouched]
                                  .astype(tpool.dtype))


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_paged_update_out_of_table_positions_go_to_trash(kv):
    """Positions at or beyond ``W * page_size`` and page-table entries of
    0 write into the trash page, whatever the mask says."""
    ps = 2
    pool = np.zeros((4, ps, 1, 1), np.float32)
    pages = np.array([[1, 2], [3, 0]], np.int32)
    val = np.full((2, 3, 1, 1), 5.0, np.float32)
    jpool, jview, tpool, tview = _both_update(
        kv, pool, val, pages, np.array([3, 1], np.int64))
    np.testing.assert_array_equal(tpool[1:], jpool[1:])
    assert tview[0, :, 0, 0].tolist() == [0, 0, 0, 5]   # pos 4, 5 dropped
    assert tview[1, :2, 0, 0].tolist() == [0, 5]        # pos 2, 3: page 0
    assert tpool[3].sum() == 5 and tpool[1:3].sum() == 5


def test_paged_writes_land_in_the_stacked_pool():
    """`gqa(pages=)` on one repeat's view of the stacked (R, P+1, ps, KVH,
    hd) pool writes into the pool itself; a pool that is not contiguous
    raises instead of taking the writes in a copy."""
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    caches = T.init_paged_cache(cfg, 2, 9, 4, device="cpu")
    k = caches["units"][0]["k"]
    ptr = k.data_ptr()
    pages = torch.tensor([[1, 2], [3, 0]])
    _, out = T.decode_step(params, cfg, torch.tensor([3, 5]), caches,
                           torch.tensor([5, 1]), active=torch.tensor(
                               [True, False]), pages=pages)
    assert out is caches and out["units"][0]["k"].data_ptr() == ptr
    written = (k != 0).flatten(3).any(-1)           # (R, P+1, ps)
    for r in range(cfg.pattern_repeats):
        assert written[r, 2].tolist() == [False, True, False, False]
        assert not written[r, 1].any() and not written[r, 3:].any()
    with pytest.raises(RuntimeError, match="view"):
        A.paged_update(k[0].transpose(0, 1), torch.zeros(1, 1, 4, 4, 16),
                       pages[:1], torch.tensor([0]))


# --------------------------------------------------------------------------
# model steps and engines on reduced yi-9b (float32 parameters)
# --------------------------------------------------------------------------

_MODELS = {}


def _model(planned, tmp_path_factory):
    """(jcfg, cfg, jparams, params, jbackend, backend), one per module:
    planned on diana with static activation scales and the int8 KV cache
    the artifact asks for, or fp with the bf16 cache."""
    if planned in _MODELS:
        return _MODELS[planned]
    jcfgbase.load_all()
    over = dict(param_dtype="float32",
                kv_cache_dtype="int8" if planned else "bfloat16")
    jcfg = dataclasses.replace(
        jcfgbase.reduce_for_smoke(jcfgbase.get("yi-9b")), **over)
    cfg = dataclasses.replace(
        cfgbase.reduce_for_smoke(cfgbase.get("yi-9b")), **over)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jbackend = backend = None
    if planned:
        path = tmp_path_factory.mktemp("artifact") / "m.json"
        art = j_emit(jparams, jcfg, "diana", path, max_cout=64,
                     act_log_scale=2.0)
        jbackend = jrt.PlannedBackend(jrt.lower(art, params=jparams),
                                      jparams, reference=True)
        backend = rt.PlannedBackend(rt.lower(art.to_dict(), params=params),
                                    params)
        assert not backend.unbound
    _MODELS[planned] = (jcfg, cfg, jparams, params, jbackend, backend)
    return _MODELS[planned]


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "diana"])
def model(request, tmp_path_factory):
    return _model(request.param, tmp_path_factory)


def _pools_equal(jcaches, caches):
    """The pools outside the trash page: int8 codes (planned: the
    projections are integer-exact in both packages) equal; bf16 values (fp:
    the two frameworks' float32 projections differ in the last bits, which
    the bf16 rounding of k and v turns into one bf16 step now and then)
    within one bf16 step of each value."""
    for key in ("k", "v"):
        want = np.asarray(jcaches["units"][0][key]).astype(np.float32)
        got = caches["units"][0][key].float().numpy()
        if caches["units"][0][key].dtype == torch.int8:
            np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
        else:
            np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=2**-7,
                                       atol=0)


def test_prefill_chunk_and_paged_decode_match_jax(model):
    """Three chunks of five with mixed valid counts (0 for a slot that is
    idle or decoding) into shuffled page tables, then decode steps with
    one slot masked: logits of the live rows within 1e-4, pools equal
    outside the trash page."""
    jcfg, cfg, jparams, params, jbackend, backend = model
    rng = np.random.default_rng(3)
    B, C, ps, W = 3, 5, 4, 6
    rows = 1 + 16
    pages = np.zeros((B, W), np.int32)
    perm = rng.permutation(np.arange(1, rows))
    pages[0, :4], pages[1, :2], pages[2, :4] = perm[:4], perm[4:6], \
        perm[6:10]
    jcaches = JT.init_paged_cache(jcfg, B, rows, ps)
    caches = T.init_paged_cache(cfg, B, rows, ps, device="cpu")
    steps = [("chunk", [0, 0, 0], [5, 3, 0]), ("chunk", [5, 3, 0], [5, 0, 4]),
             ("chunk", [10, 3, 4], [2, 0, 5]),
             ("decode", [12, 3, 9], [1, 1, 0]),
             ("decode", [13, 4, 9], [1, 0, 1])]
    with matmul_backend(jbackend), _backend.use(backend):
        for kind, index, live in steps:
            index = np.array(index)
            if kind == "chunk":
                tokens = rng.integers(0, cfg.vocab, (B, C))
                jl, jcaches = JT.prefill_chunk(
                    jparams, jcfg, jnp.asarray(tokens, jnp.int32), jcaches,
                    jnp.asarray(index, jnp.int32), jnp.asarray(live,
                                                               jnp.int32),
                    jnp.asarray(pages))
                tl, caches = T.prefill_chunk(
                    params, cfg, torch.from_numpy(tokens), caches,
                    torch.from_numpy(index), torch.tensor(live),
                    torch.from_numpy(pages).long())
            else:
                token = rng.integers(0, cfg.vocab, B)
                act = np.array(live, bool)
                jl, jcaches = JT.decode_step(
                    jparams, jcfg, jnp.asarray(token, jnp.int32), jcaches,
                    jnp.asarray(index, jnp.int32), active=jnp.asarray(act),
                    pages=jnp.asarray(pages))
                tl, caches = T.decode_step(
                    params, cfg, torch.from_numpy(token), caches,
                    torch.from_numpy(index), active=torch.from_numpy(act),
                    pages=torch.from_numpy(pages).long())
            rows_live = np.nonzero(np.array(live))[0]
            np.testing.assert_allclose(tl.numpy()[rows_live],
                                       np.asarray(jl)[rows_live], rtol=0,
                                       atol=1e-4)
            _pools_equal(jcaches, caches)


# --- engine parity ---------------------------------------------------------

#: engine configurations shared by the module's tests (one JAX engine and
#: one port engine each, per model)
ENGINES = {
    # W 12 (slot capacity 48) over a dense max_len of 45; chunks of 8
    "skew": dict(max_batch=3, max_len=45, page_size=4),
    "prefix": dict(max_batch=3, max_len=45, page_size=4),
    "evict": dict(max_batch=2, max_len=24, page_size=4, num_pages=8),
    "deadline": dict(max_batch=2, max_len=48, page_size=8,
                     policy="deadline"),
    "fcfs": dict(max_batch=2, max_len=48, page_size=8),
    "depth": dict(max_batch=1, max_len=48, page_size=8, max_queue_depth=2),
    "watermark": dict(max_batch=2, max_len=48, page_size=8, num_pages=12,
                      page_watermark=0.9),
}
_ENGINES = {}


def _engines(name, model):
    """(JAX engine, port engine) of configuration ``name`` on ``model``."""
    key = (name, id(model))
    if key not in _ENGINES:
        jcfg, cfg, jparams, params, jbackend, backend = model
        kw = dict(ENGINES[name])
        policy = kw.pop("policy", "continuous")
        _ENGINES[key] = (
            js.Engine(jcfg, jparams, kv_layout="paged", backend=jbackend,
                      scheduler=js.Scheduler(policy), **kw),
            ts.Engine(cfg, params, backend=backend,
                      scheduler=ts.Scheduler(policy), **kw))
    return _ENGINES[key]


PAGED_STATS = ("decode_steps", "prefill_calls", "kv_peak_pages",
               "kv_page_bytes", "kv_peak_bytes", "kv_capacity_bytes",
               "prefix_lookups", "prefix_hit_requests", "prefix_hit_tokens",
               "cow_copies", "page_evictions", "preemptions", "resumes",
               "shed_requests", "faults_detected")


def _run_both(name, model, mk):
    """Run ``mk(package) -> [Request]`` through both engines of ``name``;
    assert the runs identical and return the port's (results, stats)."""
    jeng, teng = _engines(name, model)
    jres, tres = jeng.run(mk(js)), teng.run(mk(ts))
    for a, b in zip(jres, tres):
        assert type(a).__name__ == type(b).__name__
        if isinstance(b, ts.ShedResult):
            assert (b.rid, b.reason, b.shed_step) == \
                (a.rid, a.reason, a.shed_step)
            continue
        assert (b.rid, b.tokens, b.finish_reason, b.admitted_step,
                b.finished_step, b.prompt_len, b.preemptions,
                b.requeues) == \
            (a.rid, [int(t) for t in a.tokens], a.finish_reason,
             a.admitted_step, a.finished_step, a.prompt_len, a.preemptions,
             a.requeues)
    assert {k: teng.stats[k] for k in PAGED_STATS} == \
        {k: jeng.stats[k] for k in PAGED_STATS}
    assert set(teng.stats) == set(jeng.stats)
    return tres, dict(teng.stats)


def _skewed(m, vocab):
    return m.synthetic_trace(7, vocab=vocab, min_prompt=2, max_prompt=9,
                             min_new=2, max_new=5, seed=4, long_every=3,
                             long_prompt=30, arrival_every=1)


def test_engine_paged_matches_jax_on_a_skewed_trace(model):
    """Long prompts among short ones with staggered arrivals: chunked
    prefill interleaves with decode, and the peak KV stays under the
    dense capacity."""
    cfg = model[1]
    res, st = _run_both("skew", model, lambda m: _skewed(m, cfg.vocab))
    assert st["prefill_calls"] > 7 and st["decode_steps"] > 0
    assert st["kv_peak_bytes"] < st["kv_capacity_bytes"]
    assert all(r.n_tokens == r0.max_new_tokens
               for r, r0 in zip(res, _skewed(ts, cfg.vocab)))


def test_engine_paged_matches_jax_on_a_shared_prefix_cold_then_warm(model):
    """Six requests behind one 10-token system prompt, three slots: the
    cold run's later admissions map the first group's prefix pages, and
    the warm run (pool resident) serves every prompt from cache but its
    last token."""
    cfg = model[1]

    def mk(m):
        return m.synthetic_trace(6, vocab=cfg.vocab, min_prompt=2,
                                 max_prompt=6, min_new=2, max_new=4, seed=1,
                                 shared_prefix=10)
    cold, cst = _run_both("prefix", model, mk)
    assert cst["prefix_hit_tokens"] > 0 and cst["prefix_hit_requests"] >= 3
    warm, wst = _run_both("prefix", model, mk)
    assert [r.tokens for r in warm] == [r.tokens for r in cold]
    assert wst["prefix_hit_requests"] - cst["prefix_hit_requests"] == 6
    assert wst["prefix_hit_tokens"] - cst["prefix_hit_tokens"] == \
        sum(r.prompt_len - 1 for r in warm)
    assert wst["prefill_calls"] < cst["prefill_calls"]


def test_engine_paged_serves_a_prompt_beyond_the_dense_max_len(model):
    """A 46-token prompt that the dense engines (max_len 45) reject is
    served in slots of 48 positions, its six chunks interleaved with the
    short requests' decode steps."""
    jcfg, cfg, jparams, params = model[:4]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (46, 3, 5, 4)]

    def mk(m):
        return [m.Request(rid="long", prompt=prompts[0], max_new_tokens=2)] \
            + [m.Request(rid=i, prompt=p, max_new_tokens=2 + i,
                         arrival_step=i) for i, p in enumerate(prompts[1:])]
    for eng, m in ((js.Engine(jcfg, jparams, max_len=45, kv_layout="dense"),
                    js),
                   (ts.Engine(cfg, params, max_len=45, kv_layout="dense"),
                    ts)):
        with pytest.raises(ValueError, match="max_len"):
            eng.run(mk(m))
    res, st = _run_both("skew", model, mk)
    res = {r.rid: r for r in res}
    assert res["long"].n_tokens == 2 and res["long"].prompt_len == 46
    first_long = res["long"].admitted_step + 46 // 8     # its last chunk
    assert min(res[i].finished_step for i in range(3)) < first_long


def test_engine_paged_matches_jax_when_a_small_pool_evicts(model):
    cfg = model[1]

    def mk(m):
        return m.synthetic_trace(6, vocab=cfg.vocab, min_prompt=2,
                                 max_prompt=6, min_new=2, max_new=4, seed=6,
                                 shared_prefix=8)
    res, st = _run_both("evict", model, mk)
    assert st["page_evictions"] > 0 and st["kv_peak_pages"] <= 8
    assert all(isinstance(r, ts.RequestResult) for r in res)


_PREEMPT_SPEC = [("low0", 8, 12, 0, 0, None), ("low1", 8, 12, 0, 0, None),
                 ("hi", 6, 4, 3, 5, 10.0)]


def _spec_reqs(m, vocab, spec):
    out = []
    for rid, plen, new, arrival, priority, deadline in spec:
        rng = np.random.default_rng(zlib.crc32(str(rid).encode()))
        out.append(m.Request(rid=rid, prompt=rng.integers(0, vocab, plen),
                             max_new_tokens=new, arrival_step=arrival,
                             priority=priority, deadline_ms=deadline))
    return out


def test_engine_paged_deadline_preemption_matches_jax_and_fcfs(model):
    """A priority request arriving at step 3 preempts a running one: both
    packages preempt and resume alike, the resume prefill hits the parked
    pages, and the tokens equal an FCFS replay without preemption."""
    cfg = model[1]
    res, st = _run_both("deadline", model,
                        lambda m: _spec_reqs(m, cfg.vocab, _PREEMPT_SPEC))
    assert st["preemptions"] >= 1 and st["resumes"] == st["preemptions"]
    assert sum(r.preemptions for r in res) == st["preemptions"]
    assert st["prefix_hit_tokens"] > 0
    ref, rst = _run_both("fcfs", model,
                         lambda m: _spec_reqs(m, cfg.vocab, _PREEMPT_SPEC))
    assert rst["preemptions"] == 0
    assert {r.rid: r.tokens for r in res} == {r.rid: r.tokens for r in ref}


def test_engine_paged_queue_depth_and_watermark_sheds_match_jax(model):
    cfg = model[1]
    res, st = _run_both("depth", model, lambda m: _spec_reqs(
        m, cfg.vocab, [(f"q{i}", 6, 4, 0, 0, None) for i in range(6)]))
    sheds = [r for r in res if isinstance(r, ts.ShedResult)]
    assert len(sheds) == 3 and {s.reason for s in sheds} == {"queue_depth"}
    res, st = _run_both("watermark", model, lambda m: _spec_reqs(
        m, cfg.vocab, [(f"w{i}", 8, 4, 0, 0, None) for i in range(4)]))
    sheds = [r for r in res if isinstance(r, ts.ShedResult)]
    assert sheds and {s.reason for s in sheds} == {"page_watermark"}
    assert st["shed_requests"] == len(sheds)


def test_engine_paged_and_dense_layouts_give_the_same_tokens(model):
    cfg, params, backend = model[1], model[3], model[5]
    trace = _skewed(ts, cfg.vocab)
    out = {}
    for layout in ts.KV_LAYOUTS:
        eng = ts.Engine(cfg, params, max_batch=3, max_len=40,
                        backend=backend, kv_layout=layout)
        out[layout] = [(r.tokens, r.finish_reason) for r in eng.run(trace)]
    assert out["paged"] == out["dense"]


@pytest.mark.parametrize("kw", [
    dict(kv_layout="paged"), dict(page_size=16), dict(num_pages=8),
    dict(prefill_chunk=8), dict(prefix_cache=False),
    dict(page_watermark=0.5)])
def test_engine_paged_arguments_match_jax(kw):
    """The paged arguments (raising NotImplementedError before this layout
    was ported) size the engine as the JAX package's do."""
    jcfg, cfg, jparams, params = _configs_small()
    jeng, teng = js.Engine(jcfg, jparams, **kw), ts.Engine(cfg, params, **kw)
    for attr in ("kv_layout", "page_size", "pages_per_slot", "slot_cap",
                 "num_pages", "prefill_chunk", "prefix_cache",
                 "page_watermark", "max_preemptions", "quarantine_steps",
                 "_kv_capacity_bytes", "_kv_page_bytes"):
        assert getattr(teng, attr) == getattr(jeng, attr), attr


def _configs_small():
    jcfgbase.load_all()
    jcfg = jcfgbase.reduce_for_smoke(jcfgbase.get("yi-9b"))
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
    return (jcfg, cfg, JT.init_lm(jax.random.PRNGKey(0), jcfg),
            T.init_lm(torch.Generator().manual_seed(0), cfg))


def test_engine_paged_rejects_what_jax_rejects():
    jcfg, cfg, jparams, params = _configs_small()
    req = dict(rid=0, prompt=np.zeros(40, np.int32), max_new_tokens=4)
    kw = dict(max_batch=1, max_len=32, page_size=8)
    with pytest.warns(UserWarning, match="unservable"), \
            pytest.raises(ValueError, match="pages") as want:
        js.Engine(jcfg, jparams, **kw).run([js.Request(**req)])
    with pytest.warns(UserWarning, match="unservable"), \
            pytest.raises(ValueError, match="pages") as got:
        ts.Engine(cfg, params, **kw).run([ts.Request(**req)])
    assert str(got.value) == str(want.value)


# --- containment, sampling and the step's transfers ------------------------

def _nan_at(monkeypatch, name, calls, slot):
    """`transformer.<name>` returns NaN logits for ``slot`` at the given
    call indices (0-based)."""
    orig = getattr(T, name)
    count = [0]

    def wrapped(*args, **kw):
        logits, caches = orig(*args, **kw)
        if count[0] in calls:
            logits = logits.clone()
            logits[slot] = float("nan")
        count[0] += 1
        return logits, caches
    monkeypatch.setattr(T, name, wrapped)


@pytest.mark.parametrize("where", ["decode", "chunk"])
def test_engine_paged_contains_nonfinite_logits(where, monkeypatch):
    """A slot whose logits turn non-finite commits nothing: the request is
    requeued once (its pages purged, the slot quarantined) and resumes to
    the clean run's tokens; a second fault sheds it with "fault"."""
    _, cfg, _, params = _configs_small()
    trace = lambda: [ts.Request(rid=i, prompt=np.arange(3 + 5 * i) % 97,
                                max_new_tokens=6) for i in range(2)]
    mk = lambda: ts.Engine(cfg, params, max_batch=1, max_len=32,
                           page_size=4)
    clean = mk().run(trace())
    # one slot: request 0 takes chunk call 0 and decode calls 0-4, request
    # 1 chunk call 1 and decode calls 5-9
    name, first = (("decode_step", 6) if where == "decode"
                   else ("prefill_chunk", 1))
    _nan_at(monkeypatch, name, {first}, 0)
    eng = mk()
    res = eng.run(trace())
    assert eng.stats["faults_detected"] == 1
    assert eng.stats["resumes"] == (where == "decode")   # tokens committed
    assert [r.tokens for r in res] == [r.tokens for r in clean]
    assert [r.requeues for r in res] == [0, 1]
    monkeypatch.undo()
    _nan_at(monkeypatch, name, {first, first + 1}, 0)
    eng = mk()
    res = eng.run(trace())
    assert isinstance(res[1], ts.ShedResult) and res[1].reason == "fault"
    assert res[0].tokens == clean[0].tokens
    assert eng.stats["faults_detected"] == 2


def test_engine_paged_sampling_is_seed_deterministic_and_batch_independent(
        tmp_path_factory):
    """Prompts over several chunks: a request's sampled stream is the same
    alone (one slot) as beside two others, so a prefilling slot's
    generator does not advance before its prompt completes."""
    _, cfg, _, params, _, backend = _model(True, tmp_path_factory)
    rng = np.random.default_rng(13)
    reqs = [ts.Request(rid=i, prompt=rng.integers(0, cfg.vocab, n),
                       max_new_tokens=5) for i, n in enumerate((19, 4, 11))]

    def run(seed, max_batch):
        eng = ts.Engine(cfg, params, max_batch=max_batch, max_len=32,
                        page_size=4, backend=backend,
                        sampling=ts.SamplingParams(temperature=1.5,
                                                   top_p=0.9, seed=seed))
        return [r.tokens for r in eng.run(reqs)]
    first = run(3, 3)
    assert run(3, 3) == first and run(3, 1) == first and run(4, 3) != first


def test_engine_steps_make_one_upload_and_one_download(monkeypatch):
    """Every chunk step and every decode step, paged and dense, uploads
    one packed tensor and downloads one; no step calls ``.item()``,
    ``.tolist()`` or ``.cpu()`` elsewhere, or branches on a tensor."""
    _, cfg, _, params = _configs_small()
    events = []
    counted = ("item", "tolist", "cpu", "__bool__", "__int__", "__float__")
    for attr in counted:
        orig = getattr(torch.Tensor, attr)

        def wrapped(self, *a, _orig=orig, _attr=attr, **kw):
            events.append(_attr)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, attr, wrapped)
    for name in ("prefill_chunk", "decode_step"):
        orig = getattr(T, name)

        def step(*a, _orig=orig, _name=name, **kw):
            events.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(T, name, step)
    rng = np.random.default_rng(2)
    trace = [ts.Request(rid=i, prompt=rng.integers(0, cfg.vocab, n),
                        max_new_tokens=4, arrival_step=i)
             for i, n in enumerate((13, 3, 7))]
    for layout in ts.KV_LAYOUTS:
        eng = ts.Engine(cfg, params, max_batch=2, max_len=24, page_size=4,
                        kv_layout=layout)
        up0, down0 = eng._upload, eng._download
        eng._upload = lambda x: (events.append("up"), up0(x))[1]
        eng._download = lambda x: (events.append("down"), down0(x))[1]
        events.clear()
        eng.run(trace)
        steps = [e for e in events if e in ("prefill_chunk", "decode_step")]
        assert len(steps) == eng.stats["decode_steps"] + (
            eng.stats["prefill_calls"] if layout == "paged" else 0)
        calls = iter(i for i, e in enumerate(events) if e in
                     ("prefill_chunk", "decode_step"))
        for i in calls:
            assert events[i - 1] == "up", (layout, events[i - 3:i + 3])
            j = events.index("down", i)
            assert set(events[i + 1:j]) <= {"prefill_chunk", "decode_step"}
            assert events[j + 1] == "cpu", events[j:j + 3]
        others = [e for e in events if e in counted and e != "cpu"]
        assert others == []
        assert events.count("cpu") == events.count("down")
        n_admit = 0 if layout == "paged" else eng.stats["prefill_calls"]
        assert events.count("up") == len(steps)
        assert events.count("down") == len(steps) + n_admit


# --------------------------------------------------------------------------
# serve_batch and the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("planned", [False, True], ids=["fp", "diana"])
def test_serve_batch_tokens_match_jax_engine_backed(planned,
                                                    tmp_path_factory):
    """Both packages' ``serve_batch`` run the paged engine: identical
    tokens and the same stats keys."""
    jcfg, cfg, jparams, params, jbackend, backend = _model(
        planned, tmp_path_factory)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (3, 9),
                                                dtype=np.int32)
    jtok, jst = jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts), 5,
                                   backend=jbackend)
    tok, st = serve.serve_batch(cfg, params, torch.from_numpy(prompts).long(),
                                5, backend=backend)
    assert tok.tolist() == np.asarray(jtok).tolist()
    assert set(st) == set(jst)
    assert tuple(tok.shape) == (3, 5)


def test_serve_batch_takes_a_prompt_over_2048_tokens(tmp_path_factory):
    """A 2100-token prompt streams through the paged engine's chunks (no
    chunked-attention contract: no padding, any length) with the JAX
    package's tokens."""
    jcfg, cfg, jparams, params, jbackend, backend = _model(
        True, tmp_path_factory)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (1, 2100),
                                                dtype=np.int32)
    jtok, _ = jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts), 3,
                                 backend=jbackend)
    tok, st = serve.serve_batch(cfg, params, torch.from_numpy(prompts).long(),
                                3, backend=backend)
    assert tok.tolist() == np.asarray(jtok).tolist()
    assert st["prefill_s"] > 0


_CLI = ["--arch", "yi-9b", "--reduce", "--device", "cpu", "--engine",
        "--requests", "4", "--prompt-len", "16", "--gen-len", "4"]


def test_serve_cli_engine_defaults_to_paged(capsys):
    results, summ = serve.main(_CLI + ["--page-size", "8", "--num-pages",
                                       "12", "--prefill-chunk", "8",
                                       "--page-watermark", "0.1"])
    out = capsys.readouterr().out
    assert summ["completed"] == 4
    assert "[serve] paged kv: page_size=8 pool=12 pages" in out


def test_serve_cli_shared_prefix_hits_the_prefix_cache(capsys):
    results, summ = serve.main(_CLI + ["--shared-prefix", "24",
                                       "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "shared prefix 24" in out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("[serve] paged kv:"))
    hits = int(line.split("prefix_hit_tokens=")[1].split()[0])
    assert hits >= 16 and summ["completed"] == 4


def test_serve_cli_check_preempt_parity(capsys):
    results, summ = serve.main(_CLI + [
        "--policy", "deadline", "--priorities", "0,0,0,5", "--max-batch",
        "2", "--check-preempt-parity"])
    out = capsys.readouterr().out
    assert "[serve] preemption token parity (4 completed requests): True" \
        in out
    assert "[serve] robustness: preemptions=" in out
    with pytest.raises(SystemExit):
        serve.main(_CLI + ["--check-preempt-parity"])
