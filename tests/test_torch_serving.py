"""The port's continuous-batching engine (``repro_torch.serving``, dense KV
layout, passed as ``kv_layout="dense"``: the default is paged, whose tests
are in ``test_torch_paged.py``) against the JAX package's
``repro.serving`` on the same numpy inputs.

Mechanics with no model: queue, scheduler (all three policies), batch
state, request validation, traces and ``summarize`` give what the JAX
package's give.  Engine runs on a reduced yi-9b whose float32 parameters
are the JAX package's, fp and planned on diana with static activation
scales (``act_log_scale=2.0``, full coverage): every request's tokens,
finish reason, admitted and finished steps and the run's decode-step and
prefill-call counts equal those of the JAX ``Engine(kv_layout="dense")``
(the JAX planned runs use the JAX package's plain oracles,
``PlannedBackend(reference=True)``).  float32 parameters because with
bf16 ones the two frameworks' planned logits differ by more than some
top-2 margins (ROADMAP.md Queue 3).  The long-prompt case (a prompt over
2048 tokens takes the chunked attention) is compared under the margin
rule: each request up to its first step whose top-2 logit margin is below
1e-3, where the two frameworks' last bits may pick either token."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro import serving as js  # noqa: E402
from repro.configs import base as jcfgbase  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.sampling import sample_tokens as j_sample  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch import serving as ts  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import _backend  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import sampling as tsampling  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# scheduler / queue / batch-state mechanics (no model)
# --------------------------------------------------------------------------

def _req(rid, plen=4, new=4, arrival=0):
    return ts.Request(rid=rid, prompt=np.arange(plen) % 7,
                      max_new_tokens=new, arrival_step=arrival)


def test_queue_arrival_visibility_and_fcfs():
    q = ts.RequestQueue()
    for r in (_req("a"), _req("b", arrival=3), _req("c")):
        q.push(r)
    assert len(q) == 3 and q.ready(0) == 2 and q.ready(3) == 3
    assert q.next_arrival() == 0
    got = q.pop_ready(0, 5)
    assert [r.rid for r in got] == ["a", "c"]     # FCFS among visible
    assert [r.rid for r in q] == ["b"]
    assert q.pop_ready(0, 5) == [] and q.next_arrival() == 3


def test_scheduler_continuous_fills_free_slots():
    q = ts.RequestQueue()
    for i in range(3):
        q.push(_req(i))
    adm = ts.Scheduler("continuous").admissions(q, free_slots=[0, 2],
                                                n_active=2, step=0)
    assert [(s, r.rid) for s, r in adm] == [(0, 0), (2, 1)]
    assert len(q) == 1


def test_scheduler_static_waits_for_drain():
    q = ts.RequestQueue()
    q.push(_req("x"))
    sched = ts.Scheduler("static")
    assert sched.admissions(q, free_slots=[1], n_active=1, step=0) == []
    assert len(q) == 1                       # nothing popped while active
    adm = sched.admissions(q, free_slots=[0, 1], n_active=0, step=0)
    assert [(s, r.rid) for s, r in adm] == [(0, "x")]


def test_scheduler_rejects_unknown_policy():
    with pytest.raises(ValueError, match="policy"):
        ts.Scheduler("round_robin")


def test_batchstate_slot_lifecycle():
    bs = ts.BatchState(2, caches=None)
    assert bs.free_slots() == [0, 1] and not bs.any_active()
    st = bs.assign(0, _req("a", plen=3), first_token=5, t_ready=0.0,
                   t_first=0.1, step=0)
    assert bs.active[0] and bs.lengths[0] == 3 and bs.last_tok[0] == 5
    assert st.tokens == [5] and bs.free_slots() == [1]
    assert bs.n_gen[0] == 1 and bs.max_new[0] == 4 and bs.eos_id[0] == -1
    with pytest.raises(RuntimeError, match="active"):
        bs.assign(0, _req("b"), 1, 0.0, 0.0, 0)
    assert bs.retire(0).request.rid == "a"
    assert bs.free_slots() == [0, 1]
    assert bs.lengths[0] == 3                # kept, as in the JAX package
    with pytest.raises(RuntimeError, match="not occupied"):
        bs.retire(0)


@pytest.mark.parametrize("kw,match", [
    (dict(prompt=np.zeros(0), max_new_tokens=2), "empty prompt"),
    (dict(prompt=np.zeros(3), max_new_tokens=0), "max_new_tokens"),
    (dict(prompt=np.zeros(3), max_new_tokens=2, arrival_step=-1),
     "arrival_step"),
    (dict(prompt=np.zeros(3), max_new_tokens=2, eos_id=1.5), "eos_id"),
    (dict(prompt=np.zeros(3), max_new_tokens=2, priority="hi"),
     "priority"),
    (dict(prompt=np.zeros(3), max_new_tokens=2, deadline_ms=float("nan")),
     "deadline_ms"),
])
def test_request_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match) as want:
        js.Request(rid=0, **kw)
    with pytest.raises(ValueError, match=match) as got:
        ts.Request(rid=0, **kw)
    assert str(got.value) == str(want.value)


def _same_requests(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.rid, x.max_new_tokens, x.arrival_step, x.eos_id, x.slo,
                x.priority, x.deadline_ms) == \
            (y.rid, y.max_new_tokens, y.arrival_step, y.eos_id, y.slo,
             y.priority, y.deadline_ms)
        assert x.prompt.dtype == y.prompt.dtype
        np.testing.assert_array_equal(x.prompt, y.prompt)


def test_trace_roundtrip_and_determinism(tmp_path):
    t1 = ts.synthetic_trace(5, vocab=64, seed=3, arrival_every=2,
                            priorities=[0, 2], deadlines_ms=[None, 50.0])
    _same_requests(t1, ts.synthetic_trace(5, vocab=64, seed=3,
                                          arrival_every=2,
                                          priorities=[0, 2],
                                          deadlines_ms=[None, 50.0]))
    p = ts.save_trace(tmp_path / "t.jsonl", t1)
    _same_requests(t1, ts.load_trace(p))
    _same_requests(t1, js.load_trace(p))      # the JAX package reads it


@pytest.mark.parametrize("kw", [
    dict(n=6, seed=0),
    dict(n=5, seed=3, arrival_every=2, min_prompt=2, max_prompt=40),
    dict(n=7, seed=11, shared_prefix=5, long_every=3, long_prompt=50),
    dict(n=6, seed=2, slo_classes=["a", "b"], priorities=[1, 0, 2],
         deadlines_ms=[None, 20.0]),
    dict(n=12, seed=0, min_prompt=64, max_prompt=512, min_new=4,
         max_new=16),
])
def test_synthetic_trace_and_arrivals_same_as_jax(kw):
    kw = dict(kw, vocab=64000)
    port, ref = ts.synthetic_trace(**kw), js.synthetic_trace(**kw)
    _same_requests(port, ref)
    _same_requests(ts.poisson_arrivals(port, 0.5, seed=kw["seed"]),
                   js.poisson_arrivals(ref, 0.5, seed=kw["seed"]))


def test_load_trace_shape_only_entries_same_as_jax(tmp_path):
    p = tmp_path / "t.jsonl"
    p.write_text("\n".join(json.dumps(d) for d in [
        {"id": "x", "prompt_len": 9, "max_new_tokens": 3},
        {"id": "y", "prompt": [1, 2, 3], "arrival_step": 4, "eos_id": 2,
         "priority": 1, "deadline_ms": 12.5},
        {"prompt_len": 4}]) + "\n")
    _same_requests(ts.load_trace(p, vocab=100), js.load_trace(p, vocab=100))
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"id": "z"}\n')
    with pytest.raises(ValueError, match="prompt") as got:
        ts.load_trace(bad)
    with pytest.raises(ValueError, match="prompt") as want:
        js.load_trace(bad)
    assert str(got.value) == str(want.value)


def _both(mk):
    """The same requests in both packages: ``mk(Request) -> [Request]``."""
    return mk(js.Request), mk(ts.Request)


@pytest.mark.parametrize("policy", ["continuous", "static", "deadline"])
def test_scheduler_decisions_match_jax(policy):
    """A scripted sequence of admission rounds: free slots, active count,
    step, wall time and per-request ready times; both packages' schedulers
    pick the same (slot, request) pairs and leave the same queue."""
    def mk(R):
        return [R(rid=i, prompt=np.arange(3), max_new_tokens=2,
                  arrival_step=arr, priority=pri, deadline_ms=dl)
                for i, (arr, pri, dl) in enumerate([
                    (0, 0, None), (0, 1, 400.0), (1, 0, 10.0),
                    (1, 1, 50.0), (2, 0, None), (4, 2, None),
                    (4, 0, 5.0), (6, 1, None)])]
    jreqs, treqs = _both(mk)
    jq, tq = js.RequestQueue(), ts.RequestQueue()
    for a, b in zip(jreqs, treqs):
        jq.push(a)
        tq.push(b)
    rounds = [([0, 1], 0, 0, 0.0), ([2], 2, 1, 0.01), ([], 3, 2, 0.02),
              ([1, 3], 1, 3, 0.05), ([0], 3, 4, 0.06),
              ([0, 1, 2, 3], 0, 5, 0.1), ([2], 3, 6, 0.2),
              ([0, 1, 3], 0, 9, 0.3)]
    jsched, tsched = js.Scheduler(policy), ts.Scheduler(policy)
    for free, n_active, step, now in rounds:
        jt = {id(r): 0.001 * r.rid for r in jreqs}
        tt = {id(r): 0.001 * r.rid for r in treqs}
        got = tsched.admissions(tq, free, n_active, step, now=now,
                                t_ready=tt)
        want = jsched.admissions(jq, free, n_active, step, now=now,
                                 t_ready=jt)
        assert [(s, r.rid) for s, r in got] == \
            [(s, r.rid) for s, r in want], (policy, step)
        assert [r.rid for r in tq] == [r.rid for r in jq]


def test_urgency_matches_jax():
    for pri, dl, ready in [(0, None, None), (2, 100.0, 0.5), (1, 0.0, 1.0),
                           (0, 30.0, None)]:
        j = js.Request(rid=0, prompt=[1], max_new_tokens=1, priority=pri,
                       deadline_ms=dl)
        t = ts.Request(rid=0, prompt=[1], max_new_tokens=1, priority=pri,
                       deadline_ms=dl)
        assert ts.urgency(t, 2.0, ready) == js.urgency(j, 2.0, ready)


def test_summarize_matches_jax():
    def results(m):
        return [
            m.RequestResult(rid=0, prompt_len=5, tokens=[1, 2, 3],
                            finish_reason="max_new_tokens", ttft_s=0.1,
                            finish_s=0.4, admitted_step=0, finished_step=2,
                            slo="a"),
            m.RequestResult(rid=1, prompt_len=3, tokens=[4],
                            finish_reason="eos", ttft_s=0.2, finish_s=0.2,
                            admitted_step=1, finished_step=1),
            m.RequestResult(rid=2, prompt_len=9, tokens=[5, 6],
                            finish_reason="timeout", ttft_s=float("nan"),
                            finish_s=0.9, admitted_step=1, finished_step=4,
                            slo="b"),
            m.ShedResult(rid=3, reason="queue_depth", shed_step=2,
                         waited_s=0.05, slo="a"),
            m.ShedResult(rid=4, reason="timeout", shed_step=3,
                         waited_s=1.5)]
    from repro.serving import metrics as jm
    from repro_torch.serving import metrics as tm
    for wall in (1.25, 0.0):
        assert ts.summarize(results(tm), wall) == \
            js.summarize(results(jm), wall)
    assert ts.summarize([], 1.0) == js.summarize([], 1.0)
    for xs, p in [([], 50), ([3.0, 1.0, float("inf"), 2.0], 95),
                  ([0.5], 0)]:
        assert ts.percentile(xs, p) == js.percentile(xs, p)


# --------------------------------------------------------------------------
# the engine against the JAX package's dense engine
# --------------------------------------------------------------------------

def _configs(kv="bfloat16"):
    jcfgbase.load_all()
    over = dict(param_dtype="float32", kv_cache_dtype=kv)
    return (dataclasses.replace(
        jcfgbase.reduce_for_smoke(jcfgbase.get("yi-9b")), **over),
        dataclasses.replace(
            cfgbase.reduce_for_smoke(cfgbase.get("yi-9b")), **over))


def _model(planned, tmp_path):
    """(jcfg, cfg, jparams, params, jbackend, backend); planned on diana
    with static activation scales and the int8 KV cache the artifact asks
    for, or fp with the bf16 cache."""
    jcfg, cfg = _configs("int8" if planned else "bfloat16")
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
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
        assert not backend.unbound
    return jcfg, cfg, jparams, params, jbackend, backend


def _mixed(R, vocab, seed=9):
    rng = np.random.default_rng(seed)
    specs = [(6, 3, 0), (2, 6, 0), (9, 2, 0), (4, 4, 1), (3, 3, 1),
             (12, 7, 2), (5, 2, 6)]
    return [R(rid=i, prompt=rng.integers(0, vocab, size=p),
              max_new_tokens=n, arrival_step=a)
            for i, (p, n, a) in enumerate(specs)]


def _run_both(jcfg, cfg, jparams, params, jbackend, backend, mk, **kw):
    jreqs, treqs = _both(mk)
    jeng = js.Engine(jcfg, jparams, kv_layout="dense", backend=jbackend,
                     **kw)
    teng = ts.Engine(cfg, params, kv_layout="dense", backend=backend, **kw)
    return jeng.run(jreqs), jeng.stats, teng.run(treqs), teng.stats


def _assert_same_run(jres, jstats, tres, tstats):
    for a, b in zip(jres, tres):
        assert type(a).__name__ == type(b).__name__
        if isinstance(b, ts.ShedResult):
            assert (b.rid, b.reason, b.shed_step) == \
                (a.rid, a.reason, a.shed_step)
            continue
        assert (b.rid, b.tokens, b.finish_reason, b.admitted_step,
                b.finished_step, b.prompt_len) == \
            (a.rid, [int(t) for t in a.tokens], a.finish_reason,
             a.admitted_step, a.finished_step, a.prompt_len)
    for key in ("decode_steps", "prefill_calls", "kv_capacity_bytes",
                "kv_peak_bytes"):
        assert tstats[key] == jstats[key], key
    assert set(tstats) == set(jstats)


@pytest.mark.parametrize("planned", [False, True], ids=["fp", "diana"])
def test_engine_matches_jax_dense_engine(planned, tmp_path):
    """Mixed lengths and staggered arrivals in two slots of 16 positions:
    slots retire (budget, length cap) and refill while the other decodes."""
    jcfg, cfg, jparams, params, jbackend, backend = _model(planned,
                                                           tmp_path)
    jres, jstats, tres, tstats = _run_both(
        jcfg, cfg, jparams, params, jbackend, backend,
        lambda R: _mixed(R, cfg.vocab), max_batch=2, max_len=16)
    _assert_same_run(jres, jstats, tres, tstats)
    assert {r.finish_reason for r in tres} == {"max_new_tokens",
                                               "length_cap"}
    assert all(0 <= r.ttft_s <= r.finish_s for r in tres)


@pytest.mark.parametrize("planned", [False, True], ids=["fp", "diana"])
def test_engine_matches_its_own_serve_batch(planned, tmp_path):
    """Each request's dense-engine tokens equal the port's serve_batch
    serving it alone (B = 1, through the paged engine)."""
    _, cfg, _, params, _, backend = _model(planned, tmp_path)
    reqs = _mixed(ts.Request, cfg.vocab, seed=5)
    eng = ts.Engine(cfg, params, max_batch=3, max_len=20, backend=backend,
                    kv_layout="dense")
    for r, res in zip(reqs, eng.run(reqs)):
        gen, _ = serve.serve_batch(cfg, params,
                                   torch.from_numpy(r.prompt).long()[None],
                                   r.max_new_tokens, backend=backend)
        assert res.tokens == gen[0].tolist(), r.rid


def test_engine_static_policy_same_tokens_more_steps(tmp_path):
    """The static gang-batching baseline produces the same greedy tokens
    but cannot overlap mixed-length requests; both policies run as in the
    JAX package."""
    jcfg, cfg, jparams, params, _, _ = _model(False, tmp_path)

    def mk(R):
        return (js if R is js.Request else ts).synthetic_trace(
            6, vocab=cfg.vocab, min_prompt=3, max_prompt=10, min_new=2,
            max_new=8, seed=2)
    runs = {}
    for policy in ("continuous", "static"):
        jreqs, treqs = _both(mk)
        jeng = js.Engine(jcfg, jparams, kv_layout="dense", max_batch=2,
                         max_len=20, scheduler=js.Scheduler(policy))
        teng = ts.Engine(cfg, params, max_batch=2, max_len=20,
                         scheduler=ts.Scheduler(policy), kv_layout="dense")
        tres = teng.run(treqs)
        _assert_same_run(jeng.run(jreqs), jeng.stats, tres, teng.stats)
        runs[policy] = (tres, teng.stats)
    (cres, cst), (sres, sst) = runs["continuous"], runs["static"]
    assert [r.tokens for r in cres] == [r.tokens for r in sres]
    assert sst["decode_steps"] >= cst["decode_steps"]


def test_engine_deadline_policy_matches_jax(tmp_path):
    """Under the deadline policy the dense engines admit by urgency (no
    preemption on the dense layout, in either package)."""
    jcfg, cfg, jparams, params, _, _ = _model(False, tmp_path)

    def mk(R):
        return (js if R is js.Request else ts).synthetic_trace(
            6, vocab=cfg.vocab, min_prompt=3, max_prompt=10, min_new=2,
            max_new=6, seed=4, priorities=[0, 1, 2])
    jreqs, treqs = _both(mk)
    jeng = js.Engine(jcfg, jparams, kv_layout="dense", max_batch=2,
                     max_len=20, scheduler=js.Scheduler("deadline"))
    teng = ts.Engine(cfg, params, max_batch=2, max_len=20,
                     scheduler=ts.Scheduler("deadline"), kv_layout="dense")
    tres = teng.run(treqs)
    _assert_same_run(jeng.run(jreqs), jeng.stats, tres, teng.stats)
    assert [r.rid for r in sorted(tres, key=lambda r: r.admitted_step)][:2] \
        == ["r2", "r5"]                     # priority 2 first


def test_engine_retirement_and_admission(tmp_path):
    """Slots retire on max_new_tokens / eos / length_cap and are refilled
    mid-flight, against the JAX dense engine on the same trace.  The EOS id
    is a token that request 1 generates AFTER its first one (the JAX
    package's version of this test takes the probe's second token, which
    on this model equals the first, so its request retires at admission).
    Request 2 retires at the length cap (its slot's length reaches
    max_len) while request 3 keeps decoding and nothing waits for the
    freed slot: the inactive slot's KV writes must stay in range."""
    jcfg, cfg, jparams, params, _, _ = _model(False, tmp_path)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (4, 5, 14, 3, 3)]
    probe = ts.Engine(cfg, params, max_batch=1, max_len=16,
                      kv_layout="dense").run(
        [ts.Request(rid="p", prompt=prompts[1], max_new_tokens=6)])[0]
    later = [t for t in probe.tokens[1:] if t != probe.tokens[0]]
    assert later, probe.tokens
    eos = later[0]
    n_eos = probe.tokens.index(eos) + 1

    def mk(R):
        return [R(rid=0, prompt=prompts[0], max_new_tokens=1),
                R(rid=1, prompt=prompts[1], max_new_tokens=6, eos_id=eos),
                R(rid=2, prompt=prompts[2], max_new_tokens=8),
                R(rid=3, prompt=prompts[3], max_new_tokens=6),
                R(rid=4, prompt=prompts[4], max_new_tokens=3,
                  arrival_step=6)]
    jres, jstats, tres, tstats = _run_both(
        jcfg, cfg, jparams, params, None, None, mk, max_batch=2,
        max_len=16)
    _assert_same_run(jres, jstats, tres, tstats)
    res = {r.rid: r for r in tres}
    assert res[0].finish_reason == "max_new_tokens" and res[0].n_tokens == 1
    assert res[0].finished_step == res[0].admitted_step
    assert res[1].finish_reason == "eos" and res[1].n_tokens == n_eos >= 2
    assert res[2].finish_reason == "length_cap"
    assert res[2].prompt_len + res[2].n_tokens - 1 == 16
    assert res[3].finish_reason == "max_new_tokens" and res[3].n_tokens == 6
    assert res[4].n_tokens == 3 and res[4].admitted_step >= 6
    # request 2's slot stays free, at length max_len, for decode steps of
    # request 3 before request 4 arrives
    assert res[2].finished_step + 1 < min(res[3].finished_step,
                                          res[4].admitted_step)
    assert all(r.ttft_s >= 0 and r.finish_s >= r.ttft_s
               for r in res.values())


def test_decode_inputs_keep_inactive_writes_in_range():
    """A slot retired at the length cap keeps ``lengths == max_len``; the
    decode step's write position for it is 0, for active slots their
    length."""
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    eng = ts.Engine(cfg, params, max_batch=3, max_len=8, kv_layout="dense")
    bs = ts.BatchState(3, caches=None)
    bs.assign(0, _req("a", plen=5), 7, 0.0, 0.0, 0)
    bs.assign(1, _req("b", plen=7), 9, 0.0, 0.0, 0)
    bs.lengths[1] = 8
    bs.retire(1)
    inputs = eng.decode_inputs(bs)
    assert inputs.dtype == np.int64 and inputs.shape == (3, 3)
    assert inputs[0].tolist() == [7, 9, 0]
    assert inputs[1].tolist() == [5, 0, 0]
    assert inputs[2].tolist() == [1, 0, 0]
    assert int(inputs[1].max()) < eng.max_len


def test_engine_rejects_oversized_prompt():
    jcfg, cfg = _configs()
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError, match="max_len") as got:
        ts.Engine(cfg, params, max_batch=1, max_len=8,
                  kv_layout="dense").run(
            [ts.Request(rid=0, prompt=np.zeros(8, np.int32),
                        max_new_tokens=2)])
    with pytest.raises(ValueError, match="max_len") as want:
        js.Engine(jcfg, jparams, max_batch=1, max_len=8,
                  kv_layout="dense").run(
            [js.Request(rid=0, prompt=np.zeros(8, np.int32),
                        max_new_tokens=2)])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(kv_layout="ring"), dict(max_queue_depth=0),
    dict(page_watermark=1.5), dict(request_timeout_s=-1.0),
    dict(degrade_to="draft"), dict(ttft_target_s=0.5)])
def test_engine_value_errors_match_jax(kw):
    jcfg, cfg = _configs()
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError) as want:
        js.Engine(jcfg, jparams, **kw)
    with pytest.raises(ValueError) as got:
        ts.Engine(cfg, params, **kw)
    assert str(got.value) == str(want.value)


def test_engine_queue_depth_and_timeouts_match_jax(tmp_path):
    """The queue-level sheds run on the dense layout: newest visible
    requests beyond ``max_queue_depth`` shed at once; a zero timeout sheds
    nothing that is admitted in the step it becomes visible."""
    jcfg, cfg, jparams, params, _, _ = _model(False, tmp_path)

    def mk(R):
        return [R(rid=i, prompt=np.arange(3 + i) % cfg.vocab,
                  max_new_tokens=2, arrival_step=i // 3) for i in range(7)]
    jres, jstats, tres, tstats = _run_both(
        jcfg, cfg, jparams, params, None, None, mk, max_batch=2,
        max_len=16, max_queue_depth=1)
    _assert_same_run(jres, jstats, tres, tstats)
    shed = [r.rid for r in tres if isinstance(r, ts.ShedResult)]
    assert shed == [r.rid for r in jres if isinstance(r, js.ShedResult)]
    assert shed and tstats["shed_requests"] == len(shed)
    assert ts.summarize(tres, 1.0)["shed_reasons"] == {"queue_depth":
                                                       len(shed)}


def _margins(cfg, params, backend, prompt, tokens, max_len):
    """Top-2 logit margins of the port serving ``prompt`` alone, with the
    given tokens fed back, at every generated step."""
    P = len(prompt)
    padded = -(-P // 512) * 512 if P > T.CHUNKED_ABOVE else P
    x = torch.zeros((1, padded), dtype=torch.long)
    x[0, :P] = torch.from_numpy(prompt)
    caches = T.init_cache(cfg, 1, max_len, device="cpu")
    out = []
    with _backend.use(backend):
        logits, caches = T.prefill(params, cfg, x, caches,
                                   lengths=torch.tensor([P]))
        for i, tok in enumerate(tokens):
            top2 = torch.topk(logits[0], 2).values
            out.append(float(top2[0] - top2[1]))
            if i + 1 < len(tokens):
                logits, caches = T.decode_step(params, cfg,
                                               torch.tensor([tok]), caches,
                                               P + i)
    return np.array(out)


def test_engine_long_prompt_matches_jax_under_the_margin_rule(tmp_path):
    """A 2100-token prompt beside a short one in a 3072-slot pool: the
    admission group prefills at P 3072 through the chunked attention in
    both packages (its float sums differ in order), then decodes."""
    jcfg, cfg, jparams, params, jbackend, backend = _model(True, tmp_path)
    rng = np.random.default_rng(21)

    def mk(R):
        return [R(rid="long", prompt=rng_prompts[0], max_new_tokens=4),
                R(rid="short", prompt=rng_prompts[1], max_new_tokens=4)]
    rng_prompts = [rng.integers(0, cfg.vocab, size=n) for n in (2100, 7)]
    jres, jstats, tres, tstats = _run_both(
        jcfg, cfg, jparams, params, jbackend, backend, mk, max_batch=2,
        max_len=3072)
    assert tstats["prefill_calls"] == jstats["prefill_calls"] == 1
    assert tstats["decode_steps"] == jstats["decode_steps"] == 3
    compared = total = 0
    for a, b, prompt in zip(jres, tres, rng_prompts):
        assert b.finish_reason == a.finish_reason == "max_new_tokens"
        margins = _margins(cfg, params, backend, prompt, b.tokens, 3072)
        low = np.flatnonzero(margins < 1e-3)
        upto = int(low[0]) if low.size else len(b.tokens)
        assert b.tokens[:upto] == [int(t) for t in a.tokens[:upto]], b.rid
        compared += upto
        total += len(b.tokens)
    assert compared >= total // 2


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

def _logit_rows(n=6, vocab=32, seed=0):
    return np.random.default_rng(seed).normal(size=(n, vocab)).astype(
        np.float32) * 1.5


@pytest.mark.parametrize("top_p", [0.3, 0.6, 0.9])
def test_top_p_keeps_the_tokens_jax_keeps(top_p):
    """The nucleus the port keeps equals the rule's float64 evaluation on
    these logits, and it is exactly the set JAX's sampler draws from: 4096
    draws per row never leave it and reach every kept token (the smallest
    kept probability here is above 0.4 %, so a miss has odds below
    1e-7)."""
    logits = _logit_rows()
    kept = torch.isfinite(tsampling.top_p_filter(torch.from_numpy(logits),
                                                 top_p)).numpy()
    for row, keep in zip(logits.astype(np.float64), kept):
        order = np.argsort(-row)
        p = np.exp(row[order] - row[order].max())
        p /= p.sum()
        want = np.zeros_like(keep)
        want[order[(np.cumsum(p) - p) < top_p]] = True
        np.testing.assert_array_equal(keep, want)
    n = 4096
    rows = jnp.asarray(np.repeat(logits, n, axis=0))
    keys = jax.random.split(jax.random.PRNGKey(7), rows.shape[0])
    toks, _ = j_sample(rows, keys, js.SamplingParams(top_p=top_p))
    toks = np.asarray(toks).reshape(len(logits), n)
    for row, keep in zip(toks, kept):
        drawn = np.zeros_like(keep)
        drawn[row] = True
        np.testing.assert_array_equal(drawn, keep)


def test_sample_tokens_draws_from_the_distribution_and_is_greedy_at_tiny_p():
    logits = torch.from_numpy(_logit_rows(2, 8, seed=3))
    params = ts.SamplingParams(temperature=0.7, top_p=1.0, seed=0)
    gens = [tsampling.request_generator(0, i, "cpu") for i in range(2)]
    draws = torch.stack([tsampling.sample_tokens(logits, gens, params)
                         for _ in range(4000)])
    probs = torch.softmax(logits / 0.7, dim=-1)
    for b in range(2):
        freq = torch.bincount(draws[:, b], minlength=8).double() / 4000
        assert float((freq - probs[b].double()).abs().max()) < 0.03
    tiny = ts.SamplingParams(top_p=1e-9)
    assert torch.equal(tsampling.sample_tokens(logits, gens, tiny),
                       torch.argmax(logits, dim=-1))
    with pytest.raises(ValueError, match="temperature"):
        ts.SamplingParams(temperature=0.0)
    with pytest.raises(ValueError, match="top_p"):
        ts.SamplingParams(top_p=1.5)


def test_engine_sampling_is_seed_deterministic_and_batch_independent(
        tmp_path):
    """Same seed, same tokens; another seed, other tokens; and each
    request's stream is the same alone (one slot) as in a batch of three
    (static scales, so its logits do not depend on its neighbours)."""
    _, cfg, _, params, _, backend = _model(True, tmp_path)
    reqs = _mixed(ts.Request, cfg.vocab, seed=13)
    for r in reqs:
        r.arrival_step = 0

    def run(seed, max_batch):
        eng = ts.Engine(cfg, params, max_batch=max_batch, max_len=20,
                        backend=backend, kv_layout="dense",
                        sampling=ts.SamplingParams(temperature=1.5,
                                                   top_p=0.9, seed=seed))
        return [r.tokens for r in eng.run(reqs)]
    first = run(3, 3)
    assert run(3, 3) == first
    assert run(4, 3) != first
    assert run(3, 1) == first
    greedy = ts.Engine(cfg, params, max_batch=3, max_len=20,
                       backend=backend, kv_layout="dense").run(reqs)
    assert [r.tokens for r in greedy] != first


# --------------------------------------------------------------------------
# the serve CLI
# --------------------------------------------------------------------------

_CLI = ["--arch", "yi-9b", "--reduce", "--device", "cpu", "--engine",
        "--requests", "4", "--prompt-len", "16", "--gen-len", "4"]


@pytest.mark.parametrize("mapped", [False, True])
def test_serve_cli_engine_prints_requests_and_summary(mapped, tmp_path,
                                                      capsys):
    args = list(_CLI)
    if mapped:
        from repro_torch.launch.train import emit_static_mapping
        cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
        params = T.init_lm(torch.Generator().manual_seed(0), cfg)
        emit_static_mapping(params, cfg, "diana", tmp_path / "m.json",
                            max_cout=64, act_log_scale=2.0)
        args += ["--mapping", str(tmp_path / "m.json"),
                 "--require-full-coverage", "--poisson", "0.5"]
    results, summ = serve.main(args)
    out = capsys.readouterr().out
    assert len(results) == 4 and summ["completed"] == 4
    for r in results:
        assert f"[serve]  {r.rid}: prompt={r.prompt_len} gen={r.n_tokens}" \
            in out
    assert "[serve] engine[continuous] B=4" in out
    assert f"{summ['total_tokens']} tokens" in out
    if mapped:
        assert "per-layer planned execution" in out
        assert "open-loop arrivals: Poisson at 0.5" in out
        assert max(r.admitted_step for r in results) > 0


def test_serve_cli_engine_takes_its_robustness_and_sampling_flags(capsys):
    results, summ = serve.main(_CLI + [
        "--policy", "deadline", "--priorities", "0,1", "--deadlines-ms",
        "none,50", "--max-queue-depth", "1", "--request-timeout", "60",
        "--temperature", "0.8", "--top-p", "0.9", "--max-batch", "2",
        "--kv-layout", "dense"])
    out = capsys.readouterr().out
    assert summ["requests"] == 4 and summ["shed"] >= 1
    assert "[serve] robustness: preemptions=0 resumes=0 sheds=" in out
    assert "SHED (queue_depth)" in out


#: the multi-plan and robustness arguments of the JAX engine that it
#: refuses, each on its own; "bank" stands for a two-variant PlanSet
#: (draft, target), "deadline" for a preempting scheduler
MULTIPLAN_ERRORS = [
    dict(speculate="draft", backend="bank"),
    dict(speculate=("draft", "target"), backend="bank", kv_layout="dense"),
    dict(speculate=("draft", "target"), backend="bank", sampling=True),
    dict(speculate=("draft", "target"), backend="bank",
         slo_routes={"x": "draft"}),
    dict(speculate=("draft", "target"), backend="bank", draft_k=0),
    dict(speculate=("tiny", "target"), backend="bank"),
    dict(speculate=("draft", "target")),
    dict(slo_routes={"gold": "nope"}, backend="bank"),
    dict(slo_routes={"gold": "draft"}, backend="bank", kv_layout="dense"),
    dict(slo_routes={"gold": "draft"}),
    dict(degrade_to="draft", ttft_target_s=0.5, backend="bank",
         kv_layout="dense"),
    dict(degrade_to="draft", ttft_target_s=0.5),
    dict(degrade_to="cheap", ttft_target_s=0.5, backend="bank"),
    dict(degrade_to="draft", ttft_target_s=0.0, backend="bank"),
    dict(degrade_to="draft", ttft_target_s=0.5, backend="bank",
         degrade_recover_frac=1.5),
    dict(injector=True, kv_layout="dense"),
    dict(speculate=("draft", "target"), backend="bank", injector=True),
    dict(speculate=("draft", "target"), backend="bank",
         degrade_to="draft", ttft_target_s=0.5),
    dict(speculate=("draft", "target"), backend="bank",
         scheduler="deadline"),
]


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    """(jcfg, cfg, jparams, params, JAX bank, port bank): reduced yi-9b and
    two-variant banks (target: diana, draft: all-ternary diana)."""
    jcfg, cfg = _configs()
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    d = tmp_path_factory.mktemp("bank")
    arts = {v: j_emit(jparams, jcfg, "diana", d / f"{v}.json", max_cout=64,
                      act_log_scale=2.0, bias=bias)
            for v, bias in (("target", None), ("draft", ("aimc", 1.0)))}
    jbank = jrt.PlanSet({v: jrt.lower(a, params=jparams)
                         for v, a in arts.items()}, jparams,
                        default="target", reference=True)
    bank = rt.PlanSet({v: rt.lower(a.to_dict(), params=params)
                       for v, a in arts.items()}, params, default="target")
    return jcfg, cfg, jparams, params, jbank, bank


@pytest.mark.parametrize("kw", MULTIPLAN_ERRORS,
                         ids=[str(i) for i in range(len(MULTIPLAN_ERRORS))])
def test_engine_multiplan_value_errors_match_jax(banks, kw):
    """Every multi-plan and robustness refusal of the JAX engine is the
    port's, word for word."""
    jcfg, cfg, jparams, params, jbank, bank = banks

    def args(m, bank_):
        out = dict(kw, max_batch=2, max_len=64)
        if out.get("backend") == "bank":
            out["backend"] = bank_
        if out.get("sampling"):
            out["sampling"] = m.SamplingParams(temperature=1.0)
        if out.get("injector"):
            out["injector"] = m.FaultInjector()
        if "scheduler" in out:
            out["scheduler"] = m.Scheduler(out["scheduler"])
        return out
    with pytest.raises(ValueError) as want:
        js.Engine(jcfg, jparams, **args(js, jbank))
    with pytest.raises(ValueError) as got:
        ts.Engine(cfg, params, **args(ts, bank))
    assert str(got.value) == str(want.value)


#: serve flags each refused by the JAX CLI's argument checks
CLI_ERRORS = [
    ["--engine", "--degrade-to", "a"],
    ["--engine", "--degrade-to", "a", "--ttft-target-s", "1"],
    ["--engine", "--ttft-target-s", "0.5"],
    ["--speculate", "d.json"],
    ["--engine", "--speculate", "d.json"],
    ["--engine", "--mapping", "m.json", "--mapping-fallback",
     "--speculate", "d.json"],
    ["--engine", "--mapping", "m.json", "--speculate", "d.json",
     "--slo-variant", "a=d.json"],
    ["--engine", "--mapping", "m.json", "--slo-variant", "a:d.json"],
    ["--fault-spec", "stuck@1:0"],
]


@pytest.mark.parametrize("flags", CLI_ERRORS,
                         ids=[str(i) for i in range(len(CLI_ERRORS))])
def test_serve_cli_multiplan_errors_match_jax(flags, capsys):
    """The multi-plan flags' argparse errors are the JAX CLI's, word for
    word (the usage lines list each CLI's own flags)."""
    from repro.launch import serve as jserve
    argv = ["--arch", "yi-9b", "--reduce"] + flags
    msgs = []
    for main in (jserve.main, serve.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[1] == msgs[0] and "error: " in msgs[0]


def test_serve_cli_robustness_flags_need_engine():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "yi-9b", "--reduce", "--device", "cpu",
                    "--poisson", "0.5"])
