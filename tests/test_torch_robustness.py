"""The port's robustness layer over a precision bank and under injected
faults (``repro_torch.serving.faults``, ``repro_torch.distributed``, the
engine's fault containment and precision degradation) against the JAX
package's on the same inputs.

Mechanics with no model: `FaultEvent` / `FaultInjector` (``parse`` and
``draw``: the same events for the same spec and seed), the heartbeat
monitor and the straggler policy, and the degradation controller's
hysteresis give what the JAX package's give.  Engine runs on reduced
yi-9b with float32 parameters carried across by ``T.params_from_jax``
and the default bf16 KV cache (so a corrupted page holds NaN): each fault
kind is detected, contained and requeued with the JAX engine's tokens and
stats (and a clean run's tokens); a second fault sheds; a corrupted page
is purged from the prefix cache; degradation switches the same requests
to the cheap variant at the same step as JAX's."""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro import serving as js  # noqa: E402
from repro.configs import base as jcfgbase  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import _DegradeController as JDegrade  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch import serving as ts  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.distributed import fault_tolerance as tft  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import _DegradeController  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# mechanics: injector, monitors, degradation controller
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec,seed", [
    ("nonfinite_logits@3:0, stuck@5:1x20, corrupt_page~0.25", 7),
    ("corrupt_page@2:1,nonfinite_logits~0.1,stuck~0.05", 0),
    ("stuck@0:0x3,stuck@4:2", 11)])
def test_fault_injector_parse_and_draw_match_jax(spec, seed):
    """The same spec and seed give the same events, rates and draws."""
    got, want = ts.FaultInjector.parse(spec, seed), \
        js.FaultInjector.parse(spec, seed)
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]
    assert got.rates == want.rates
    for step in range(40):
        slots = [s for s in range(3) if (step + s) % 4]
        assert [dataclasses.astuple(e) for e in got.draw(step, slots)] == \
            [dataclasses.astuple(e) for e in want.draw(step, slots)]
    assert got.fired == want.fired


@pytest.mark.parametrize("make", [
    lambda m: m.FaultEvent("meteor", 0, 0),
    lambda m: m.FaultEvent("stuck", -1, 0),
    lambda m: m.FaultEvent("stuck", 0, 0, duration=0),
    lambda m: m.FaultInjector.parse("nonfinite_logits@oops"),
    lambda m: m.FaultInjector.parse("meteor@1:0"),
    lambda m: m.FaultInjector(rates={"meteor": 0.1})])
def test_fault_errors_match_jax(make):
    with pytest.raises(ValueError) as want:
        make(js)
    with pytest.raises(ValueError) as got:
        make(ts)
    assert str(got.value) == str(want.value)


def test_heartbeat_and_straggler_match_jax():
    """The step-clock monitor and the EMA straggler policy, driven by the
    same beats and step times, flag the same hosts and steps."""
    clock = [0.0]
    got = tft.HeartbeatMonitor([0, 1, 2], deadline_s=3.0,
                               clock=lambda: clock[0])
    want = jft.HeartbeatMonitor([0, 1, 2], deadline_s=3.0,
                                clock=lambda: clock[0])
    for step in range(12):
        clock[0] = float(step)
        for mon in (got, want):
            mon.beat(step % 3 if step < 6 else 0)
        assert got.dead_hosts() == want.dead_hosts()
        assert got.all_alive() == want.all_alive()
    rng = np.random.default_rng(4)
    times = rng.uniform(0.5, 1.5, 60) * np.where(rng.random(60) < 0.15, 4,
                                                 1)
    got, want = tft.StragglerPolicy(), jft.StragglerPolicy()
    assert [got.observe(i, t) for i, t in enumerate(times)] == \
        [want.observe(i, t) for i, t in enumerate(times)]
    assert got.events == want.events and got.ema == want.ema


def test_degrade_controller_hysteresis_matches_jax():
    """Degrade on a p95 breach, stay (the window cleared), recover below
    the hysteresis fraction, over the same TTFT stream as JAX's."""
    ttfts = [5.0] * 4 + [0.1] * 4 + [2.0, 0.9, 3.0, 0.2] * 3 + [0.01] * 6
    got = _DegradeController(target_s=1.0, window=8, min_samples=4,
                             recover_frac=0.5)
    want = JDegrade(target_s=1.0, window=8, min_samples=4, recover_frac=0.5)
    for step, t in enumerate(ttfts):
        got.observe(t)
        want.observe(t)
        assert got.update(step) == want.update(step)
    assert got.transitions == want.transitions
    assert [k for _, k, _ in got.transitions][:2] == ["degrade", "recover"]
    got.reset()
    assert not got.transitions and not got.active


@pytest.mark.parametrize("kw", [dict(target_s=0.0),
                                dict(target_s=1.0, recover_frac=1.5)])
def test_degrade_controller_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        JDegrade(**kw)
    with pytest.raises(ValueError) as got:
        _DegradeController(**kw)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# the engine under injected faults, against the JAX engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def yi():
    jcfgbase.load_all()
    over = dict(param_dtype="float32")
    jcfg = dataclasses.replace(
        jcfgbase.reduce_for_smoke(jcfgbase.get("yi-9b")), **over)
    cfg = dataclasses.replace(
        cfgbase.reduce_for_smoke(cfgbase.get("yi-9b")), **over)
    assert cfg.kv_cache_dtype == "bfloat16"
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _mk_reqs(R, vocab, spec):
    """spec: [(rid, plen, new, arrival), ...] with seed-deterministic
    prompts (same rid -> same prompt)."""
    out = []
    for rid, plen, new, arrival in spec:
        rng = np.random.default_rng(zlib.crc32(str(rid).encode()))
        out.append(R(rid=rid, prompt=rng.integers(0, vocab, plen),
                     max_new_tokens=new, arrival_step=arrival))
    return out


#: the stats a fault run must share with the JAX engine's (the straggler
#: count follows wall times, which differ)
_FAULT_STATS = ("faults_injected", "faults_detected", "heartbeat_trips",
                "shed_requests", "resumes", "decode_steps", "prefill_calls",
                "preemptions", "degrade_transitions", "prefix_hit_tokens")


def _both(yi, spec, events=None, **kw):
    """The port's and the JAX engine's runs of ``spec``; ``events``
    [(kind, step, slot, duration)] arm one injector each."""
    jcfg, cfg, jparams, params = yi
    out = []
    for m, c, p in ((ts, cfg, params), (js, jcfg, jparams)):
        inj = (m.FaultInjector(events=[m.FaultEvent(*e) for e in events])
               if events is not None else None)
        eng = m.Engine(c, p, injector=inj, **kw)
        out.append((eng, eng.run(_mk_reqs(m.Request, c.vocab, spec)), inj))
    return out


def _assert_same(got, want):
    (eng, res, inj), (jeng, jres, jinj) = got, want
    for a, b in zip(res, jres):
        assert type(a).__name__ == type(b).__name__, (a, b)
        if isinstance(a, ts.ShedResult):
            assert (a.rid, a.reason, a.shed_step) == \
                (b.rid, b.reason, b.shed_step)
            continue
        assert (a.rid, a.tokens, a.finish_reason, a.requeues,
                a.admitted_step, a.finished_step) == \
            (b.rid, [int(t) for t in b.tokens], b.finish_reason, b.requeues,
             b.admitted_step, b.finished_step)
    for key in _FAULT_STATS:
        assert eng.stats[key] == jeng.stats[key], key
    if inj is not None:
        assert inj.fired == jinj.fired


def _clean_tokens(yi, rid="f0", new=10):
    _, cfg, _, params = yi
    eng = ts.Engine(cfg, params, max_batch=1, max_len=48, page_size=8)
    [r] = eng.run(_mk_reqs(ts.Request, cfg.vocab, [(rid, 8, new, 0)]))
    return r.tokens


@pytest.mark.parametrize("kind", ["nonfinite_logits", "corrupt_page",
                                  "stuck"])
def test_fault_contained_requeued_like_jax(yi, kind):
    """Each kind is detected (the logit screen, or the heartbeat for a
    stuck slot), the slot quarantined and the request requeued once; the
    final tokens equal a clean run's and the JAX engine's, as do the
    stats."""
    got, want = _both(yi, [("f0", 8, 10, 0)], [(kind, 4, 0, 100)],
                      max_batch=1, max_len=48, page_size=8,
                      heartbeat_steps=4)
    _assert_same(got, want)
    eng, (r,), inj = got
    assert isinstance(r, ts.RequestResult) and r.requeues == 1
    assert eng.stats["faults_injected"] == 1
    if kind == "stuck":
        assert eng.stats["heartbeat_trips"] >= 1
    else:
        assert eng.stats["faults_detected"] >= 1
    assert r.tokens == _clean_tokens(yi)
    assert inj.fired == [(4, 0, kind)]


def test_double_fault_sheds_like_jax(yi):
    got, want = _both(yi, [("d0", 8, 10, 0)],
                      [("nonfinite_logits", 3, 0, 1),
                       ("nonfinite_logits", 8, 0, 1)],
                      max_batch=1, max_len=48, page_size=8,
                      quarantine_steps=1)
    _assert_same(got, want)
    eng, (r,), _ = got
    assert isinstance(r, ts.ShedResult) and r.reason == "fault"
    assert eng.stats["faults_detected"] == 2
    assert eng.stats["shed_requests"] == 1


def test_faults_across_slots_and_prefix_purge_like_jax(yi):
    """Four requests, two slots, the prefix cache on and a shared prompt:
    a corrupted page, a NaN and a stuck slot on occupied slots; every
    request finishes with a clean run's tokens or is shed, as JAX's."""
    jcfg, cfg, jparams, params = yi
    spec = [("p0", 16, 6, 0), ("p1", 16, 6, 0), ("p2", 9, 8, 1),
            ("p3", 12, 5, 2)]
    events = [("corrupt_page", 3, 0, 1), ("nonfinite_logits", 5, 1, 1),
              ("stuck", 9, 0, 40)]
    kw = dict(max_batch=2, max_len=48, page_size=8, heartbeat_steps=3)
    jcfg, cfg, jparams, params = yi
    out = []
    for m, c, p in ((ts, cfg, params), (js, jcfg, jparams)):
        reqs = _mk_reqs(m.Request, c.vocab, spec)
        reqs[1].prompt = reqs[0].prompt.copy()     # a shared prompt
        inj = m.FaultInjector(events=[m.FaultEvent(*e) for e in events])
        eng = m.Engine(c, p, injector=inj, **kw)
        out.append((eng, eng.run(reqs), inj))
    _assert_same(*out)
    eng, res, _ = out[0]
    assert eng.stats["faults_detected"] >= 2
    clean = ts.Engine(cfg, params, **kw)
    reqs = _mk_reqs(ts.Request, cfg.vocab, spec)
    reqs[1].prompt = reqs[0].prompt.copy()
    want = {r.rid: r.tokens for r in clean.run(reqs)}
    for r in res:
        assert (isinstance(r, ts.ShedResult) and r.reason == "fault") or \
            r.tokens == want[r.rid]


def test_corrupted_page_purged_from_prefix_cache_like_jax(yi):
    """After a corrupt_page fault the slot's pages are not matchable: the
    second identical prompt prefills from scratch and both requests get
    a clean run's tokens."""
    jcfg, cfg, jparams, params = yi
    spec = [("p0", 16, 6, 0), ("p1", 16, 6, 0)]
    out = []
    for m, c, p in ((ts, cfg, params), (js, jcfg, jparams)):
        r0, r1 = _mk_reqs(m.Request, c.vocab, spec)
        r1.prompt = r0.prompt.copy()
        inj = m.FaultInjector(events=[m.FaultEvent("corrupt_page", 4, 0)])
        eng = m.Engine(c, p, max_batch=1, max_len=48, page_size=8,
                       injector=inj)
        out.append((eng, eng.run([r0, r1]), inj))
    _assert_same(*out)
    r0, _ = _mk_reqs(ts.Request, cfg.vocab, spec)
    clean = ts.Engine(cfg, params, max_batch=1, max_len=48, page_size=8)
    ref = clean.run([ts.Request(rid=s[0], prompt=r0.prompt.copy(),
                                max_new_tokens=6) for s in spec])
    assert [r.tokens for r in out[0][1]] == [r.tokens for r in ref]


def test_degradation_routes_and_pins_variants_like_jax(yi, tmp_path):
    """With a 2-variant bank and an unreachable TTFT target the engine
    flips new admissions to the cheap variant after ``degrade_window``
    first tokens, at the same step as JAX's; degraded requests carry
    ``variant="cheap"`` and the cheap variant's tokens, the others the
    default's, and the transitions and per-request variants equal JAX's."""
    jcfg, cfg, jparams, params = yi
    arts = {v: j_emit(jparams, jcfg, "diana", tmp_path / f"{v}.json",
                      act_log_scale=2.0, bias=bias)
            for v, bias in (("default", ("digital", 1.0)),
                            ("cheap", ("aimc", 1.0)))}
    jbank = jrt.PlanSet({v: jrt.lower(a, params=jparams)
                         for v, a in arts.items()}, jparams,
                        default="default", reference=True)
    bank = rt.PlanSet({v: rt.lower(a.to_dict(), params=params)
                       for v, a in arts.items()}, params, default="default")
    kw = dict(n=8, seed=4, min_prompt=4, max_prompt=8, min_new=3,
              max_new=6, arrival_every=2)
    n = kw.pop("n")
    eng_kw = dict(max_batch=2, max_len=48, page_size=8, degrade_to="cheap",
                  ttft_target_s=1e-9, degrade_window=4)
    eng = ts.Engine(cfg, params, backend=bank, **eng_kw)
    jeng = js.Engine(jcfg, jparams, backend=jbank, **eng_kw)
    assert not eng.prefix_cache and not jeng.prefix_cache
    trace = ts.synthetic_trace(n, vocab=cfg.vocab, **kw)
    res = eng.run(trace)
    jres = jeng.run(js.synthetic_trace(n, vocab=cfg.vocab, **kw))
    assert [(s, k) for s, k, _ in eng.degrade_log] == \
        [(s, k) for s, k, _ in jeng.degrade_log]
    assert eng.stats["degrade_transitions"] == \
        jeng.stats["degrade_transitions"] >= 1
    assert eng.degrade_log[0][1] == "degrade"
    assert [(r.rid, r.tokens, r.variant, r.degraded) for r in res] == \
        [(r.rid, [int(t) for t in r.tokens], r.variant, r.degraded)
         for r in jres]
    degraded = [r for r in res if r.degraded]
    assert degraded and all(r.variant == "cheap" for r in degraded)
    assert all(r.variant is None for r in res if not r.degraded)
    summ = ts.summarize(res, eng.stats["wall_s"])
    assert summ["degrade_rate"] == js.summarize(
        jres, jeng.stats["wall_s"])["degrade_rate"] > 0
    for req, r in zip(trace, res):
        solo = rt.PlanSet({"v": bank.variant(
            "cheap" if r.degraded else "default").plan}, params)
        (alone,) = ts.Engine(cfg, params, max_batch=1, max_len=48,
                             page_size=8, backend=solo).run([req])
        assert alone.tokens == r.tokens, req.rid


def test_corrupt_page_detected_under_a_planned_bank(yi, tmp_path):
    """A planned head quantizes its input to int8, which would map the NaN
    of a corrupted KV page to a finite code; the port's logits carry the
    non-finite hidden row, so the fault is contained as on the fp path
    and the request ends with a clean run's tokens."""
    jcfg, cfg, jparams, params = yi
    art = j_emit(jparams, jcfg, "diana", tmp_path / "m.json", max_cout=64,
                 act_log_scale=2.0)
    bank = rt.PlanSet({"target": rt.lower(art.to_dict(), params=params)},
                      params)
    kw = dict(max_batch=1, max_len=48, page_size=8, backend=bank)
    spec = [("c0", 8, 10, 0)]
    (clean,) = ts.Engine(cfg, params, **kw).run(
        _mk_reqs(ts.Request, cfg.vocab, spec))
    inj = ts.FaultInjector(events=[ts.FaultEvent("corrupt_page", 4, 0)])
    eng = ts.Engine(cfg, params, injector=inj, **kw)
    (r,) = eng.run(_mk_reqs(ts.Request, cfg.vocab, spec))
    assert eng.stats["faults_detected"] == 1 and r.requeues == 1
    assert r.tokens == clean.tokens
