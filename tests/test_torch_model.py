"""The port's attention-only LM against the JAX package on a reduced
yi-9b whose parameters are the JAX package's, imported through numpy:
prefill and decode logits, fp and planned on each mapping the port serves
(diana, gpu_tc_like, and diana biased all-ternary), and greedy serving.

The JAX planned runs use the JAX package's plain oracles
(``PlannedBackend(reference=True)``), the port's run on the CPU uses its
kernels' plain versions; both contract integers exactly, so what differs
is the float arithmetic around the matmuls -- and, on gpu_tc_like, the
float32 sum of split_precision's bf16 columns, which the JAX oracle takes
in float32 and the port's plain version in float64 (rounded once).

Reduced yi-9b's searchable layers have 64 output columns; at the default
N-block (128) the aligned boundary swallows them all, so gpu_tc_like is
lowered with ``bn=16`` in both packages (16 bf16 columns per wk/wv layer),
the only way the reduced model reaches the bf16 half."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.configs import base as jcfgbase  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.managed import matmul_backend  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import _backend  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

B, P, STEPS = 2, 8, 3


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(param_dtype, kv="bfloat16"):
    jcfgbase.load_all()
    over = dict(param_dtype=param_dtype, kv_cache_dtype=kv)
    jcfg = dataclasses.replace(
        jcfgbase.reduce_for_smoke(jcfgbase.get("yi-9b")), **over)
    cfg = dataclasses.replace(
        cfgbase.reduce_for_smoke(cfgbase.get("yi-9b")), **over)
    return jcfg, cfg


def _params(jcfg):
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return jparams, T.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      "cpu")


def _prompts(vocab):
    return np.random.default_rng(1).integers(0, vocab, (B, P),
                                             dtype=np.int32)


#: mapping -> (platform, emission bias, lowering tuning, kernel histogram)
MAPPINGS = {
    "diana": ("diana", None, None,
              {"quant_matmul": 5, "split_ternary": 10}),
    "gpu_tc_like": ("gpu_tc_like", None, {"*": {"bn": 16}},
                    {"quant_matmul": 5, "split_precision": 10}),
    "ternary": ("diana", ("aimc", 1.0), None,
                {"quant_matmul": 5, "ternary_matmul": 10}),
}


def _planned(jcfg, jparams, params, tmp_path, mapping="diana"):
    plat, bias, tuning, hist = MAPPINGS[mapping]
    art = j_emit(jparams, jcfg, plat, tmp_path / "m.json", max_cout=64,
                 act_log_scale=2.0, bias=bias)
    jplan = jrt.lower(art, params=jparams, tuning=tuning)
    plan = rt.lower(art.to_dict(), params=params, tuning=tuning)
    assert plan.kernel_histogram() == hist
    return (jrt.PlannedBackend(jplan, jparams, reference=True),
            rt.PlannedBackend(plan, params))


def _logits_both(jcfg, cfg, jparams, params, jbackend=None, backend=None):
    """Prefill + STEPS teacher-forced decode steps in both packages;
    returns the per-step logits (JAX, port)."""
    prompts = _prompts(cfg.vocab)
    jc = JT.init_cache(jcfg, B, P + STEPS)
    tc = T.init_cache(cfg, B, P + STEPS, device="cpu")
    jout, tout = [], []
    with matmul_backend(jbackend), _backend.use(backend):
        jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(prompts), jc)
        tl, tc = T.prefill(params, cfg, torch.from_numpy(prompts).long(),
                           tc)
        jout.append(np.asarray(jl))
        tout.append(tl.numpy())
        for i in range(STEPS):
            tok = np.argmax(jout[-1], -1)
            jl, jc = JT.decode_step(jparams, jcfg, jnp.asarray(tok), jc,
                                    P + i)
            tl, tc = T.decode_step(params, cfg, torch.from_numpy(tok), tc,
                                   P + i)
            jout.append(np.asarray(jl))
            tout.append(tl.numpy())
    return jout, tout


def test_params_from_jax_keeps_pytree_paths():
    jcfg, cfg = _configs("bfloat16")
    jparams, params = _params(jcfg)
    w = params["units"][0]["attn"]["wq"]["w"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (2, 64, 64)
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(jparams["units"][0]["attn"]["wq"]["w"], np.float32))
    g = torch.Generator(device="cpu").manual_seed(0)
    fresh = T.init_lm(g, cfg)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, fresh)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, jparams))


def test_fp_logits_match_jax_float32():
    """float32 parameters with the int8 KV cache.  The JAX package keeps a
    bfloat16 KV cache for float32 parameters; rounding k/v to bfloat16
    turns a last-bit difference of the two frameworks' float32 matmuls
    into a bf16 step now and then (7e-4 at one decode step of this model),
    so the bf16 cache is held in the bfloat16 test below instead."""
    jcfg, cfg = _configs("float32", kv="int8")
    jparams, params = _params(jcfg)
    jout, tout = _logits_both(jcfg, cfg, jparams, params)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)


def test_planned_diana_logits_match_jax_float32(tmp_path):
    jcfg, cfg = _configs("float32", kv="int8")
    jparams, params = _params(jcfg)
    jbackend, backend = _planned(jcfg, jparams, params, tmp_path)
    jout, tout = _logits_both(jcfg, cfg, jparams, params, jbackend, backend)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mapping", ["gpu_tc_like", "ternary"])
def test_planned_new_mappings_logits_match_jax_float32(mapping, tmp_path):
    """float32 parameters, int8 KV cache (the KV dtype both artifacts ask
    for).  The ternary mapping is all-integer around its matmuls like
    diana: atol 1e-4 as there.  gpu_tc_like adds split_precision's bf16
    columns, whose float32 sums differ from the float64 ones by at most
    K * 2**-24 * sum |x w| (about 4e-6 relative at K = 64); the same
    atol 1e-4 holds with room for that."""
    jcfg, cfg = _configs("float32", kv="int8")
    jparams, params = _params(jcfg)
    jbackend, backend = _planned(jcfg, jparams, params, tmp_path, mapping)
    jout, tout = _logits_both(jcfg, cfg, jparams, params, jbackend, backend)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)


def test_fp_logits_match_jax_bfloat16():
    """bf16 parameters, activations and KV cache: the two frameworks round
    to bf16 at different places (fused vs separate ops), so logits, which
    reach |3.5| here, agree to 4 bf16 steps at magnitude [2, 4): atol
    6.25e-2, with a mean difference under 1.25e-2."""
    jcfg, cfg = _configs("bfloat16")
    jparams, params = _params(jcfg)
    jout, tout = _logits_both(jcfg, cfg, jparams, params)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, rtol=0, atol=6.25e-2)
        assert float(np.abs(t - j).mean()) < 1.25e-2


def _margins(cfg, params, prompts, tokens, backend):
    """Top-2 logit margin of the port at every generated step, with the
    given tokens fed back (teacher forcing)."""
    caches = T.init_cache(cfg, B, P + tokens.shape[1], device="cpu")
    out = []
    with _backend.use(backend):
        logits, caches = T.prefill(params, cfg, prompts, caches)
        for i in range(tokens.shape[1]):
            top2 = torch.topk(logits, 2, dim=-1).values
            out.append((top2[:, 0] - top2[:, 1]).numpy())
            if i + 1 < tokens.shape[1]:
                logits, caches = T.decode_step(params, cfg, tokens[:, i],
                                               caches, P + i)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("planned", [False, True])
def test_serve_batch_greedy_tokens_match_jax(planned, tmp_path):
    _greedy_tokens_match_jax("diana" if planned else None, tmp_path)


@pytest.mark.parametrize("mapping", ["gpu_tc_like", "ternary"])
def test_serve_batch_greedy_tokens_match_jax_new_mappings(mapping,
                                                          tmp_path):
    """float32 parameters: there the planned logits of the two packages
    agree within 1e-4 (test above), so a top-2 margin of 1e-3 decides the
    same token in both.  With bf16 parameters the two frameworks' planned
    logits differ by up to 0.19 on this model (a bf16 rounding difference
    flips an int8 activation code), more than some top-2 margins, and the
    1e-3 margin rule would not be sound."""
    _greedy_tokens_match_jax(mapping, tmp_path, "float32")


def _greedy_tokens_match_jax(mapping, tmp_path, dtype="bfloat16"):
    """Greedy tokens equal the JAX package's (engine-backed) serve_batch.
    Each row is compared up to its first step whose top-2 logit margin is
    below 1e-3: there the two frameworks' rounding may pick either token,
    and everything after follows from that pick."""
    gen_len = 6
    jcfg, cfg = _configs(dtype, kv="int8" if mapping else "bfloat16")
    jparams, params = _params(jcfg)
    jbackend = backend = None
    if mapping:
        jbackend, backend = _planned(jcfg, jparams, params, tmp_path,
                                     mapping)
    prompts = _prompts(cfg.vocab)
    jtok, _ = jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts),
                                 gen_len, backend=jbackend)
    tprompts = torch.from_numpy(prompts).long()
    tok, stats = serve.serve_batch(cfg, params, tprompts, gen_len,
                                   backend=backend)
    assert tuple(tok.shape) == (B, gen_len)
    margins = _margins(cfg, params, tprompts, tok, backend)
    compared = 0
    for row in range(B):
        low = np.flatnonzero(margins[row] < 1e-3)
        upto = int(low[0]) if low.size else gen_len
        np.testing.assert_array_equal(tok[row, :upto].numpy(),
                                      np.asarray(jtok)[row, :upto])
        compared += upto
    assert compared >= B * gen_len // 2
