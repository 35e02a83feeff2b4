"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX package's
``repro.models.moe`` on the same numpy inputs: deepseek-v2-lite's reduced
MoE (8 experts top-2, d_ff 64, two shared experts) in float32.

Tolerances: ``y`` within 1e-5 and the load-balance aux within 1e-6 (float32,
the same operations; the expert einsums sum in other orders), the routed
experts and the kept (token, k) set of the capacity dispatch exactly
equal.  Top-k: exact ties pick the lower expert index in both packages.
Near-ties: the two frameworks' float32 ``exp`` may differ in the last bit
(ROADMAP Queue 3), so over many tokens the chosen experts may differ only
where JAX's two candidate probabilities lie within 4 float32 ulps; the
test counts such tokens and asserts that every mismatch is one."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.models import _backend  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

D = 64


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**over):
    moe = cfgbase.reduce_for_smoke(cfgbase.get("deepseek-v2-lite-16b")).moe
    return dataclasses.replace(moe, **over)


def _jcfg(cfg):
    return JM.MoEConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed=0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), D, _jcfg(cfg), jnp.float32)
    return jp, T.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _jax_routing(jp, x, cfg, G, mask=None):
    """JAX's dispatch of ``x`` (B, S, D), step for step as
    ``repro.models.moe.moe_ffn`` computes it: (top-k indices, keep)."""
    B, S, _ = x.shape
    Tg = B * S // G
    xt = jnp.asarray(x).reshape(G, Tg, D)
    probs = jax.nn.softmax(JL.dense(jp["router"], xt.astype(jnp.float32)),
                           axis=-1)
    _, topi = jax.lax.top_k(probs, cfg.top_k)
    onehot = jax.nn.one_hot(topi, cfg.n_experts, dtype=jnp.int32)
    if mask is not None:
        onehot = onehot * jnp.asarray(mask).reshape(G, Tg)[..., None, None]
    pos = jnp.cumsum(onehot.reshape(G, Tg * cfg.top_k, cfg.n_experts),
                     axis=1) - 1
    pos = jnp.sum(pos.reshape(onehot.shape) * onehot, axis=-1)
    keep = pos < JM._capacity(Tg, _jcfg(cfg))
    if mask is not None:
        keep = keep & jnp.asarray(mask).reshape(G, Tg)[..., None]
    return np.asarray(topi), np.asarray(keep), np.asarray(probs)


def _port_routing(p, x, cfg, G, mask=None):
    B, S, _ = x.shape
    xt = torch.from_numpy(x).reshape(G, B * S // G, D)
    probs = torch.softmax(xt @ p["router"]["w"], dim=-1)
    m = None if mask is None else torch.from_numpy(mask).reshape(xt.shape[:2])
    _, topi, _, _, keep, _ = M.dispatch(probs, cfg, m)
    if m is not None:
        keep = keep & m[..., None]
    return topi.numpy(), keep.numpy()


CASES = [(g, cf, masked) for g in (1, 2) for cf in (1.25, 0.5)
         for masked in (False, True)]


@pytest.mark.parametrize("n_groups,capacity_factor,masked", CASES)
def test_moe_ffn_matches_jax(n_groups, capacity_factor, masked):
    """y, aux, the routed experts and the kept (token, k) set; at capacity
    factor 0.5 tokens drop (asserted), and masked tokens take no place."""
    cfg = _cfg(capacity_factor=capacity_factor)
    jp, p = _params(cfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 24, D), dtype=np.float32)
    mask = (np.arange(24)[None, :] < np.array([24, 17, 0, 9])[:, None]) \
        if masked else None
    jy, jaux = JM.moe_ffn(jp, jnp.asarray(x), _jcfg(cfg), n_groups=n_groups,
                          length_mask=None if mask is None
                          else jnp.asarray(mask))
    y, aux = M.moe_ffn(p, torch.from_numpy(x), cfg, n_groups=n_groups,
                       length_mask=None if mask is None
                       else torch.from_numpy(mask))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux["load_balance"]),
                               float(jaux["load_balance"]), rtol=0,
                               atol=1e-6)
    jtopi, jkeep, _ = _jax_routing(jp, x, cfg, n_groups, mask)
    topi, keep = _port_routing(p, x, cfg, n_groups, mask)
    np.testing.assert_array_equal(topi, jtopi)
    np.testing.assert_array_equal(keep, jkeep)
    live = mask.reshape(jkeep.shape[:2]) if masked else np.ones(
        jkeep.shape[:2], bool)
    dropped = int((~jkeep & live[..., None]).sum())
    if capacity_factor < 1:
        assert dropped > 0
    if masked:
        # masked tokens are dropped before the capacity cumsum: other
        # values there move no valid token's place, nor y at valid tokens
        x2 = np.where(mask[..., None], x, 3.0 * x[::-1]).astype(np.float32)
        _, keep2 = _port_routing(p, x2, cfg, n_groups, mask)
        np.testing.assert_array_equal(keep2, keep)
        y2, _ = M.moe_ffn(p, torch.from_numpy(x2), cfg, n_groups=n_groups,
                          length_mask=torch.from_numpy(mask))
        assert torch.equal(y2[torch.from_numpy(mask)],
                           y[torch.from_numpy(mask)])


def test_moe_ffn_decode_shape_and_default_groups():
    """One group by default below 8192 tokens (decode: B tokens, one
    each); y keeps x's shape and dtype."""
    cfg = _cfg()
    jp, p = _params(cfg, seed=1)
    rng = np.random.default_rng(2)
    for shape in ((8, 1, D), (3, 40, D)):
        x = rng.standard_normal(shape, dtype=np.float32)
        jy, _ = JM.moe_ffn(jp, jnp.asarray(x), _jcfg(cfg))
        y, _ = M.moe_ffn(p, torch.from_numpy(x), cfg)
        assert y.shape == x.shape and y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5)


def test_exact_router_ties_pick_the_lower_expert_as_jax():
    """A router whose columns 3 and 6 are equal and dominate (and one that
    is all zeros: every expert ties) picks the same experts in both
    packages: the lower index first."""
    cfg = _cfg()
    jp, p = _params(cfg, seed=2)
    rng = np.random.default_rng(3)
    x = np.abs(rng.standard_normal((2, 16, D), dtype=np.float32))
    w = np.asarray(jp["router"]["w"]).copy() * 0.01
    w[:, 3] = w[:, 6] = 0.5
    for router in (w, np.zeros_like(w)):
        jp2 = dict(jp, router={"w": jnp.asarray(router)})
        p2 = dict(p, router={"w": torch.from_numpy(router)})
        jtopi, jkeep, jprobs = _jax_routing(jp2, x, cfg, 1)
        topi, keep = _port_routing(p2, x, cfg, 1)
        assert (jprobs[..., jtopi[0, 0, 0]] ==
                jprobs[..., jtopi[0, 0, 1]]).all()
        np.testing.assert_array_equal(topi, jtopi)
        np.testing.assert_array_equal(keep, jkeep)
        want = [3, 6] if router.any() else [0, 1]
        assert (jtopi == np.array(want)).all()
        jy, _ = JM.moe_ffn(jp2, jnp.asarray(x), _jcfg(cfg))
        y, _ = M.moe_ffn(p2, torch.from_numpy(x), cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5)


def test_top_k_near_ties_differ_only_within_four_ulps():
    """8192 tokens, 64 experts top-6 (deepseek's routing at d_model 64),
    the top-k compared rank by rank, unsorted (the order within the top k
    sets the capacity cumsum's positions): at every rank where the port
    picks another expert than JAX, JAX's probability of the port's pick
    lies within 4 float32 ulps of JAX's probability of its own pick.  That
    covers a swap at the k-th / (k+1)-th boundary and a swap of two ranks
    within the top k, and nothing else; the count of such tokens is
    reported, whatever it is."""
    cfg = dataclasses.replace(_cfg(), n_experts=64, top_k=6)
    jp, p = _params(cfg, seed=4)
    x = np.random.default_rng(5).standard_normal((1, 8192, D),
                                                 dtype=np.float32)
    jtopi, _, jprobs = _jax_routing(jp, x, cfg, 1)
    topi, _ = _port_routing(p, x, cfg, 1)
    differ = topi != jtopi
    picked = np.take_along_axis(jprobs, topi.astype(np.int64), -1)
    want = np.take_along_axis(jprobs, jtopi.astype(np.int64), -1)
    near = np.abs(picked - want) <= 4 * np.spacing(want)
    srt = -np.sort(-jprobs, axis=-1)
    ties = (np.abs(srt[..., :cfg.top_k] - srt[..., 1:cfg.top_k + 1])
            <= 4 * np.spacing(srt[..., :cfg.top_k])).any(-1)
    print(f"{int(differ.any(-1).sum())} of {topi.shape[1]} tokens route "
          f"differently; {int(ties.sum())} have a near-tie within 4 ulps "
          f"among their top {cfg.top_k + 1}")
    assert near[differ].all()


def test_moe_router_and_shared_run_through_the_backend():
    """The router (float32 input) and the shared experts' three
    projections are dense calls named under the block; the expert
    einsums are not."""
    cfg = _cfg()
    _, p = _params(cfg, seed=6)
    names = []

    def recording(name, p_, x, **kw):
        names.append((name, x.dtype))
        return None
    x = torch.randn(2, 5, D)
    with _backend.use(recording):
        M.moe_ffn(p, x, cfg, name="units/0/moe")
    assert names == [("units/0/moe/router", torch.float32),
                     ("units/0/moe/shared/gate", torch.float32),
                     ("units/0/moe/shared/up", torch.float32),
                     ("units/0/moe/shared/down", torch.float32)]


def test_init_moe_tree_matches_jax():
    cfg = cfgbase.get("deepseek-v2-lite-16b").moe
    small = dataclasses.replace(cfg, n_experts=4, d_ff=32)
    jp = JM.init_moe(jax.random.PRNGKey(0), D, _jcfg(small), jnp.bfloat16)
    p = M.init_moe(torch.Generator().manual_seed(0), D, small,
                   torch.bfloat16, repeats=3)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    assert [k for k, _ in flat] == [k for k, _ in jflat]
    for (path, leaf), (_, jleaf) in zip(flat, jflat):
        assert tuple(leaf.shape) == (3,) + tuple(jleaf.shape), path
        assert str(leaf.dtype).split(".")[-1] == str(jleaf.dtype), path
    assert p["router"]["w"].dtype == torch.float32
    assert p["shared"]["up"]["w"].shape == (3, D, 2 * 32)
    assert cfgbase.MoEConfig is M.MoEConfig
