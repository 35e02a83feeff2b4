"""The port's domain -> sub-group planning (`repro_torch.core.partition`)
against the JAX package's: the JAX tests' invariants on the port (exact
channel tiling, device conservation, latency-balanced sizing), and the
same devices and column ranges as ``repro.core.partition`` under
hypothesis over counts, ``tp`` 4 / 8 / 16 and ``c_out`` 256-1024, with
the TPU and DIANA cost models of each package."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")  # optional test dep (requirements-dev.txt)
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import cost_models as jcm  # noqa: E402
from repro.core import partition as JP  # noqa: E402
from repro_torch.core import partition as P  # noqa: E402
from repro_torch.core.cost_models import (DianaCostModel,  # noqa: E402
                                          LayerGeometry, TPUCostModel)

MODELS = {"tpu": (TPUCostModel, jcm.TPUCostModel),
          "diana": (DianaCostModel, jcm.DianaCostModel)}


def _jgeom(g):
    return jcm.LayerGeometry(c_in=g.c_in, c_out=g.c_out, fx=g.fx, fy=g.fy,
                             ox=g.ox, oy=g.oy, groups=g.groups)


def _shards(plan):
    return [(s.domain, s.devices, s.col_start, s.col_end)
            for s in plan.shards]


@settings(max_examples=20, deadline=None)
@given(c0=st.integers(0, 512), tp=st.sampled_from([4, 8, 16]),
       c_out=st.sampled_from([256, 512, 1024]))
def test_plan_layer_invariants(c0, tp, c_out):
    c0 = min(c0, c_out)
    counts = [c0, c_out - c0]
    geom = LayerGeometry(c_in=512, c_out=c_out, ox=64)
    plan = P.plan_layer(TPUCostModel(), geom, counts, tp)
    plan.check(tp)  # tiling + device conservation
    for s, c in zip(plan.shards, counts):
        assert s.col_end - s.col_start == c
        if c > 0:
            assert s.devices >= 1


def test_balanced_split_gets_more_devices_for_slower_domain():
    """bf16 domain (half peak) gets more devices than int8 at equal
    channel counts: finishing times equalize."""
    geom = LayerGeometry(c_in=4096, c_out=4096, ox=4096)
    devs = P.size_subgroups(TPUCostModel(), geom, [2048, 2048], 12)
    assert devs[1] > devs[0]
    assert sum(devs) == 12


def test_all_one_domain():
    geom = LayerGeometry(c_in=64, c_out=128)
    plan = P.plan_layer(TPUCostModel(), geom, [128, 0], 8)
    assert plan.shards[0].devices == 8
    assert plan.shards[1].devices == 0


def test_plan_network_runs_over_odimo_counts():
    geoms = [LayerGeometry(c_in=64, c_out=128, ox=32),
             LayerGeometry(c_in=128, c_out=256, ox=16)]
    counts = [[100, 28], [0, 256]]
    plans = P.plan_network(TPUCostModel(), geoms, counts, 16)
    assert len(plans) == 2
    for p in plans:
        p.check(16)


@pytest.mark.parametrize("model", sorted(MODELS))
@settings(max_examples=30, deadline=None)
@given(c0=st.integers(0, 1024), tp=st.sampled_from([4, 8, 16]),
       c_out=st.sampled_from([256, 512, 768, 1024]),
       c_in=st.sampled_from([64, 512, 4096]), ox=st.sampled_from([1, 16, 64]))
def test_plans_equal_jax(model, c0, tp, c_out, c_in, ox):
    """`size_subgroups` / `plan_layer` give JAX's devices and column ranges
    for every split of the layer's channels."""
    ours, theirs = MODELS[model]
    counts = [min(c0, c_out), c_out - min(c0, c_out)]
    geom = LayerGeometry(c_in=c_in, c_out=c_out, ox=ox)
    assert P.size_subgroups(ours(), geom, counts, tp) == \
        JP.size_subgroups(theirs(), _jgeom(geom), counts, tp)
    assert _shards(P.plan_layer(ours(), geom, counts, tp)) == \
        _shards(JP.plan_layer(theirs(), _jgeom(geom), counts, tp))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_plan_network_equals_jax(model):
    """A whole network's plans, layer by layer, as JAX's."""
    ours, theirs = MODELS[model]
    geoms = [LayerGeometry(c_in=c_in, c_out=c_out, ox=ox)
             for c_in, c_out, ox in ((4096, 4096, 1), (4096, 11008, 4),
                                     (11008, 4096, 1), (64, 256, 32))]
    counts = [[4000, 96], [128, 10880], [0, 4096], [256, 0]]
    for tp in (4, 8, 16):
        got = [_shards(p) for p in P.plan_network(ours(), geoms, counts, tp)]
        want = [_shards(p) for p in JP.plan_network(
            theirs(), [_jgeom(g) for g in geoms], counts, tp)]
        assert got == want
