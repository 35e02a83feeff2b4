"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's, on the CPU: the substrate tests of ``tests/test_substrate.py``
(round trip, a torn write ignored, corruption detected, restore onto a
device, async saves, pruning) on the port; checkpoints crossing between
the two packages both ways, bfloat16 included, with identical manifests
(leaf hashes, dtypes, shapes, tree structure); and the search pipeline's
stage checkpoint and ``resume_from``, the counterpart of
``tests/test_runtime.py::test_pipeline_checkpoint_resume_restarts_at_search``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro_torch import api as A  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data.pipeline import ImageTaskConfig, image_batch  # noqa
from repro_torch.optim import adamw  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _jtree():
    return {"w": jnp.arange(12.0).reshape(3, 4),
            "nested": {"b": jnp.ones(5, jnp.bfloat16)},
            "step": jnp.asarray(7)}


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(T.leaves(a), T.leaves(b)))


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 3, t, extra={"step": 3})
    assert ckpt.latest_step(tmp_path) == 3
    out = ckpt.restore(tmp_path, 3, T.tree_map(torch.zeros_like, t))
    assert _equal(out, t)
    assert [x.dtype for x in T.leaves(out)] == [x.dtype for x in T.leaves(t)]
    assert ckpt.restore_extra(tmp_path, 3)["step"] == 3


def test_checkpoint_atomicity_torn_write_ignored(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    torn = tmp_path / "step_00000002"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    (tmp_path / "step_00000003.tmp-x").mkdir()
    assert ckpt.latest_step(tmp_path) == 1


def test_checkpoint_detects_corruption(tmp_path):
    d = ckpt.save(tmp_path, 1, _tree())
    data = np.load(d / "arrays.npz")
    arrays = {k: data[k].copy() for k in data.files}
    arrays["leaf_0"] = (arrays["leaf_0"] + 1).astype(np.uint8)
    np.savez(d / "arrays.npz", **arrays)
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore(tmp_path, 1, _tree())


def test_checkpoint_restore_places_and_casts(tmp_path):
    """The target may be shape-only (``meta``): ``device=`` places every
    leaf, each cast to its target's dtype; a structure of another leaf
    count or shape is refused."""
    t = {"w": torch.arange(16.0).reshape(4, 4), "n": torch.ones(3)}
    ckpt.save(tmp_path, 1, t)
    like = {"w": torch.empty(4, 4, dtype=torch.float64, device="meta"),
            "n": torch.empty(3, device="meta")}
    out = ckpt.restore(tmp_path, 1, like, device="cpu")
    assert out["w"].device.type == "cpu" and out["w"].dtype == torch.float64
    np.testing.assert_array_equal(out["w"].numpy(), t["w"].numpy())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(tmp_path, 1, {"w": t["w"]})
    with pytest.raises(ValueError, match="target"):
        ckpt.restore(tmp_path, 1, {"w": torch.zeros(2, 8), "n": t["n"]})
    with pytest.raises(FileNotFoundError, match="no committed"):
        ckpt.restore(tmp_path, 2, t)


def test_async_checkpointer_snapshots_on_the_callers_thread(tmp_path):
    """The snapshot is taken at ``save``: overwriting a leaf right after
    does not reach the checkpoint; a writer's error surfaces at
    ``wait``."""
    c = ckpt.AsyncCheckpointer(tmp_path)
    t = _tree()
    c.save(5, t, {"step": 5})
    t["w"].fill_(-1.0)
    c.wait()
    assert ckpt.latest_step(tmp_path) == 5
    out = ckpt.restore(tmp_path, 5, _tree())
    assert _equal(out, _tree())
    (tmp_path / "blocker").write_text("")
    bad = ckpt.AsyncCheckpointer(tmp_path / "blocker")
    bad.save(1, t)
    with pytest.raises(OSError):
        bad.wait()


def test_prune_old(tmp_path):
    for s in (1, 2, 3, 4):
        ckpt.save(tmp_path, s, {"x": torch.zeros(1)})
    ckpt.prune_old(tmp_path, keep=2)
    assert ckpt.latest_step(tmp_path) == 4
    assert not (tmp_path / "step_00000001").exists()
    assert (tmp_path / "step_00000003").exists()


def _manifest(d, step):
    import json
    return json.loads((d / f"step_{step:08d}" / "manifest.json").read_text())


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jckpt.save(tmp_path, 2, _jtree(), extra={"step": 2})
    like = T.tree_map(torch.zeros_like, _tree())
    out = ckpt.restore(tmp_path, 2, like)
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert _equal(out, _tree())
    assert ckpt.latest_step(tmp_path) == 2
    assert ckpt.restore_extra(tmp_path, 2) == {"step": 2}


def test_port_checkpoint_restores_in_jax(tmp_path):
    ckpt.save(tmp_path, 2, _tree(), extra={"step": 2})
    out = jckpt.restore(tmp_path, 2, _jtree())
    assert out["nested"]["b"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(_jtree())):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    assert jckpt.latest_step(tmp_path) == 2


def test_manifests_are_identical_across_packages(tmp_path):
    """The same tree (params and an AdamW state, bf16 moments included)
    gives the same manifest in both packages: leaf hashes, dtypes, shapes
    and the tree structure's string."""
    from repro.optim import adamw as jadamw
    p = {"a": torch.arange(6.0).reshape(2, 3),
         "b": [torch.linspace(-1, 1, 4).to(torch.bfloat16)]}
    state = adamw.init(p, adamw.AdamWConfig(moment_dtype=torch.bfloat16))
    jp = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), p)
    jstate = jadamw.init(jp, jadamw.AdamWConfig(moment_dtype=jnp.bfloat16))
    ckpt.save(tmp_path / "t", 1, (p, state), {"step": 1})
    jckpt.save(tmp_path / "j", 1, (jp, jstate), {"step": 1})
    tm, jm = _manifest(tmp_path / "t", 1), _manifest(tmp_path / "j", 1)
    assert tm == jm
    restored = ckpt.restore(tmp_path / "j", 1, (p, state))
    assert _equal(restored, (p, state))


def _mlp_pipeline(**kw):
    handle = A.mlp_handle(in_dim=48, widths=(24,), n_classes=10)
    task = ImageTaskConfig(n_classes=10, img_hw=(4, 4))
    return A.SearchPipeline(
        handle, "diana", config=A.SearchConfig(
            lam=1e-6, objective="latency", pretrain_steps=3, search_steps=5,
            finetune_steps=2, batch=8, eval_batches=2),
        data_fn=lambda s, b: image_batch(task, s, b, device="cpu"),
        device="cpu", **kw)


def test_pipeline_checkpoint_resume_restarts_at_search(tmp_path):
    full = _mlp_pipeline(checkpoint_dir=str(tmp_path / "ck")).run()
    resumed = _mlp_pipeline(resume_from=str(tmp_path / "ck")).run()
    assert "pretrain" not in resumed.history and "pretrain" in full.history
    assert resumed.accuracy == full.accuracy
    assert resumed.latency == full.latency
    for a, b in zip(resumed.assignments, full.assignments):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(resumed.history["search"]),
                                  np.asarray(full.history["search"]))
    assert ckpt.restore_extra(tmp_path / "ck", 1) == {
        "stage": "pretrain", "stage_index": 0}
    with pytest.raises(FileNotFoundError, match="no committed"):
        _mlp_pipeline(resume_from=str(tmp_path / "nope")).run()
