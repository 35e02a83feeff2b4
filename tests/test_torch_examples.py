"""The port's examples (``examples/torch_*.py``) run on the CPU at few
steps: the quickstart (search, artifact round trip, the head deployed
through `ops.odimo_deployed_dense`, its own oracle check), the MLP search
on ``tpu_v5e``, the serve and train wrappers (train at 2 steps, the fewest
for which its loss assert can hold), and the Pareto sweep
over the experiments script; each refuses the card's default device
without a card."""
import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_deploys_the_head(tmp_path, capsys):
    qs = _load("torch_quickstart")
    art = tmp_path / "m.json"
    qs.main(["--fast", "--device", "cpu", "--artifact", str(art)])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("quickstart OK")
    assert "fused-kernel max |err| vs fake-quant oracle" in out
    doc = json.loads(art.read_text())
    assert doc["platform"] == "diana" and len(doc["layers"]) == 22


def test_tpu_domains_searches_on_tpu_v5e(monkeypatch, capsys):
    ex = _load("torch_odimo_tpu_domains")
    monkeypatch.setattr(ex, "STEPS", dict(pretrain_steps=3, search_steps=4,
                                          finetune_steps=2, batch=16,
                                          eval_batches=1))
    fracs = ex.main(["--device", "cpu"])
    assert len(fracs) == len(ex.LAMBDAS)
    assert all(0.0 <= f <= 1.0 for f in fracs)
    assert capsys.readouterr().out.count("roofline-lat=") == 2


@pytest.mark.parametrize("engine", [False, True])
def test_serve_llm(engine, capsys):
    ex = _load("torch_serve_llm")
    ex.main(["--device", "cpu"] + (["--engine"] if engine else []))
    out = capsys.readouterr().out
    assert "[serve]" in out
    if engine:
        assert "engine[" in out
    else:
        assert "8 reqs" in out


def test_train_lm(tmp_path):
    ex = _load("torch_train_lm")
    ck = tmp_path / "ck"
    losses = ex.main(["--device", "cpu", "--steps", "2", "--ckpt-dir",
                      str(ck)])
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert any(ck.iterdir())          # the final checkpoint


def test_pareto_sweep(tmp_path, monkeypatch, capsys):
    ex = _load("torch_pareto_sweep")
    drv = ex.torch_paper_experiments
    monkeypatch.setitem(drv.PRESETS, "quick", dict(
        drv.PRESETS["quick"], pretrain=2, search=2, finetune=2, batch=8,
        evalb=1, lambdas=(1e-8, 3e-6)))
    monkeypatch.chdir(tmp_path)
    results = ex.main(["--preset", "quick", "--device", "cpu"])
    assert (tmp_path / "experiments" / "paper_torch" /
            "results_quick.json").is_file()
    kinds = [r["kind"] for r in results]
    assert kinds.count("baseline") == 5 and kinds.count("odimo_diana") == 4
    assert kinds.count("table1") == 4 and kinds.count("crossplat") == 4
    assert "Pareto points: 8 ODiMO, 5 baselines" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_odimo_tpu_domains",
                                  "torch_serve_llm", "torch_train_lm",
                                  "torch_paper_experiments"])
def test_examples_refuse_cuda_without_a_card(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = _load(name)
    with pytest.raises(SystemExit) as e:
        ex.main([])
    assert e.value.code != 0
    assert "--device cpu" in capsys.readouterr().err

