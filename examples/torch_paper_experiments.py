"""Paper experiments on the PyTorch port: Fig. 4 (Pareto sweep), Fig. 5
(abstract HW models), Table I (deployment accounting), plus a
cross-platform Pareto row (DIANA vs the 3-domain gap9_like SoC vs the TPU
v5e roofline vs the gpu_tc_like tensor-core pair).

The counterpart of ``benchmarks/paper_experiments.py`` on
``repro_torch``: the same presets, models, functions and record keys, the
search on ``--device`` (the card unless the caller asks for the CPU; no
fall-back).  Real datasets are offline-unavailable; the tasks are
learnable synthetic distributions of the models' geometry
(``repro_torch.data.pipeline``), so accuracy deltas between mappings are
indicative and the latency / energy numbers, which come from the paper's
ANALYTICAL cost models, are exact.  Nothing here is timed on the device
but the stages' walls.

Run:  PYTHONPATH=src python examples/torch_paper_experiments.py \\
          --preset quick [--only fig4,table1] [--device cpu]

``--only`` takes a comma-separated list of parts (JAX's script takes one),
so that a run split over several calls can keep Table I in the call that
runs Fig. 4.

Writes ``experiments/paper_torch/results_<preset>.json`` (the records) and
``stages_<preset>.json`` beside it (per record, each stage's steps, wall
seconds and ms per step).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.api import Platform, SearchConfig, SearchPipeline, cnn_handle
from repro_torch.api.pipeline import PipelineCallback
from repro_torch.core import baselines as BL
from repro_torch.data.pipeline import ImageTaskConfig, image_batch
from repro_torch.models import cnn

PRESETS = {
    "quick": dict(pretrain=80, search=100, finetune=80, batch=32, evalb=4,
                  lambdas=(1e-8, 3e-7, 3e-6), models=("resnet20_tiny",)),
    # medium: full resnet20 geometry, CPU-budget steps (the quick preset
    # uses the reduced-geometry model; EXPERIMENTS.md records both)
    "medium": dict(pretrain=150, search=200, finetune=150, batch=48, evalb=6,
                   lambdas=(1e-7, 1e-6, 1e-5),
                   models=("resnet20",)),
    "full": dict(pretrain=250, search=300, finetune=250, batch=64, evalb=8,
                 lambdas=(1e-8, 1e-7, 5e-7, 2e-6, 1e-5),
                 models=("resnet20", "mobilenetv1_025", "resnet18_small")),
}

MODEL_CFGS = {
    "resnet20": cnn.RESNET20_CFG,
    "resnet20_tiny": cnn.RESNET20_TINY,
    "resnet18": cnn.RESNET18_CFG,
    "resnet18_small": cnn.RESNET18_SMALL,   # full-geometry resnet18 is
    "mobilenetv1_025": cnn.MBV1_CFG,        # CPU-infeasible; same family
}

PARTS = ("fig4", "fig5", "table1", "crossplat")
BASELINES = ("all_8bit", "all_ternary", "io8_backbone_ternary",
             "min_cost_lat", "min_cost_en")


class StageTimer(PipelineCallback):
    """Each stage's steps and wall seconds (the device synchronised at
    both ends)."""

    def __init__(self, device):
        self.device, self.stages, self._t = torch.device(device), {}, 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def on_stage_start(self, stage, state):
        self._sync()
        self._t = time.perf_counter()
        self.stages[stage.name] = {"steps": 0}

    def on_stage_end(self, stage, state):
        self._sync()
        rec = self.stages[stage.name]
        rec["wall_s"] = time.perf_counter() - self._t
        if rec["steps"]:
            rec["ms_per_step"] = 1e3 * rec["wall_s"] / rec["steps"]

    def on_step(self, stage, step, metrics):
        self.stages[stage.name]["steps"] += 1


def _stage_line(rec, timer, stages):
    """Print the record's stage times; append them to ``stages`` (a list,
    or None) with the keys that name the record."""
    if stages is not None:
        stages.append(dict({k: rec[k] for k in ("kind", "model", "name",
                                                "lam", "objective",
                                                "platform") if k in rec},
                           stages=timer.stages))
    print("    stages: " + " ".join(
        f"{name} {s['steps']} x {s['ms_per_step']:.1f} ms"
        if "ms_per_step" in s else f"{name} {s['wall_s']:.2f} s"
        for name, s in timer.stages.items()))


def _task_for(cfg):
    # noise 0.8: hard enough that aggressive quantization visibly costs
    # accuracy (the paper's accuracy axis)
    return ImageTaskConfig(n_classes=cfg.n_classes, img_hw=cfg.img_hw,
                           noise=0.8)


def _data_fn(cfg, device):
    task = _task_for(cfg)
    return lambda step, batch: image_batch(task, step, batch, device=device)


def _scfg(preset, lam, objective):
    p = PRESETS[preset]
    return SearchConfig(
        lam=lam, objective=objective, pretrain_steps=p["pretrain"],
        search_steps=p["search"], finetune_steps=p["finetune"],
        batch=p["batch"], eval_batches=p["evalb"])


def baseline_assignments(model_name: str, platform, names=BASELINES):
    """{name: per-layer assignments} of the fixed baselines; pinned layers
    (depthwise) stay digital regardless of the baseline."""
    handle = cnn_handle(MODEL_CFGS[model_name])
    geoms, searchable = handle.geometries(), handle.searchable()
    cost_model = Platform.get(platform).cost_model()
    makers = {
        "all_8bit": lambda: BL.all_8bit(geoms),
        "all_ternary": lambda: BL.all_ternary(geoms),
        "io8_backbone_ternary": lambda: BL.io8_backbone_ternary(geoms),
        "min_cost_lat": lambda: BL.min_cost(cost_model, geoms, "latency",
                                            searchable),
        "min_cost_en": lambda: BL.min_cost(cost_model, geoms, "energy",
                                           searchable),
    }
    out = {}
    for name in names:
        assigns = makers[name]()
        for li, s in enumerate(searchable):
            if not s:
                assigns[li][:] = 0
        out[name] = assigns
    return out


def run_baselines(model_name: str, preset: str, platform, out: list, *,
                  names=BASELINES, device="cuda", stages=None):
    cfg = MODEL_CFGS[model_name]
    handle = cnn_handle(cfg)
    data_fn = _data_fn(cfg, device)
    scfg = _scfg(preset, 0.0, "latency")
    for name, assigns in baseline_assignments(model_name, platform,
                                              names).items():
        t0 = time.time()
        timer = StageTimer(device)
        res = SearchPipeline.fixed_mapping(handle, assigns, platform,
                                           config=scfg, data_fn=data_fn,
                                           callbacks=[timer],
                                           device=device).run()
        rec = dict(kind="baseline", model=model_name, name=name,
                   accuracy=res.accuracy, latency=res.latency,
                   energy=res.energy,
                   aimc_ch=_aimc_frac(res.counts), wall_s=time.time() - t0)
        out.append(rec)
        print(f"  [baseline {name}] acc={res.accuracy:.4f} "
              f"lat={res.latency:.3e} en={res.energy:.3e} "
              f"A.Ch={rec['aimc_ch']:.1%}")
        _stage_line(rec, timer, stages)


def _aimc_frac(counts):
    tot = sum(int(c.sum()) for c in counts)
    aimc = sum(int(c[1]) for c in counts)
    return aimc / max(tot, 1)


def run_odimo_sweep(model_name: str, preset: str, platform, objective: str,
                    out: list, tag: str, *, device="cuda", stages=None):
    cfg = MODEL_CFGS[model_name]
    handle = cnn_handle(cfg)
    data_fn = _data_fn(cfg, device)
    for lam in PRESETS[preset]["lambdas"]:
        t0 = time.time()
        scfg = _scfg(preset, lam, objective)
        timer = StageTimer(device)
        res = SearchPipeline(handle, platform, config=scfg, data_fn=data_fn,
                             callbacks=[timer], device=device).run()
        rec = dict(kind=f"odimo_{tag}", model=model_name, objective=objective,
                   lam=lam, accuracy=res.accuracy, latency=res.latency,
                   energy=res.energy, aimc_ch=_aimc_frac(res.counts),
                   counts=[c.tolist() for c in res.counts],
                   wall_s=time.time() - t0)
        out.append(rec)
        print(f"  [odimo {tag} {objective} lam={lam:.1e}] "
              f"acc={res.accuracy:.4f} lat={res.latency:.3e} "
              f"en={res.energy:.3e} A.Ch={rec['aimc_ch']:.1%}")
        _stage_line(rec, timer, stages)


def fig4(preset: str, results: list, *, device="cuda", stages=None):
    """Accuracy vs latency + accuracy vs energy Pareto fronts on DIANA."""
    for m in PRESETS[preset]["models"]:
        print(f"[fig4] {m}")
        run_baselines(m, preset, "diana", results, device=device,
                      stages=stages)
        for obj in ("latency", "energy"):
            run_odimo_sweep(m, preset, "diana", obj, results, tag="diana",
                            device=device, stages=stages)


def fig5(preset: str, results: list, *, device="cuda", stages=None):
    """Abstract HW models: P_idle = P_act and P_idle = 0 (HW independence)."""
    m = PRESETS[preset]["models"][0]
    for platform, tag in (("diana_abstract", "abs_noshut"),
                          ("diana_ideal_shutdown", "abs_shut")):
        print(f"[fig5] {m} platform={platform}")
        run_odimo_sweep(m, preset, platform, "energy", results, tag=tag,
                        device=device, stages=stages)


def crossplat(preset: str, results: list, *, device="cuda", stages=None):
    """Cross-platform Pareto row: the same model and lambda searched on each
    registered target -- DIANA (2 domains), the 3-domain gap9_like SoC, the
    TPU v5e roofline and the gpu_tc_like tensor-core pair -- reporting the
    per-domain channel fractions the search settles on under each
    platform's cost structure.  No baseline runs here: `BL.min_cost`
    prices two domains only."""
    m = PRESETS[preset]["models"][0]
    cfg = MODEL_CFGS[m]
    handle = cnn_handle(cfg)
    data_fn = _data_fn(cfg, device)
    lambdas = PRESETS[preset]["lambdas"]
    lam = lambdas[len(lambdas) // 2]
    for platform in ("diana", "gap9_like", "tpu_v5e", "gpu_tc_like"):
        t0 = time.time()
        scfg = _scfg(preset, lam, "latency")
        timer = StageTimer(device)
        res = SearchPipeline(handle, platform, config=scfg, data_fn=data_fn,
                             callbacks=[timer], device=device).run()
        art = res.artifact
        fracs = {d["name"]: float(f) for d, f in
                 zip(art.domains, art.domain_channel_fractions())}
        rec = dict(kind="crossplat", model=m, platform=platform, lam=lam,
                   objective="latency", accuracy=res.accuracy,
                   latency=res.latency, energy=res.energy,
                   domain_fractions=fracs,
                   counts=[c.tolist() for c in res.counts],
                   wall_s=time.time() - t0)
        results.append(rec)
        frac_s = " ".join(f"{k}={v:.1%}" for k, v in fracs.items())
        print(f"  [crossplat {platform} lam={lam:.1e}] "
              f"acc={res.accuracy:.4f} lat={res.latency:.3e} "
              f"en={res.energy:.3e} {frac_s}")
        _stage_line(rec, timer, stages)


def table1(results: list):
    """Deployment accounting (Table I): utilization per accelerator and
    AIMC-channel fraction, from the discretized mappings of fig4 in
    ``results`` (the same call's).  The cost model's tensors are read as
    floats."""
    cm = Platform.get("diana").cost_model()
    rows = []
    for r in results:
        if r["kind"] != "odimo_diana" or "counts" not in r:
            continue
        geoms = cnn_handle(MODEL_CFGS[r["model"]]).geometries()
        lat_dig = lat_aimc = lat_tot = 0.0
        for geom, counts in zip(geoms, r["counts"]):
            lat = cm.latency(geom, np.asarray(counts, np.float32))
            lat_dig += float(lat[0])
            lat_aimc += float(lat[1])
            lat_tot += float(lat.max())
        rows.append(dict(
            kind="table1", model=r["model"], objective=r["objective"],
            lam=r["lam"], acc=r["accuracy"],
            lat_ms=float(cm.cycles_to_ms(r["latency"])),
            energy=r["energy"],
            dig_util=lat_dig / max(lat_tot, 1e-9),
            aimc_util=lat_aimc / max(lat_tot, 1e-9),
            aimc_ch=r["aimc_ch"]))
    for row in rows:
        print(f"  [table1 {row['model']} {row['objective']} "
              f"lam={row['lam']:.0e}] acc={row['acc']:.4f} "
              f"lat={row['lat_ms']:.3f}ms D/A util="
              f"{row['dig_util']:.0%}/{row['aimc_util']:.0%} "
              f"A.Ch={row['aimc_ch']:.1%}")
    results.extend(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="quick", choices=list(PRESETS))
    ap.add_argument("--out", default="experiments/paper_torch")
    ap.add_argument("--only", default=None,
                    help="comma-separated parts of " + ", ".join(PARTS) +
                         " (default: all); table1 reads the same call's "
                         "fig4 records")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the search "
                         "on the CPU)")
    args = ap.parse_args(argv)
    parts = PARTS if args.only is None else args.only.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--only: parts of {', '.join(PARTS)}, got {args.only!r}")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        ap.error("--device cuda needs a CUDA device; pass --device cpu to "
                 "run on the CPU")
    kw = dict(device=args.device, stages=[])
    results: list = []
    t0 = time.time()
    if "fig4" in parts:
        fig4(args.preset, results, **kw)
    if "fig5" in parts:
        fig5(args.preset, results, **kw)
    if "table1" in parts:
        table1(results)
    if "crossplat" in parts:
        crossplat(args.preset, results, **kw)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / f"results_{args.preset}.json").write_text(
        json.dumps(results, indent=1))
    (outdir / f"stages_{args.preset}.json").write_text(
        json.dumps(kw["stages"], indent=1))
    print(f"[paper_experiments] wrote {len(results)} records "
          f"in {time.time()-t0:.0f}s -> {outdir}/results_{args.preset}.json")
    return results


if __name__ == "__main__":
    main()
