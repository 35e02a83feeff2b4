"""Training entry point of the port (``repro.launch.train`` counterpart).

Trains any arch of the port (full or ``--reduce``) on the synthetic token
task, or a CNN (``--arch cnn:<config>``) on the synthetic image task, with
the JAX package's semantics:

  * ``lm_loss`` with every repeat rematerialised (``remat=True``) and the
    MoE load-balance aux, AdamW with weight decay 0.01 and clipping at 1.0,
    a linear warmup then cosine decay;
  * a deterministic, restart-safe token stream (`ShardedLoader`);
  * atomic async checkpoints of ``(params, opt_state)`` with ``{"step":
    k}`` every ``--ckpt-every`` steps and at the end, and ``--resume``
    from the latest committed one (the compression residual is not saved,
    as in the JAX package: it restarts at zero);
  * a step whose gradient norm is not finite is skipped in the log (its
    update is applied, as the JAX package's donated step does);
    `StragglerPolicy` observes the step times;
  * optional int8 gradient compression with error feedback
    (``--compress-grads``);
  * ``--emit-mapping`` writes a static min-cost mapping artifact of the
    trained weights for ``repro_torch.runtime`` / ``launch.serve``.

It runs on the card unless ``--device cpu`` is given; nothing falls back
to the CPU.  A sequence longer than 2048 tokens needs the flash kernel's
backward pass, which does not exist yet (`transformer.lm_loss`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \
        --reduce --steps 5 --batch 2 --seq 16 --device cpu
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.api import MappingArtifact, Platform
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import base as cfgbase
from repro_torch.core import baselines, quant
from repro_torch.core import tree as T
from repro_torch.core.cost_models import LayerGeometry
from repro_torch.data.pipeline import (ShardedLoader, TokenTaskConfig,
                                       keyed_generator)
from repro_torch.distributed.fault_tolerance import StragglerPolicy
from repro_torch.models import transformer as TR
from repro_torch.optim import adamw, compression


def emit_static_mapping(params, cfg, platform, out_path, max_cout=512,
                        stacked_prefixes=("units", "enc_units"),
                        plan_hints=None, act_log_scale=None, bias=None):
    """Write a schema-v2 mapping artifact for the model's projection
    weights: per-layer min-cost static channel split (paper Sec. IV
    baselines) under the named platform's cost model, with max-abs weight
    quant scales so the artifact lowers to an executable `ExecutionPlan`.

    Layer names are params paths in flatten order.  2-D ``(C_in, C_out)``
    weights give one layer each; 3-D ``(R, C_in, C_out)`` stacked weights
    under a ``stacked_prefixes`` subtree give one layer PER REPEAT, named
    ``path@r`` with that repeat's own scale; 4-D ``(kh, kw, C_in, C_out)``
    HWIO conv weights give one layer each, which executes through im2col.
    ``plan_hints`` -- ``{name: (LayerGeometry, searchable)}`` from a
    model's ``plan()`` -- gives the cost model's true geometry (output map,
    groups) and searchability of the 2-D and 4-D layers it names; a grouped
    conv is emitted with its group count.  Without a hint a conv's geometry
    is the weight's shape alone (output map 1 x 1, groups 1).  Layers wider
    than ``max_cout`` output channels are pinned to domain 0 (the
    exhaustive split search is O(C_out) cost evaluations).
    ``act_log_scale`` pins a static activation scale on every layer (None:
    dynamic per call).

    ``bias=(domain_name, fraction)`` overrides the min-cost split of every
    searchable layer: its first ``round(fraction * C_out)`` channels go to
    that domain and the rest to domain 0 (domain 1 when the biased domain
    is domain 0).  ``("aimc", 1.0)`` on ``diana`` is the paper's
    all-ternary baseline on the searchable layers.
    """
    plat = Platform.get(platform)
    cm, spec = plat.cost_model(), plat.spec()
    names, geoms, searchable, scales = [], [], [], []
    plan_hints = plan_hints or {}

    def w_scale(w):
        ls = float(quant.init_log_scale(w))
        return {"w_log_scales": [ls] * spec.n_domains,
                "act_log_scale": (float(act_log_scale)
                                  if act_log_scale is not None else None)}

    for path, leaf in T.leaves_with_paths(params):
        parts = [str(p) for p in path]
        if not parts or parts[-1] != "w" or not isinstance(leaf,
                                                           torch.Tensor):
            continue
        parts = parts[:-1]
        name = "/".join(parts)
        hint = plan_hints.get(name)
        if leaf.dim() == 2:
            names.append(name)
            geoms.append(hint[0] if hint else
                         LayerGeometry(c_in=leaf.shape[0],
                                       c_out=leaf.shape[1]))
            searchable.append((hint[1] if hint else True) and
                              leaf.shape[1] <= max_cout)
            scales.append(w_scale(leaf))
        elif leaf.dim() == 3 and parts and parts[0] in stacked_prefixes:
            for r in range(leaf.shape[0]):
                names.append(f"{name}@{r}")
                geoms.append(LayerGeometry(c_in=leaf.shape[1],
                                           c_out=leaf.shape[2]))
                searchable.append(leaf.shape[2] <= max_cout)
                scales.append(w_scale(leaf[r]))
        elif leaf.dim() == 4:
            kh, kw, ci, co = leaf.shape
            names.append(name)
            geoms.append(hint[0] if hint else
                         LayerGeometry(c_in=ci, c_out=co, fx=kw, fy=kh))
            searchable.append((hint[1] if hint else True) and
                              co <= max_cout)
            scales.append(w_scale(leaf))
    assigns = baselines.min_cost(cm, geoms, "latency", searchable)
    if bias is not None:
        dom_name, frac = bias
        dom_names = [d.name for d in spec.domains]
        if dom_name not in dom_names:
            raise ValueError(f"bias domain {dom_name!r} is not on platform "
                             f"{plat.name} (domains: {dom_names})")
        if not (0.0 <= frac <= 1.0):
            raise ValueError(f"bias fraction must be in [0, 1], got {frac}")
        di = dom_names.index(dom_name)
        other = 0 if di != 0 else min(1, spec.n_domains - 1)
        for li, a in enumerate(assigns):
            if not searchable[li]:
                continue
            k = int(round(frac * a.size))
            forced = np.full(a.size, other, dtype=np.int64)
            forced[:k] = di
            assigns[li] = forced
    counts = baselines.counts_from_assignments(assigns, spec.n_domains)
    plan = list(zip(names, geoms, searchable))
    art = MappingArtifact.from_search(cfg.name, spec, plan, assigns, counts,
                                      platform=plat.name, objective="latency",
                                      scales=scales)
    art.save(out_path)
    print(f"[train] wrote mapping artifact ({len(names)} layers, schema v"
          f"{art.schema_version}, platform={plat.name}) -> {out_path}")
    return art


def value_and_grad(fn, params):
    """``(fn(params) detached, the gradient tree)``: every floating-point
    leaf is differentiated (a fresh view that requires grad); a leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives it."""
    leaves = [p.detach().requires_grad_(p.is_floating_point())
              for p in T.leaves(params)]
    loss = fn(T.unflatten(params, leaves))
    req = [p for p in leaves if p.requires_grad]
    got = iter(torch.autograd.grad(loss, req, allow_unused=True))
    grads = [next(got) if p.requires_grad else None for p in leaves]
    grads = [g if g is not None else torch.zeros_like(p)
             for g, p in zip(grads, leaves)]
    return loss.detach(), T.unflatten(params, grads)


def make_step(cfg, ocfg, compress: bool):
    """``train_step(params, opt_state, residual, batch, lr) -> (params,
    opt_state, residual, {"loss", "grad_norm"})``: `lm_loss` with remat,
    then (``compress``) the gradients through int8 compression with error
    feedback, then AdamW."""
    def train_step(params, opt_state, residual, batch, lr):
        loss, grads = value_and_grad(
            lambda p: TR.lm_loss(p, cfg, batch, remat=True), params)
        with torch.no_grad():
            if compress:
                comp, residual = compression.compress_with_feedback(
                    grads, residual)
                grads = compression.decompress(comp)
            params, opt_state, gnorm = adamw.update(grads, opt_state, params,
                                                    ocfg, lr=lr)
        return params, opt_state, residual, {"loss": loss, "grad_norm": gnorm}
    return train_step


def train_cnn(args, cnn_name: str):
    """Supervised training of a CNN (``--arch cnn:<config>``) on the
    synthetic image task; ``--emit-mapping`` writes the static min-cost
    artifact with the model's plan hints (conv weights included, so it
    lowers onto the im2col'd planned kernels: ``serve --arch cnn:...
    --mapping``).  Returns the losses."""
    from repro_torch.data.pipeline import ImageTaskConfig, image_batch
    from repro_torch.models import cnn as C

    cfg = C.get_config(cnn_name)
    init_fn, apply_fn, _ = C.get_model(cfg)
    task = ImageTaskConfig(n_classes=cfg.n_classes, img_hw=cfg.img_hw,
                           in_ch=cfg.in_ch)
    dev = torch.device(args.device)
    params = init_fn(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    n_params = sum(p.numel() for p in T.leaves(params))
    print(f"[train] {cfg.name} params={n_params/1e6:.2f}M")

    ocfg = adamw.AdamWConfig(lr=args.lr, weight_decay=0.01)
    opt_state = adamw.init(params, ocfg)

    def loss_fn(p, x, y):
        logp = torch.log_softmax(apply_fn(p, x, cfg), dim=-1)
        return -torch.mean(torch.gather(logp, 1, y[:, None]))

    losses = []
    for step in range(args.steps):
        lr = float(adamw.warmup_cosine(step, peak_lr=args.lr,
                                       warmup=min(args.warmup, args.steps),
                                       total=args.steps))
        x, y = image_batch(task, step, args.batch, device=dev)
        loss, grads = value_and_grad(lambda p: loss_fn(p, x, y), params)
        with torch.no_grad():
            params, opt_state, _ = adamw.update(grads, opt_state, params,
                                                ocfg, lr=lr)
        losses.append(float(loss))
        if step % args.log_every == 0:
            print(f"[train] step {step} loss={losses[-1]:.4f} lr={lr:.2e}")
    if args.emit_mapping:
        emit_static_mapping(params, cfg, args.platform, args.emit_mapping,
                            plan_hints=C.plan_hints(cfg),
                            act_log_scale=args.mapping_act_scale,
                            bias=args.bias)
    print(f"[train] done. first loss={losses[0]:.4f} last={losses[-1]:.4f}")
    return losses


def frontend_rows(cfg, batch: int, step: int, device) -> torch.Tensor:
    """A frontend arch's stub rows of ``step`` (batch, frontend_tokens,
    d_model), bfloat16, from a generator of their own keyed on the step."""
    gen = keyed_generator(device, 9, step)
    return torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                       generator=gen, device=device).to(torch.bfloat16)


def main(argv=None):
    ap = argparse.ArgumentParser(description="train an LM or a CNN")
    ap.add_argument("--arch", required=True,
                    help="LM arch name, or cnn:<config> for the CNNs "
                         "(e.g. cnn:resnet20_tiny)")
    ap.add_argument("--reduce", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--platform", default="tpu_v5e",
                    help="platform name for --emit-mapping")
    ap.add_argument("--emit-mapping", default=None,
                    help="write a static min-cost mapping artifact (JSON) "
                         "of the trained weights to this path")
    ap.add_argument("--mapping-bias", default=None,
                    help="bias the emitted mapping toward a platform domain:"
                         " 'DOMAIN[:FRACTION]' forces that fraction "
                         "(default 1.0) of every searchable layer's output "
                         "channels into DOMAIN (a draft / target precision "
                         "bank from one set of weights, e.g. 'aimc' then "
                         "'digital' on diana)")
    ap.add_argument("--mapping-act-scale", type=float, default=None,
                    help="pin this STATIC activation log-scale on every "
                         "emitted layer (instead of dynamic per-batch "
                         "max-abs): the serving engine's per-request "
                         "reproducibility and the speculative decoder's "
                         "token identity need it")
    args = ap.parse_args(argv)

    args.bias = None
    if args.mapping_bias:
        if not args.emit_mapping:
            ap.error("--mapping-bias needs --emit-mapping")
        name, _, frac = args.mapping_bias.partition(":")
        args.bias = (name, float(frac) if frac else 1.0)
    if args.emit_mapping:
        Platform.get(args.platform)   # an unknown name fails before training
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        ap.error("--device cuda needs a CUDA device; pass --device cpu to "
                 "train on the CPU")
    if args.arch.startswith("cnn:"):
        return train_cnn(args, args.arch.split(":", 1)[1])

    cfg = cfgbase.get(args.arch)
    if args.reduce:
        cfg = cfgbase.reduce_for_smoke(cfg)
    dev = torch.device(args.device)

    ocfg = adamw.AdamWConfig(lr=args.lr, weight_decay=0.01)
    params = TR.init_lm(torch.Generator(device=dev).manual_seed(args.seed),
                        cfg)
    n_params = sum(p.numel() for p in T.leaves(params))
    print(f"[train] {cfg.name} reduced={args.reduce} "
          f"params={n_params/1e6:.1f}M")

    opt_state = adamw.init(params, ocfg)
    residual = (compression.init_residual(params)
                if args.compress_grads else None)
    data = ShardedLoader("token", TokenTaskConfig(vocab=cfg.vocab),
                         batch=args.batch, seq_len=args.seq, device=dev)
    step_fn = make_step(cfg, ocfg, args.compress_grads)

    start = 0
    saver = None
    if args.ckpt_dir:
        saver = ckpt.AsyncCheckpointer(args.ckpt_dir)
        if args.resume:
            latest = ckpt.latest_step(args.ckpt_dir)
            if latest is not None:
                params, opt_state = ckpt.restore(args.ckpt_dir, latest,
                                                 (params, opt_state))
                start = ckpt.restore_extra(args.ckpt_dir, latest)["step"]
                print(f"[train] resumed from step {start}")

    straggler = StragglerPolicy()
    losses = []
    for step in range(start, args.steps):
        lr = float(adamw.warmup_cosine(step, peak_lr=args.lr,
                                       warmup=args.warmup, total=args.steps))
        tokens, targets = data.get(step)
        batch = {"tokens": tokens, "targets": targets}
        if cfg.frontend:
            batch["frontend"] = frontend_rows(cfg, args.batch, step, dev)
        t0 = time.monotonic()
        params, opt_state, residual, metrics = step_fn(
            params, opt_state, residual, batch, lr)
        gn = float(metrics["grad_norm"])
        if not math.isfinite(gn):
            print(f"[train] step {step}: non-finite grad norm, skipped")
            continue
        dt = time.monotonic() - t0
        verdict = straggler.observe(step, dt)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0:
            print(f"[train] step {step} loss={losses[-1]:.4f} "
                  f"gnorm={gn:.3f} lr={lr:.2e} dt={dt*1e3:.0f}ms {verdict}")
        if saver and (step + 1) % args.ckpt_every == 0:
            saver.save(step + 1, (params, opt_state), {"step": step + 1})
    if saver:
        saver.save(args.steps, (params, opt_state), {"step": args.steps})
        saver.wait()
    if args.emit_mapping:
        emit_static_mapping(params, cfg, args.platform, args.emit_mapping,
                            act_log_scale=args.mapping_act_scale,
                            bias=args.bias)
    print(f"[train] done. first loss={losses[0]:.4f} last={losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
