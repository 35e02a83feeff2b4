"""Quickstart on the PyTorch port: ODiMO end to end on a small CNN via the
`repro_torch.api` mapping API, in seconds on one H100.

  1. pretrain fp32        -> baseline accuracy
  2. DNAS search (Eq. 2)  -> per-channel accelerator assignment
  3. discretize           -> serializable mapping artifact (JSON)
  4. deploy one layer through the fused split_precision kernel
     (`ops.odimo_deployed_dense`; its plain version on the CPU) using the
     RELOADED artifact, and check it matches the fake-quant semantics

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--fast]
          [--device cpu]
"""
import argparse

import torch

from repro_torch.api import (MappingArtifact, SearchConfig, SearchPipeline,
                             VerboseCallback, cnn_handle)
from repro_torch.core import quant
from repro_torch.data.pipeline import ImageTaskConfig, image_batch
from repro_torch.kernels import ops
from repro_torch.models import cnn

#: (pretrain, search, finetune) steps, with and without --fast
STEPS, FAST_STEPS = (60, 80, 60), (10, 12, 8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="CI-speed step counts (seconds, not minutes)")
    ap.add_argument("--artifact",
                    default="experiments/torch_quickstart_mapping.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernel's "
                         "plain version)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        ap.error("--device cuda needs a CUDA device; pass --device cpu to "
                 "run on the CPU")
    dev = torch.device(args.device)

    cfg = cnn.RESNET20_TINY
    task = ImageTaskConfig(n_classes=cfg.n_classes, img_hw=cfg.img_hw)
    data_fn = lambda step, batch: image_batch(task, step, batch, device=dev)

    print("=== ODiMO search (latency objective, lambda=5e-7) ===")
    steps = FAST_STEPS if args.fast else STEPS
    scfg = SearchConfig(lam=5e-7, objective="latency",
                        pretrain_steps=steps[0], search_steps=steps[1],
                        finetune_steps=steps[2], batch=32, eval_batches=4)
    pipe = SearchPipeline(cnn_handle(cfg), platform="diana", config=scfg,
                          data_fn=data_fn, callbacks=[VerboseCallback()],
                          device=dev)
    res = pipe.run()
    print(f"accuracy={res.accuracy:.3f}  modeled latency={res.latency:.3e} "
          f"cycles  energy={res.energy:.3e}")
    print("channel split per layer (digital, aimc):",
          [tuple(int(x) for x in c) for c in res.counts][:8], "...")

    path = res.artifact.save(args.artifact)
    print(f"\n=== mapping artifact -> {path} ===")
    art = MappingArtifact.load(path)   # round-trip through JSON
    print(f"platform={art.platform} layers={len(art.layers)} "
          f"aimc channel fraction={art.domain_channel_fractions()[1]:.1%}")

    print("\n=== fused split-precision kernel deploy (from the artifact) ===")
    # deploy the classifier head through the fused kernel
    w = res.params["head"]["w"].to(torch.float32)
    assign = art.assignments()[-1]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((32, w.shape[0]), generator=gen, device=dev)
    wls = quant.init_log_scale(w)
    xls = quant.init_log_scale(x)
    out_kernel = ops.odimo_deployed_dense(x, w, assign, wls, xls)
    # oracle
    xq = quant.fake_quant(x, xls, 8)
    w8 = quant.fake_quant(w, wls, 8)
    lo = xq @ w8
    hi = x @ w
    expect = torch.where(torch.as_tensor(assign, device=dev)[None, :] == 0,
                         lo, hi)
    err = float((out_kernel - expect).abs().max())
    print(f"fused-kernel max |err| vs fake-quant oracle: {err:.4f}")
    assert err < 0.3
    print("quickstart OK")


if __name__ == "__main__":
    main()
