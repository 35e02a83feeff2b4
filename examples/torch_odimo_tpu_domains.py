"""ODiMO with the TPU cost model on the PyTorch port: per-channel int8 /
bf16 precision-domain assignment on an MLP stack, with the paper's own
DNAS machinery via `repro_torch.api`.

The "accelerators" here are the two precision domains of the modelled
TPU v5e chip:
  domain 0: int8 path (2x peak FLOP/s, 1-byte weight stream)
  domain 1: bf16 path
The ``"tpu_v5e"`` platform's latency is roofline-based (`TPUCostModel`),
so channels drift to the int8 domain until the accuracy regularizer pushes
sensitive channels back: the paper's accuracy-vs-cost trade, on TPU
terms.  The search itself runs on ``--device`` (the card by default).

Run:  PYTHONPATH=src python examples/torch_odimo_tpu_domains.py
          [--device cpu]
"""
import argparse

import torch

from repro_torch.api import SearchConfig, SearchPipeline, mlp_handle
from repro_torch.data.pipeline import ImageTaskConfig, image_batch

IMG_HW = (8, 8)
N_CLASSES = 10
LAMBDAS = (1e2, 1e5)
STEPS = dict(pretrain_steps=80, search_steps=120, finetune_steps=60,
             batch=64, eval_batches=4)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        ap.error("--device cuda needs a CUDA device; pass --device cpu to "
                 "run on the CPU")
    handle = mlp_handle(in_dim=IMG_HW[0] * IMG_HW[1] * 3,
                        widths=(128, 256, 256, 128), n_classes=N_CLASSES,
                        name="mlp_tpu_domains")
    task = ImageTaskConfig(n_classes=N_CLASSES, img_hw=IMG_HW, noise=0.6)
    data_fn = lambda step, batch: image_batch(task, step, batch,
                                              device=args.device)

    print("=== ODiMO x TPU precision domains (int8 @2x peak vs bf16) ===")
    fracs = []
    for lam in LAMBDAS:
        scfg = SearchConfig(lam=lam, objective="latency", **STEPS)
        res = SearchPipeline(handle, platform="tpu_v5e", config=scfg,
                             data_fn=data_fn, device=args.device).run()
        int8_frac = float(res.artifact.domain_channel_fractions()[0])
        fracs.append(int8_frac)
        print(f"lambda={lam:.0e}: acc={res.accuracy:.3f} "
              f"roofline-lat={res.latency:.3e}s int8-channels={int8_frac:.0%}")
    print("higher lambda -> more channels on the fast int8 domain, the")
    print("TPU version of the paper's digital/AIMC trade")
    return fracs


if __name__ == "__main__":
    main()
