"""LM training example on the PyTorch port with the full substrate:
sharded synthetic data, AdamW + warmup-cosine, async atomic
checkpointing, restart, straggler monitoring, optional int8 gradient
compression.

Default is a small reduced model for a quick demo; scale up with the
flags (e.g. --steps 300).

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
      PYTHONPATH=src python examples/torch_train_lm.py --resume  # restart
"""
import argparse

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="experiments/torch_train_lm_ckpt")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu trains on the "
                         "CPU)")
    args = ap.parse_args(argv)
    argv = ["--arch", args.arch, "--reduce", "--steps", str(args.steps),
            "--batch", "8", "--seq", "128", "--ckpt-dir", args.ckpt_dir,
            "--ckpt-every", "50", "--device", args.device]
    if args.resume:
        argv.append("--resume")
    if args.compress_grads:
        argv.append("--compress-grads")
    losses = train.main(argv)
    assert losses[-1] < losses[0], "loss should decrease"
    return losses


if __name__ == "__main__":
    main()
