"""End-to-end serving example on the PyTorch port (the paper is an
INFERENCE-mapping paper, so the end-to-end example is a serving loop):
batched requests against a reduced LM, served by the
`repro_torch.serving` continuous-batching engine.

Run:  PYTHONPATH=src python examples/torch_serve_llm.py [--arch yi-9b]
          [--engine] [--device cpu]

``--engine`` switches from the fixed-shape batch to a mixed-length request
trace with continuous slot admission and per-request TTFT reporting.
"""
import argparse

import torch

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--engine", action="store_true",
                    help="mixed-length trace through the continuous-"
                         "batching engine (per-request TTFT/tok-s)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        ap.error("--device cuda needs a CUDA device; pass --device cpu to "
                 "run on the CPU")
    argv = ["--arch", args.arch, "--reduce", "--requests", "8",
            "--prompt-len", "32", "--gen-len", "16", "--device", args.device]
    if args.engine:
        argv += ["--engine", "--max-batch", "4"]
    return serve.main(argv)


if __name__ == "__main__":
    main()
