"""Reproduce the paper's Fig. 4-style Pareto sweep (accuracy vs modeled
latency / energy on the DIANA cost models) on a synthetic
CIFAR-10-geometry task, with the PyTorch port's search on ``--device``.
Writes experiments/paper_torch/results_<preset>.json.

Run:  PYTHONPATH=src python examples/torch_pareto_sweep.py --preset quick
          [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_paper_experiments  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="quick")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    results = torch_paper_experiments.main(["--preset", args.preset,
                                            "--device", args.device])
    odimo = [r for r in results if r["kind"].startswith("odimo")]
    base = [r for r in results if r["kind"] == "baseline"]
    print(f"\nPareto points: {len(odimo)} ODiMO, {len(base)} baselines")
    print("Higher lambda => cheaper mapping (more AIMC channels):")
    for r in sorted(odimo, key=lambda r: r.get("lam", 0)):
        if r["kind"] == "odimo_diana":
            print(f"  lam={r['lam']:.0e} obj={r['objective']:>7s} "
                  f"acc={r['accuracy']:.3f} lat={r['latency']:.3e} "
                  f"en={r['energy']:.3e} A.Ch={r['aimc_ch']:.0%}")
    return results


if __name__ == "__main__":
    main()
