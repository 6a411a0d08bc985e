#!/usr/bin/env python
"""Paper §IV on the PyTorch port — tune the 2conv+2fc CNN's five
hyperparameters, then compare proposers on equal budgets (the experiment
behind Figs. 4/5).  The twin of ``examples/cnn_hpo.py``.

Each job genuinely trains the CNN (``repro_torch.train.cnn``, synthetic MNIST
stand-in) and reports test accuracy.  Hyperband/BOHB allocate
``n_iterations`` adaptively.

    PYTHONPATH=src python examples/cnn_hpo_torch.py --proposers random,tpe --n-samples 6 \\
        [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.experiment import Experiment  # noqa: E402
from repro_torch.train.cnn import train_cnn  # noqa: E402

SPACE = [
    {"name": "conv1", "type": "int", "range": [4, 24]},
    {"name": "conv2", "type": "int", "range": [8, 32]},
    {"name": "fc1", "type": "int", "range": [16, 96]},
    {"name": "dropout", "type": "float", "range": [0.0, 0.5]},
    {"name": "learning_rate", "type": "float", "range": [3e-4, 3e-2], "scale": "log"},
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--proposers", default="random,tpe")
    ap.add_argument("--n-samples", type=int, default=6)
    ap.add_argument("--n-parallel", type=int, default=2)
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--db", default="", help="sqlite tracking db path")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where jobs train (default cuda)")
    args = ap.parse_args()

    def job(config):
        return train_cnn(config, n_train=args.n_train, n_test=256, batch=64,
                         device=args.device)

    for proposer in args.proposers.split(","):
        exp_cfg = {
            "proposer": proposer,
            "parameter_config": SPACE,
            "n_samples": args.n_samples,
            "n_parallel": args.n_parallel,
            "target": "max",
            "random_seed": 0,
            "max_iter": 4, "eta": 2,          # hyperband/bohb budget geometry
        }
        if args.db:
            exp_cfg["db_path"] = args.db
        t0 = time.time()
        best = Experiment(exp_cfg, job).run()
        cfg = {k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in best["config"].items() if k in
               ("conv1", "conv2", "fc1", "dropout", "learning_rate")}
        print(f"{proposer:10s} best test-acc {best['score']:.3f} in "
              f"{time.time()-t0:5.1f}s  config={cfg}")


if __name__ == "__main__":
    main()
