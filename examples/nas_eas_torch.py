#!/usr/bin/env python
"""Paper §V on the PyTorch port — EAS-style NAS as a Proposer.  The twin of
``examples/nas_eas.py``.

The RL meta-controller (REINFORCE over widen/deepen morphisms) runs as a
Proposer; each child architecture trains as an ordinary job
(``repro_torch.train.cnn``) with a net2net warm start from the incumbent
(the ``arch_parent`` aux key).  Architecture evolution happens entirely
through the standard get_param()/update() interface.

    PYTHONPATH=src python examples/nas_eas_torch.py --episodes 2 --children 3 [--device cpu]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.experiment import Experiment  # noqa: E402
from repro_torch.train.cnn import train_cnn  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--children", type=int, default=3)
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where jobs train (default cuda)")
    args = ap.parse_args()

    def job(config):
        # each child is a CNN defined by its arch string; warm-started when
        # arch_parent is present
        return train_cnn(dict(config, n_iterations=args.epochs),
                         n_train=args.n_train, n_test=256, batch=64, device=args.device)

    exp = Experiment(
        {"proposer": "eas", "parameter_config": [], "target": "max",
         "random_seed": 0, "n_parallel": args.children,
         "n_episodes": args.episodes, "children_per_episode": args.children},
        job,
    )
    t0 = time.time()
    best = exp.run()
    arch = json.loads(best["config"]["arch"])
    print(f"\nfound architecture in {time.time()-t0:.1f}s: "
          f"conv={arch['conv']} fc={arch['fc']}  test-acc={best['score']:.3f}")
    print(f"jobs run: {len(exp.job_log)} "
          f"({sum(1 for j in exp.job_log if j.status.value == 'finished')} finished)")


if __name__ == "__main__":
    main()
