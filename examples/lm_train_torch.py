#!/usr/bin/env python
"""End-to-end LM training driver demo on the PyTorch port.

Trains a reduced config of any assigned architecture on the deterministic
synthetic LM stream through ``repro_torch.launch.train`` (checkpointing and
auto-resume), then proves fault tolerance by crashing mid-run and resuming.
The twin of ``examples/lm_train.py``.

    PYTHONPATH=src python examples/lm_train_torch.py --arch gemma2-9b --steps 60
    PYTHONPATH=src python examples/lm_train_torch.py --demo-crash --device cpu
"""
import argparse
import os
import subprocess
import sys
import tempfile

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the run trains (default cuda)")
    ap.add_argument("--demo-crash", action="store_true",
                    help="inject a failure mid-run, then auto-resume")
    args = ap.parse_args()

    env = dict(os.environ, PYTHONPATH=SRC)
    ckpt = tempfile.mkdtemp(prefix="lm_train_ckpt_")
    base = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", args.arch, "--smoke", "--device", args.device,
        "--steps", str(args.steps), "--batch", str(args.batch), "--seq", str(args.seq),
        "--ckpt-dir", ckpt, "--ckpt-every", str(max(args.steps // 4, 1)),
    ]
    if args.demo_crash:
        fail_at = args.steps * 3 // 4
        print(f"=== run 1: will crash at step {fail_at} ===")
        r = subprocess.run(base + ["--fail-at", str(fail_at)], env=env)
        assert r.returncode == 17, "expected the injected failure"
        print("\n=== run 2: same command resumes from the checkpoint ===")
        r = subprocess.run(base, env=env)
        sys.exit(r.returncode)
    else:
        r = subprocess.run(base, env=env)
        sys.exit(r.returncode)


if __name__ == "__main__":
    main()
