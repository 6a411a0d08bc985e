"""End-to-end training driver for one trial, on the PyTorch port.

Runs a training loop with the port's train step: synthetic deterministic
data, atomic async checkpointing, auto-resume, and optional fault injection
to exercise the restart path.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b --smoke \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1 [--device cpu]
    # kill it mid-run; rerun the same command -> resumes from the last step.

The flags, the printed lines and the final JSON are those of ``python -m
repro.launch.train``.  ``--smoke`` selects the reduced config (CPU-trainable);
without it the published config is trained.  ``--fail-at N`` simulates a
crash at step N (exit code 17), after the pending checkpoint write has
finished.  The run goes on ``cuda`` unless ``--device cpu`` is given;
without a GPU it raises rather than fall back.  One card only: ``--devices``
above 1 is refused until the trial mesh is ported (ROADMAP.md item 12(b)).

Resume follows the JAX driver: the checkpoint taken after step ``s`` holds
the state after ``s + 1`` updates and is stored as step ``s``, and the
resumed loop starts at ``s``, so batch ``s`` is applied a second time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch


def build(args, model=None):
    """``(tc, data, step, device)``: the train config, the synthetic data, the
    one-trial train step and the device, from the CLI's ``args``.  ``model``
    (a ``ModelConfig``) replaces the config ``--arch`` / ``--smoke`` name,
    for a caller that cuts the depth; ``--vocab`` applies to it too."""
    from ..configs import get_config, get_smoke_config
    from ..configs.base import ParallelConfig, TrainConfig
    from ..data.pipeline import SyntheticLM
    from ..train.train_step import make_train_step
    from .hpo import resolve_device

    device = resolve_device(args.device)
    cfg = model or (get_smoke_config(args.arch) if args.smoke else get_config(args.arch))
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab_size=args.vocab)
    pc = ParallelConfig(microbatch=args.microbatch, remat=args.remat)
    tc = TrainConfig(
        model=cfg,
        parallel=pc,
        learning_rate=args.lr,
        warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps,
        seed=args.seed,
    )
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    return tc, data, make_train_step(tc), device


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="starcoder2-3b")
    p.add_argument("--smoke", action="store_true", help="reduced config (CPU-trainable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--vocab", type=int, default=0, help="override vocab (0 = config)")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--microbatch", type=int, default=0)
    p.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    p.add_argument("--devices", type=int, default=0,
                   help="devices for the trial (the port trains on one)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the trial trains (default cuda; without a GPU the "
                        "driver raises unless cpu is asked for)")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--fail-at", type=int, default=0, help="simulate a crash at this step")
    return p


def main(argv=None, model=None) -> int:
    """The CLI; ``model`` as in ``build``."""
    p = parser()
    args = p.parse_args(argv)
    if args.devices > 1:
        p.error("--devices above 1 is not ported to the PyTorch package yet; it "
                "comes with ROADMAP.md section 1, item 12(b) (the trial mesh)")

    from ..checkpoint.checkpointer import Checkpointer
    from ..interop import tree_map
    from ..train.train_step import init_train_state

    tc, data, step_fn, device = build(args, model)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    state = None
    if ckpt is not None and ckpt.latest_step() is not None:
        restored, manifest = ckpt.restore()
        state = tree_map(lambda t: t.to(device), restored)   # each leaf in its dtype
        start = int(manifest["step"])
        print(f"resumed from checkpoint at step {start}")
    if state is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = init_train_state(gen, tc, device)

    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        if args.fail_at and step == args.fail_at:
            if ckpt is not None:
                # the write a background thread may still be making is the
                # one a resume must find: finish it before the "crash"
                ckpt.wait()
            print(f"simulated failure at step {step}", file=sys.stderr)
            return 17  # distinct exit code: "injected failure"
        state, metrics = step_fn(state, data.make_batch(step))
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            print(f"step {step:5d}  loss {loss:.4f}  lr {float(metrics['lr']):.2e}  "
                  f"acc {float(metrics.get('accuracy', 0.0)):.3f}  [{dt:.1f}s]", flush=True)
        if ckpt is not None and step > 0 and step % args.ckpt_every == 0:
            ckpt.save_async(step, state, {"loss": float(metrics["loss"])})
    if ckpt is not None:
        ckpt.wait()
        ckpt.save(args.steps, state)
    print(json.dumps({"final_loss": losses[-1] if losses else None,
                      "first_loss": losses[0] if losses else None,
                      "steps": args.steps, "seconds": round(time.time() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
