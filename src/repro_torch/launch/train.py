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
crash at step N (exit code 17, on every rank), after the pending checkpoint
write has finished.  The run goes on ``cuda`` unless ``--device cpu`` is
given; without a GPU it raises rather than fall back.

``--devices N`` trains the trial over a trial mesh: ``make_trial_mesh(N)``'s
``(data, model)`` grid of ``torch.distributed`` ranks, each storing its
block of every leaf as the JAX package's ``build_sharding`` places it, the
math that of ``--devices 1`` (``train_step.make_sharded_train_step``).
Under ``torchrun`` (or an initialised group) the world is the mesh, and a
``--devices`` that differs from it is refused.  Otherwise the driver starts
one rank per visible GPU, up to N (JAX's ``min(--devices, devices)``: on
one card, or on the CPU, the run goes on one rank and says so):

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
        --device cpu --smoke --devices 2 --steps 8 --batch 4 --seq 32

Rank 0 prints the lines and writes the checkpoints: the whole state,
gathered leaf by leaf, in ``--devices 1``'s format, so a run resumes at
another N (every rank reads it and keeps its blocks).

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


def build(args, model=None, mesh=None):
    """``(tc, data, step, device)``: the train config, the synthetic data, the
    one-trial train step and the device, from the CLI's ``args``.  ``model``
    (a ``ModelConfig``) replaces the config ``--arch`` / ``--smoke`` name,
    for a caller that cuts the depth; ``--vocab`` applies to it too.  On a
    trial ``mesh`` the step is the sharded one (its ``layout`` inits,
    gathers and cuts the state) and the device the rank's."""
    from ..configs import get_config, get_smoke_config
    from ..configs.base import ParallelConfig, TrainConfig
    from ..data.pipeline import SyntheticLM
    from ..train.train_step import make_sharded_train_step, make_train_step
    from .hpo import resolve_device

    device = resolve_device(args.device) if mesh is None else mesh.device
    cfg = model or (get_smoke_config(args.arch) if args.smoke else get_config(args.arch))
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab_size=args.vocab)
    shape = (1, 1) if mesh is None else (mesh.rows, mesh.width)
    pc = ParallelConfig(mesh_shape=shape, microbatch=args.microbatch, remat=args.remat)
    tc = TrainConfig(
        model=cfg,
        parallel=pc,
        learning_rate=args.lr,
        warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps,
        seed=args.seed,
    )
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    step = make_train_step(tc) if mesh is None else make_sharded_train_step(tc, mesh)
    return tc, data, step, device


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
    p.add_argument("--devices", type=int, default=0, help="devices for the trial mesh")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the trial trains (default cuda; without a GPU the "
                        "driver raises unless cpu is asked for)")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--fail-at", type=int, default=0, help="simulate a crash at this step")
    return p


def _world(p, args):
    """The trial mesh's size when this process is a rank of a process group:
    its world (a ``--devices`` that differs is refused); 0 for no mesh or
    no group (``main`` then starts the ranks)."""
    import os

    import torch.distributed as dist

    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        world = dist.get_world_size() if dist.is_initialized() else int(os.environ["WORLD_SIZE"])
        if args.devices and args.devices != world:
            p.error(f"--devices {args.devices} differs from the process group's world of "
                    f"{world} ranks")
        return world if world > 1 else 0
    return 0


def main(argv=None, model=None) -> int:
    """The CLI; ``model`` as in ``build``."""
    p = parser()
    args = p.parse_args(argv)
    from .hpo import _ranks_to_spawn, _spawn_ranks, resolve_device

    world = _world(p, args)
    if args.devices > 1 and not world:
        visible = _ranks_to_spawn(str(resolve_device(args.device).type))
        n = min(args.devices, visible)
        if n < args.devices:
            print(f"--devices {args.devices}: {visible} {args.device} device(s) visible; "
                  f"the trial trains on {n}", file=sys.stderr)
        if n > 1:
            import functools

            import torch.multiprocessing as mp

            # the ranks' world is n: their argv says so (the last flag wins)
            ranks_argv = list(sys.argv[1:] if argv is None else argv) + ["--devices", str(n)]
            try:
                return _spawn_ranks(ranks_argv, n, target=functools.partial(main, model=model))
            except mp.ProcessExitedException as e:   # --fail-at's 17 on every rank
                return e.exit_code
    mesh = None
    if world:
        from .mesh import make_trial_mesh

        resolve_device(args.device)   # no GPU and no --device cpu: raise, as one device does
        mesh = make_trial_mesh(world, device=args.device)
    try:
        return _train(args, model, mesh)
    finally:
        if mesh is not None:
            mesh.destroy()


def _train(args, model, mesh) -> int:
    from ..checkpoint.checkpointer import Checkpointer
    from ..interop import tree_map
    from ..train.train_step import init_train_state

    tc, data, step_fn, device = build(args, model, mesh)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    state = None
    if ckpt is not None and ckpt.latest_step() is not None:
        restored, manifest = ckpt.restore()
        if mesh is None:
            state = tree_map(lambda t: t.to(device), restored)   # each leaf in its dtype
        else:
            state = step_fn.layout.shard(restored)
        del restored
        start = int(manifest["step"])
        say(f"resumed from checkpoint at step {start}")
    if state is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = (init_train_state(gen, tc, device) if mesh is None
                 else step_fn.layout.init_state(gen))

    def save(step, extra=None, wait=False):
        """The whole state to the checkpoint (rank 0 writes it; on a mesh every
        rank joins the gather)."""
        whole = state if mesh is None else step_fn.layout.gather(state, to_host=True,
                                                                 keep=lead)
        if lead:
            (ckpt.save if wait else ckpt.save_async)(step, whole, extra)

    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        if args.fail_at and step == args.fail_at:
            if ckpt is not None and lead:
                # the write a background thread may still be making is the
                # one a resume must find: finish it before the "crash"
                ckpt.wait()
            if mesh is not None:
                mesh.barrier()
            if lead:
                print(f"simulated failure at step {step}", file=sys.stderr)
            return 17  # distinct exit code: "injected failure"
        state, metrics = step_fn(state, data.make_batch(step))
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            say(f"step {step:5d}  loss {loss:.4f}  lr {float(metrics['lr']):.2e}  "
                f"acc {float(metrics.get('accuracy', 0.0)):.3f}  [{dt:.1f}s]", flush=True)
        if ckpt is not None and step > 0 and step % args.ckpt_every == 0:
            save(step, {"loss": float(metrics["loss"])})
    if ckpt is not None:
        if lead:
            ckpt.wait()
        save(args.steps, wait=True)
    say(json.dumps({"final_loss": losses[-1] if losses else None,
                    "first_loss": losses[0] if losses else None,
                    "steps": args.steps, "seconds": round(time.time() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
