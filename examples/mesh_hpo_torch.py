#!/usr/bin/env python
"""HPO over mesh slices on the PyTorch port — the paper's Resource Manager
adapted to device grids.  The twin of ``examples/mesh_hpo.py``.

Part 1 (virtual): a 16x16 "pod" is tiled into 4x4 slices (16 concurrent
trials); jobs simulate training and the elastic wrapper injects a slice
failure + a scale-out mid-experiment — the EC2-autoscaling story of paper
Fig. 3, on a device grid.

Part 2 (real device): the card (or, with ``--device cpu``, the CPU) forms a
1x1 slice; each trial trains a tiny LM (the starcoder2-3b smoke config) on
the device its slice hands out.

Part 3 (with ``--model-parallel W``): W gloo ranks on that device form one
lane row of a two-level ``(pop, model)`` population mesh, and a population
of the same tiny LM trains with every lane's heads and MLP split over the
row (``--shard-population --model-parallel W``); it prints the best final
loss beside the unsharded engine's and the model-group collectives a step.

    PYTHONPATH=src python examples/mesh_hpo_torch.py [--device cpu] [--model-parallel 2]
"""
import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.experiment import Experiment  # noqa: E402
from repro_torch.core.resource.elastic import ElasticResourceManager  # noqa: E402
from repro_torch.core.resource.mesh_pool import MeshPoolResourceManager, tile_pod  # noqa: E402

SPACE = [
    {"name": "learning_rate", "type": "float", "range": [1e-4, 1e-1], "scale": "log"},
    {"name": "warmup_frac", "type": "float", "range": [0.05, 0.5]},
]


def part1_virtual_pod():
    print("=== part 1: 16x16 virtual pod, 4x4 slices, failure + scale-out ===")
    rm = ElasticResourceManager(
        MeshPoolResourceManager(pod_shape=(16, 16), slice_shape=(4, 4), virtual=True)
    )
    print(f"pool: {rm.n_total()} slices of 16 chips")

    def trial(cfg, mesh_slice):
        time.sleep(0.02)
        import math
        return -(math.log10(cfg["learning_rate"]) + 2.5) ** 2 - cfg["warmup_frac"]

    exp = Experiment(
        {"proposer": "tpe", "parameter_config": SPACE, "n_samples": 32,
         "n_parallel": 16, "target": "max", "random_seed": 0, "max_retries": 3},
        trial, resource_manager=rm,
    )

    def chaos():
        time.sleep(0.1)
        victim = next(iter(rm.base.slices))
        print(f"  !! failing slice {victim} (its job is retried elsewhere)")
        rm.fail_resource(victim)
        time.sleep(0.1)
        extra = tile_pod((4, 4), (4, 4), virtual=True)[0]
        rm.base.slices["spare[0:4,0:4]"] = extra
        rm.scale_out(["spare[0:4,0:4]"])
        print("  ++ scaled out with a spare slice")

    threading.Thread(target=chaos, daemon=True).start()
    best = exp.run()
    done = sum(1 for j in exp.job_log if j.status.value == "finished")
    print(f"finished {done} trials despite failure; best lr="
          f"{best['config']['learning_rate']:.2e} score={best['score']:.3f}\n")


def part2_real_device(device: str):
    print("=== part 2: real-device slice trials (tiny LM train) ===")
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.launch.hpo import resolve_device
    from repro_torch.train.train_step import init_train_state, make_train_step

    rm = MeshPoolResourceManager(pod_shape=(1, 1), slice_shape=(1, 1),
                                 devices=[resolve_device(device)])

    def trial(cfg, mesh_slice):
        dev = mesh_slice.mesh()[0, 0]   # the slice's one device
        model = get_smoke_config("starcoder2-3b")
        tc = TrainConfig(model=model, parallel=ParallelConfig(),
                         learning_rate=float(cfg["learning_rate"]),
                         warmup_steps=2, total_steps=12)
        data = SyntheticLM(model.vocab_size, 32, 4, seed=0)
        state = init_train_state(torch.Generator(device=dev).manual_seed(0), tc, dev)
        step = make_train_step(tc)
        loss = None
        for s in range(12):
            state, m = step(state, to_device(data.make_batch(s), dev))
            loss = float(m["loss"])
        return -loss

    exp = Experiment(
        {"proposer": "random", "parameter_config": SPACE, "n_samples": 3,
         "n_parallel": 1, "target": "max", "random_seed": 0},
        trial, resource_manager=rm,
    )
    best = exp.run()
    print(f"best final loss {-best['score']:.3f} at lr={best['config']['learning_rate']:.2e}")


PART3_TRIALS = [{"learning_rate": lr, "warmup_frac": 0.25} for lr in (3e-3, 1e-3, 3e-4, 1e-4)]


def _part3_trial(device):
    from repro_torch.launch.hpo import PopulationTrial

    return PopulationTrial("starcoder2-3b", steps=4, batch=2, seq=32, seed=0,
                           population=len(PART3_TRIALS), device=device)


def _part3_rank(rank, width, device, store, out):
    import torch

    from repro_torch.distributed.sharding import population_mesh

    torch.set_num_threads(1)
    mesh = population_mesh(device, backend="gloo", init_method=f"file://{store}", rank=rank,
                           world_size=width, width=width)
    try:
        trial = _part3_trial(mesh.device)
        scores = trial.run_population(PART3_TRIALS, mesh=mesh)
        if rank == 0:
            out.put((scores, trial.model_axis_collectives))
    finally:
        mesh.destroy()


def part3_model_parallel(device: str, width: int):
    print(f"=== part 3: one lane row of width {width}, each lane tensor-parallel ===")
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.launch.hpo import resolve_device

    dev = str(resolve_device(device))
    if dev == "cuda":
        dev = "cuda:0"   # the ranks share the card: gloo, not NCCL
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_part3_rank,
                             args=(r, width, dev, os.path.join(tmp, "store"), out))
                 for r in range(width)]
        for p in procs:
            p.start()
        scores, collectives = out.get(timeout=600)
        for p in procs:
            p.join(60)
    if any(p.exitcode for p in procs):
        raise SystemExit(f"part 3: a rank failed (exit codes {[p.exitcode for p in procs]})")
    ref = _part3_trial(dev).run_population(PART3_TRIALS)
    print(f"best final loss {-max(scores):.4f} at width {width} (unsharded: {-max(ref):.4f}); "
          f"{collectives} model-group collectives a step")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="part 2's device (default cuda; without a GPU it raises "
                         "unless cpu is asked for)")
    ap.add_argument("--model-parallel", type=int, default=1, metavar="W",
                    help="also run part 3: a population on one lane row of W ranks, "
                         "each lane split W ways")
    args = ap.parse_args()
    part1_virtual_pod()
    part2_real_device(args.device)
    if args.model_parallel > 1:
        part3_model_parallel(args.device, args.model_parallel)
