"""The ranks of ``tests/test_torch_sharded.py``'s population meshes, and
the CLI rank of ``tests/test_torch_mesh_pool.py``'s ``torchrun`` case.

Each function here is the body of one spawned rank: it joins a gloo group
through a ``file://`` store, runs its part of the experiment on the CPU and
saves what it saw to ``out_dir/rank{r}.pt`` (its traceback to
``rank{r}.err`` if it raised).  They live outside the test modules so that a
spawned interpreter imports only this file, the port and torch (never JAX).
Run as a script it is one rank of the port's CLI under ``torchrun``.
"""
import os
import traceback

import numpy as np
import torch

ARCH = "starcoder2-3b"
SEQ, BATCH = 16, 2
STEPS_PER_UNIT = 2
LANES = 8
# (cell name, chunk_steps, device_rules, data_ring): the sharded cells of the
# JAX package's engine matrix (tests/test_engine_matrix.py)
CELLS = [
    ("sharded-perstep-host", 1, False, False),
    ("sharded-perstep-device", 1, True, False),
    ("sharded-chunked-host", 8, False, False),
    ("sharded-chunked-device", 8, True, False),
    ("sharded-chunked-ring", 8, False, True),
]


def ladder(n=6):
    """The JAX harness's seeded workload (tests/harness.py::ladder)."""
    lrs = np.geomspace(3e-4, 4e-3, n)
    budgets = ([1, 2, 4, 1, 2, 4] * ((n + 5) // 6))[:n]
    return [{"learning_rate": float(lr), "stream": i, "n_iterations": int(b)}
            for i, (lr, b) in enumerate(zip(lrs, budgets))]


def trial(chunk, device, ring, arch=ARCH):
    from repro_torch.core.proposer.early_stop import InFlightSuccessiveHalving
    from repro_torch.launch import hpo

    return hpo.PopulationTrial(arch, steps=STEPS_PER_UNIT, batch=BATCH, seq=SEQ, seed=0,
                               population=LANES,
                               early_stop=InFlightSuccessiveHalving(eta=2.0, min_iter=2,
                                                                    max_iter=8),
                               refill_idle_grace_s=0.0, chunk_steps=chunk,
                               device_rules=device, data_ring=ring, ring_windows=2,
                               device="cpu")


def batch_cell(cfgs, chunk, device, ring, mesh=None, arch=ARCH):
    t = trial(chunk, device, ring, arch)
    scores = t.run_population(list(cfgs), mesh=mesh)
    return {"scores": scores, "n_truncated": t.early_stop.n_truncated,
            "n_reclaimed": t.early_stop.n_reclaimed, "train_steps": t.n_train_steps}


def streaming_cell(cfgs, chunk, device, ring, mesh=None, arch=ARCH):
    from repro_torch.core.resource.vectorized import QueueFeedScheduler

    t = trial(chunk, device, ring, arch)
    if mesh is not None and mesh.rank != 0:
        assert t.run_population([], mesh=mesh) == []
        return None
    feed = QueueFeedScheduler(list(cfgs))
    t.run_population([], mesh=mesh, scheduler=feed)
    n = len(cfgs)
    return {"scores": feed.ordered_scores(n),
            "steps": [feed.extras[i]["steps"] for i in range(n)],
            "diverged": [feed.extras[i]["diverged"] for i in range(n)],
            "n_truncated": t.early_stop.n_truncated, "n_reclaimed": t.early_stop.n_reclaimed,
            "train_steps": t.n_train_steps}


def patch_init(state):
    """Every trial starts from ``state`` (one lane's train state, the JAX
    package's init of the seed, so the cells compare with JAX's)."""
    from repro_torch.interop import tree_map
    from repro_torch.train import train_step as ts

    ts.init_train_state = lambda gen, tc, device: tree_map(lambda t: t.to(device, copy=True),
                                                           state)
    ts.init_params = lambda gen, tc, device: tree_map(lambda t: t.to(device, copy=True),
                                                      state["params"])


def _join(rank, world, store, timeout_s):
    from repro_torch.distributed.sharding import population_mesh

    torch.set_num_threads(1)
    return population_mesh("cpu", init_method=f"file://{store}", rank=rank,
                           world_size=world, timeout_s=timeout_s)


def _run(body, rank, out_dir, *args):
    try:
        got = body(rank, out_dir, *args)
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def matrix_rank(rank, world, store, out_dir, init_path, lane_path, timeout_s):
    """Every sharded cell in both protocols, then the lane-op sequence."""
    _run(_matrix, rank, out_dir, world, store, init_path, lane_path, timeout_s)


def _matrix(rank, out_dir, world, store, init_path, lane_path, timeout_s):
    mesh = _join(rank, world, store, timeout_s)
    try:
        from repro_torch.kernels import rmsnorm

        patch_init(torch.load(init_path))
        out = cells(ARCH, mesh)
        out["rmsnorm_mesh_ranks"] = rmsnorm.mesh_ranks
        out["lane_ops"] = lane_ops(mesh, torch.load(lane_path))
        return out
    finally:
        mesh.destroy()


def arch_matrix_rank(rank, world, store, out_dir, arch, timeout_s):
    """Every sharded cell in both protocols for ``arch`` (the port's own
    init of the seed in every trial)."""
    _run(_arch_matrix, rank, out_dir, world, store, arch, timeout_s)


def _arch_matrix(rank, out_dir, world, store, arch, timeout_s):
    mesh = _join(rank, world, store, timeout_s)
    try:
        return cells(arch, mesh)
    finally:
        mesh.destroy()


def cells(arch, mesh=None):
    """Every cell of ``CELLS`` in both protocols on the ``ladder(6)``
    workload, on ``mesh`` (None: the vmapped engine on one device)."""
    cfgs = ladder(6)
    out = {"batch": {}, "streaming": {}}
    for name, chunk, device, ring in CELLS:
        out["batch"][name] = batch_cell(cfgs, chunk, device, ring, mesh, arch)
        out["streaming"][name] = streaming_cell(cfgs, chunk, device, ring, mesh, arch)
    return out


def lane_ops(mesh, spec):
    """The lane-op sequence of ``spec`` (a global population state, fresh
    init parameters by index, the ops) through the sharded lane ops: after
    each op, the whole state gathered (rank 0 keeps it), and the snapshot
    rank 0 received."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.interop import tree_map
    from repro_torch.train import population as P
    from repro_torch.train import train_step as ts

    fresh = spec["fresh"]
    ts.init_params = lambda g, tc, device: tree_map(lambda t: t.clone(), fresh[g])
    tc = TrainConfig(model=get_smoke_config(ARCH), parallel=ParallelConfig(remat="none"),
                     total_steps=8)
    k = spec["state"]["diverged"].shape[0]
    st = P.shard_population_state(spec["state"], mesh)
    op = {kind: P.get_lane_op(tc, k, kind, mesh=mesh) for kind in
          ("clone", "splice", "init", "snapshot", "restore")}
    states, snap = [], None
    for kind, args in spec["ops"]:
        if kind == "clone":
            op["clone"](st, np.asarray(args[0]), np.asarray(args[1]))
        elif kind == "splice":
            op["splice"](st, args[0], args[1])
        elif kind == "init":
            op["init"](st, np.asarray(args[0]), list(range(k)))
        elif kind == "snapshot_restore":
            snap = op["snapshot"](st, args[0])
            op["restore"](st, args[1], snap)
            if snap is not None:
                snap = tree_map(lambda t: torch.as_tensor(t).clone(), snap)
        states.append(tree_map(lambda t: t.clone(), mesh.all_gather_lanes(st)))
    return {"states": states if mesh.rank == 0 else None, "snapshot": snap}


def concurrent_rank(rank, world, store, out_dir, timeout_s):
    """Rank 0 runs two batch flights from two threads at once (as a partial
    batch may flush while another flight trains); the other ranks serve
    two flights.  Rank 0 keeps both flights' scores and each flight's
    scores run alone."""
    _run(_concurrent, rank, out_dir, world, store, timeout_s)


def _concurrent(rank, out_dir, world, store, timeout_s):
    import threading

    from repro_torch.launch.flight import serve

    mesh = _join(rank, world, store, timeout_s)
    cfgs = ladder(6)
    halves = (cfgs[:3], cfgs[3:])
    try:
        if rank != 0:
            for _ in range(4):
                serve(trial(1, False, False), mesh, flights=1)
            return None
        got = [None, None]

        def run(i):
            got[i] = trial(1, False, False).run_population(halves[i], mesh=mesh)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        alone = [trial(1, False, False).run_population(h, mesh=mesh) for h in halves]
        return {"together": got, "alone": alone}
    finally:
        mesh.destroy()


def dying_rank(rank, world, store, out_dir, timeout_s):
    """Rank 1 dies as rank 0's first flight opens; rank 0 must raise."""
    _run(_dying, rank, out_dir, world, store, timeout_s)


def _dying(rank, out_dir, world, store, timeout_s):
    mesh = _join(rank, world, store, timeout_s)
    cfgs = ladder(2)
    if rank == 1:
        mesh.broadcast_object(None)   # the flight's "begin"
        os._exit(3)
    try:
        batch_cell(cfgs, 1, False, False, mesh)
    except Exception as e:   # the point of the test: rank 0 raised, and why
        return {"raised": f"{type(e).__name__}: {e}"}
    return {"raised": None}


if __name__ == "__main__":
    # a rank of the port's CLI started by torchrun, from the JAX init weights
    # saved at argv[1]:  torchrun ... tests/torch_mesh_ranks.py INIT.pt ARGS...
    import sys

    from repro_torch.launch import hpo

    torch.set_num_threads(1)
    patch_init(torch.load(sys.argv[1]))
    sys.exit(hpo.main(sys.argv[2:]))
