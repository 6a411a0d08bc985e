"""The ranks of ``tests/test_torch_sharded.py``'s and
``tests/test_torch_model_parallel.py``'s population meshes, and the CLI rank
of the ``torchrun`` cases (``tests/test_torch_mesh_pool.py``,
``tests/test_torch_model_parallel_cli.py``).

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


def _join(rank, world, store, timeout_s, width=None):
    from repro_torch.distributed.sharding import population_mesh

    torch.set_num_threads(1)
    return population_mesh("cpu", init_method=f"file://{store}", rank=rank,
                           world_size=world, timeout_s=timeout_s, width=width)


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
    st = P.shard_population_state(spec["state"], mesh, tc)
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
    # at width 1 rank 0's gathered states are the whole population's; on a
    # two-level mesh every rank keeps its model position's shards of them
    keep = mesh.rank == 0 or mesh.width > 1
    return {"states": states if keep else None, "snapshot": snap}


# -- the two-level (pop, model) mesh ----------------------------------------------------

# (cell name, chunk_steps, device_rules, width): the tensor-parallel cells of
# the JAX package's engine matrix (tests/test_engine_matrix.py::TP_CELLS)
TP_CELLS = [
    ("tp2-perstep-host", 1, False, 2),
    ("tp2-chunked-host", 8, False, 2),
    ("tp2-chunked-device", 8, True, 2),
    ("tp4-perstep-host", 1, False, 4),
]


def _record_replicated(log):
    """Make every flight's close (on every rank) append, per leaf of its
    state that no width rule shards, the digest of its raw bytes."""
    import hashlib

    from repro_torch.interop import tree_leaves
    from repro_torch.launch import flight

    close = flight.LaneFlight._close

    def recording(fl):
        if fl.layout is not None and fl.state is not None:
            log.append([hashlib.sha1(t.detach().contiguous().view(torch.uint8).numpy()
                                     .tobytes()).hexdigest()
                        for t, d in zip(tree_leaves(fl.state), tree_leaves(fl.layout.dims))
                        if d is None])
        close(fl)

    flight.LaneFlight._close = recording


def tp_cells(arch, widths, meshes):
    """``TP_CELLS`` of the given widths in both protocols on the
    ``ladder(6)`` workload, each on ``meshes[width]``; with the model-group
    collectives a step issued."""
    cfgs = ladder(6)
    out = {"batch": {}, "streaming": {}, "collectives": {}}
    for name, chunk, device, width in TP_CELLS:
        if width not in widths:
            continue
        mesh = meshes[width]
        t = trial(chunk, device, False, arch)
        out["batch"][name] = dict(_batch(t, cfgs, mesh), collectives=t.model_axis_collectives)
        out["streaming"][name] = streaming_cell(cfgs, chunk, device, False, mesh, arch)
    return out


def _batch(t, cfgs, mesh):
    scores = t.run_population(list(cfgs), mesh=mesh)
    return {"scores": scores, "n_truncated": t.early_stop.n_truncated,
            "n_reclaimed": t.early_stop.n_reclaimed, "train_steps": t.n_train_steps}


def tp_rank(rank, world, store, out_dir, arch, widths, init_path, lane_path, timeout_s):
    """The tensor-parallel cells of ``widths`` for ``arch`` (every trial
    from the state at ``init_path``, or the port's init of the seed), the
    replicated leaves' digests after every flight, the RMSNorm backward's
    planned rows and, with ``lane_path``, the lane-op sequence at the first
    width."""
    _run(_tp, rank, out_dir, world, store, arch, widths, init_path, lane_path, timeout_s)


def _tp(rank, out_dir, world, store, arch, widths, init_path, lane_path, timeout_s):
    from repro_torch.distributed.sharding import population_mesh
    from repro_torch.kernels import rmsnorm

    meshes = {widths[0]: _join(rank, world, store, timeout_s, widths[0])}
    rows = {widths[0]: rmsnorm.mesh_ranks}
    for w in widths[1:]:
        meshes[w] = population_mesh("cpu", width=w, timeout_s=timeout_s)
        rows[w] = rmsnorm.mesh_ranks
    try:
        if init_path is not None:
            patch_init(torch.load(init_path))
        log = []
        _record_replicated(log)
        out = tp_cells(arch, widths, meshes)
        out["replicated"] = log
        out["rmsnorm_mesh_ranks"] = rows
        if lane_path is not None:
            out["lane_ops"] = lane_ops(meshes[widths[0]], torch.load(lane_path))
        return out
    finally:
        for w in widths[::-1]:
            meshes[w].destroy()


# the four kinds of seams: (name, arch, mixer or ffn kind)
SEAM_LAYERS = [("mlp", "starcoder2-3b"), ("gqa", "starcoder2-3b"),
               ("mla", "deepseek-v2-lite-16b"), ("mamba", "falcon-mamba-7b")]


def seam_layer(kind, cfg, params, x, positions):
    """One layer of ``kind`` on lane-batched ``params`` and ``x``."""
    from repro_torch.models import attention, mamba, mlp

    if kind == "mlp":
        return mlp.mlp_apply(params, x, cfg)
    if kind == "gqa":
        return attention.gqa_apply(params, x, cfg, positions)
    if kind == "mla":
        return attention.mla_apply(params, x, cfg, positions)
    return mamba.mamba_apply(params, x, cfg)


def layer_specs(kind, cfg):
    from repro_torch.models import attention, mamba, mlp

    return {"mlp": mlp.mlp_specs, "gqa": attention.gqa_specs, "mla": attention.mla_specs,
            "mamba": mamba.mamba_specs}[kind](cfg)


def shard_dims(kind, cfg, width):
    """Per parameter of the layer, the axis (lane axis counted) the width
    rules shard, or None."""
    from repro_torch.distributed.sharding import map_specs, tp_width_rules

    rules = tp_width_rules(cfg, width)
    specs = layer_specs(kind, cfg)
    return map_specs(specs, specs, lambda _, logical: next(
        (1 + i for i, n in enumerate(logical) if n in rules), None))


def seam_rank(rank, world, store, out_dir, layers_path, timeout_s):
    """Each layer of ``SEAM_LAYERS`` on this rank's shards of the weights at
    ``layers_path``, under the seams: its output, its input's gradient and
    its parameters' gradients (the rank's shards), for an upstream gradient
    given with the inputs."""
    _run(_seams, rank, out_dir, world, store, layers_path, timeout_s)


def _seams(rank, out_dir, world, store, layers_path, timeout_s):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import tp_module_flags, tp_shard_context
    from repro_torch.interop import tree_leaves, tree_map

    mesh = _join(rank, world, store, timeout_s, world)
    try:
        spec = torch.load(layers_path)
        out = {}
        for kind, arch in SEAM_LAYERS:
            cfg = get_smoke_config(arch)
            case = spec[kind]
            dims = shard_dims(kind, cfg, world)

            def take(t, d):
                if d is None:
                    return t.clone()
                n = t.shape[d] // world
                return t.narrow(d, rank * n, n).clone()

            params = tree_map(take, case["params"], dims)
            for t in tree_leaves(params):
                t.requires_grad_(True)
            x = case["x"].clone().requires_grad_(True)
            with tp_shard_context(mesh, tp_module_flags(cfg, world)):
                y = seam_layer(kind, cfg, params, x, case["positions"])
                (y * case["dy"]).sum().backward()
            out[kind] = {"y": y.detach(), "dx": x.grad,
                         "grads": tree_map(lambda t: t.grad, params)}
        return out
    finally:
        mesh.destroy()


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


# -- the trial mesh (one trial over a (data, model) grid) --------------------------------

TRIAL_SEQ, TRIAL_STEPS = 16, 3


def trial_tc(arch, model=None, parallel=None, **train):
    """A smoke trial's config: ``model`` / ``parallel`` override fields of
    the smoke model and of ``ParallelConfig(remat="full")``."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig

    cfg = dataclasses.replace(get_smoke_config(arch), **(model or {}))
    pc = ParallelConfig(**dict({"remat": "full"}, **(parallel or {})))
    return TrainConfig(model=cfg, parallel=pc, learning_rate=3e-3, warmup_steps=1,
                       total_steps=8, **train)


def trial_batches(tc, batch):
    from repro_torch.data.pipeline import SyntheticLM

    data = SyntheticLM(tc.model.vocab_size, TRIAL_SEQ, batch, seed=0)
    return [data.make_batch(t) for t in range(TRIAL_STEPS)]


def trial_run(step, state, batches):
    """``step`` over ``batches``: the state and each step's metrics (floats)."""
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def trial_rank(rank, world, store, out_dir, cases, timeout_s):
    """Each case of ``cases`` (dicts: ``name``, ``arch``, ``shape``,
    ``batch`` and ``trial_tc``'s overrides) on a trial mesh of ``world``
    ranks: three steps of the sharded step from the port's init of seed 0,
    then the whole state gathered; with ``raw_grads`` the first batch's
    gradient blocks gathered before their rounding; with ``rows`` the rows
    of each batch the rank's loss read.  Rank 0 keeps the gathered trees;
    every rank its blocks' shapes."""
    _run(_trial, rank, out_dir, world, store, cases, timeout_s)


def _trial(rank, out_dir, world, store, cases, timeout_s):
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.mesh import make_trial_mesh
    from repro_torch.train import train_step as ts

    torch.set_num_threads(1)
    out, meshes = {}, []
    for c in cases:
        mesh = make_trial_mesh(world, shape=c["shape"], device="cpu",
                               init_method=f"file://{store}", rank=rank, world_size=world,
                               timeout_s=timeout_s)
        meshes.append(mesh)
        tc = trial_tc(c["arch"], c.get("model"), c.get("parallel"), **c.get("train", {}))
        step = ts.make_sharded_train_step(tc, mesh)
        state = step.layout.init_state(torch.Generator().manual_seed(0))
        got = {"blocks": [tuple(t.shape) for t in tree_leaves(state)],
               "placements": step.layout.placements}
        batches = trial_batches(tc, c["batch"])
        if c.get("raw_grads"):
            got["raw_grads"] = gather_tree(step.raw_grads(state, batches[0]),
                                           step.layout.placements["params"], mesh)
        if c.get("rows"):
            seen, vg = [], ts._value_and_grad

            def recording(params, batch, tc, **shares):
                seen.append(batch["tokens"][0].clone())
                return vg(params, batch, tc, **shares)

            ts._value_and_grad = recording
        state, got["metrics"] = trial_run(step, state, batches)
        if c.get("rows"):
            ts._value_and_grad = vg
            got["rows"] = seen
        whole = step.layout.gather(state)
        if rank == 0:
            got["state"] = whole
        out[c["name"]] = got
    for mesh in meshes[::-1]:
        mesh.destroy()
    return out


def trial_cli_rank(rank, world, store, out_dir, argvs, timeout_s):
    """The port's train CLI (``launch/train.py::main``) on a gloo group of
    ``world`` CPU ranks joined here: each argv of ``argvs`` in turn, with its
    exit code (a refusal's too) and what it printed."""
    _run(_trial_cli, rank, out_dir, world, store, argvs, timeout_s)


def _trial_cli(rank, out_dir, world, store, argvs, timeout_s):
    import contextlib
    import datetime
    import io

    import torch.distributed as dist

    from repro_torch.launch import train

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    runs = []
    try:
        for argv in argvs:
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                try:
                    code = train.main(argv)
                except SystemExit as e:   # a refusal (argparse's error exit)
                    code = e.code
            runs.append({"code": code, "out": out.getvalue(), "err": err.getvalue()})
    finally:
        dist.destroy_process_group()
    return runs


# -- elastic regrid (--elastic-regrid) -----------------------------------------------

# (cell name, chunk_steps): the elastic cells of the JAX package's
# tests/test_elastic_regrid.py, vmapped and pooled alike
ELASTIC_CELLS = [("elastic-perstep", 1), ("elastic-chunked", 8)]
REPLICATED_ARCH = "qwen3-moe-30b-a3b"


def elastic_trial(chunk, arch=ARCH):
    t = trial(chunk, False, False, arch)
    t.elastic_regrid = True
    return t


def _elastic_record(t, pool):
    return {"n_truncated": t.early_stop.n_truncated, "n_reclaimed": t.early_stop.n_reclaimed,
            "train_steps": t.n_train_steps, "regrids": t.n_regrids,
            "lane_width_history": [list(x) for x in t.lane_width_history],
            "pool_widths": None if pool is None else list(pool.width_history),
            "regrid_log": list(t.regrid_log)}


def elastic_batch_cell(cfgs, chunk, mesh=None, pool=None, arch=ARCH):
    """The elastic batch protocol (the JAX harness's
    ``run_elastic_batch_cell``): the cohort rung rule with a regrid at each
    boundary where the survivors fit fewer lanes; with ``pool`` (rank 0 of
    ``mesh``) onto the pool's wider lane rows.  A rank above 0 serves."""
    t = elastic_trial(chunk, arch)
    if mesh is not None and mesh.rank != 0:
        t.run_population(list(cfgs), mesh=mesh)
        return {"regrid_log": list(t.regrid_log)}
    scores = t.run_population(list(cfgs), mesh=mesh, elastic=pool)
    return dict(_elastic_record(t, pool), scores=scores)


def elastic_streaming_cell(cfgs, chunk, mesh=None, pool=None, arch=ARCH):
    """The elastic streaming protocol (``run_elastic_streaming_cell``): a
    lane-refill flight whose tail regrids once the feed is closed and at
    most half the lanes are live."""
    from repro_torch.core.resource.vectorized import QueueFeedScheduler

    t = elastic_trial(chunk, arch)
    if mesh is not None and mesh.rank != 0:
        t.run_population([], mesh=mesh)
        return {"regrid_log": list(t.regrid_log)}
    feed = QueueFeedScheduler(list(cfgs))
    t.run_population([], mesh=mesh, scheduler=feed, elastic=pool)
    n = len(cfgs)
    return dict(_elastic_record(t, pool), scores=feed.ordered_scores(n),
                steps=[feed.extras[i]["steps"] for i in range(n)],
                diverged=[feed.extras[i]["diverged"] for i in range(n)])


def elastic_rank(rank, world, store, out_dir, timeout_s):
    """Every elastic cell in both protocols on ``world`` ranks, each flight
    with a fresh ``ElasticLanePool`` on rank 0; after each, the pool's mesh
    shape, and this rank's RMSNorm plan and current mesh (which a flight of
    another width must leave as it found them)."""
    _run(_elastic, rank, out_dir, world, store, timeout_s)


def _elastic(rank, out_dir, world, store, timeout_s):
    from repro_torch.core.resource.sharded import ElasticLanePool
    from repro_torch.distributed import sharding
    from repro_torch.kernels import rmsnorm

    mesh = _join(rank, world, store, timeout_s)
    try:
        cfgs = ladder(6)
        out = {"batch": {}, "streaming": {}, "after": []}
        for name, chunk in ELASTIC_CELLS:
            for protocol, cell in (("batch", elastic_batch_cell),
                                   ("streaming", elastic_streaming_cell)):
                pool = ElasticLanePool(mesh=mesh) if rank == 0 else None
                got = cell(cfgs, chunk, mesh, pool)
                if pool is not None:
                    got["pool_mesh_shape"] = pool.mesh().shape
                    got["pool_lease_ids"] = list(pool._lease_ids)
                    got["pool_total"] = pool.manager.n_total()
                out[protocol][name + "-pooled"] = got
                out["after"].append([rmsnorm.mesh_ranks, rmsnorm.planned_lanes,
                                     sharding._CURRENT is mesh])
        # qwen3-moe's smoke model shards nothing at width 4 (kv 2, experts
        # replicated): one trial of 8 steps, alone, survives the rung at 2
        # onto one row of 4 ranks, which replicate its lane
        pool = ElasticLanePool(mesh=mesh) if rank == 0 else None
        out["batch"]["replicated-pooled"] = elastic_batch_cell(
            cfgs[2:3], 1, mesh, pool, arch=REPLICATED_ARCH)
        return out
    finally:
        mesh.destroy()


# -- prefill and decode on a trial mesh (train/serve_step.py::ServeLayout) -------------

DECODE_BATCH, DECODE_PROMPT, DECODE_NEW, DECODE_MAX_SEQ = 4, 5, 3, 16


def decode_rank(rank, world, store, out_dir, cases, inputs_path, timeout_s):
    """Each case of ``cases`` (dicts: ``name``, ``arch``, ``shape``, ``long``)
    on a trial mesh of ``world`` ranks, from the whole smoke parameters and
    prompt in ``inputs_path`` (by arch): this rank's rows of the prefill's
    last logits, then the prompt fed a token a step and greedy tokens after
    it, each step's logits of its rows; its blocks of the final cache, its
    rows and the collectives by axis."""
    _run(_decode, rank, out_dir, world, store, cases, inputs_path, timeout_s)


def _decode(rank, out_dir, world, store, cases, inputs_path, timeout_s):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_trial_mesh
    from repro_torch.train.serve_step import ServeLayout

    torch.set_num_threads(1)
    inputs = torch.load(inputs_path)
    out, meshes = {}, []
    for c in cases:
        mesh = make_trial_mesh(world, shape=c["shape"], device="cpu",
                               init_method=f"file://{store}", rank=rank, world_size=world,
                               timeout_s=timeout_s)
        meshes.append(mesh)
        cfg = get_smoke_config(c["arch"])
        layout = ServeLayout(cfg, mesh, shard_cache_seq=c.get("long", False))
        params = layout.shard_params(inputs[c["arch"]]["params"])
        prompt = inputs[c["arch"]]["prompt"]
        rows = layout.rows(DECODE_BATCH, DECODE_MAX_SEQ)
        before = S.mesh_collectives()
        got = {"rows": (rows.start, rows.stop),
               "prefill": layout.prefill(params, prompt[layout.rows(DECODE_BATCH)]),
               "prefill_rows": layout.rows(DECODE_BATCH)}
        cache = layout.init_cache(DECODE_BATCH, DECODE_MAX_SEQ, torch.float32)
        tok, logits, tokens = prompt[rows, :1], [], []
        for pos in range(DECODE_PROMPT + DECODE_NEW - 1):
            step = layout.decode(params, cache, tok, pos, DECODE_BATCH, DECODE_MAX_SEQ)
            logits.append(step)
            nxt = torch.argmax(step[:, -1], dim=-1)[:, None].to(prompt.dtype)
            tok = prompt[rows, pos + 1:pos + 2] if pos + 1 < DECODE_PROMPT else nxt
            tokens.append(tok)
        got.update(decode=logits, tokens=tokens, cache=cache,
                   cache_placements=layout.cache_placements(DECODE_BATCH, DECODE_MAX_SEQ),
                   collectives={k: v["calls"] - before.get(k, {"calls": 0})["calls"]
                                for k, v in S.mesh_collectives().items()})
        out[c["name"]] = got
    for mesh in meshes[::-1]:
        mesh.destroy()
    return out


# -- the dry run's collectives against a real step's ---------------------------------


def collective_rank(rank, world, store, out_dir, arch, shape, seq, batch, timeout_s):
    """One step of the dry run's train cell (``launch/dryrun.py::lower_cell``
    at ``shape``, the smoke config of ``arch``, ``seq`` x ``batch``) on a
    trial mesh of gloo ranks: the collectives it made, by ``axis/op``."""
    _run(_collectives, rank, out_dir, world, store, arch, shape, seq, batch, timeout_s)


def _collectives(rank, out_dir, world, store, arch, shape, seq, batch, timeout_s):
    import dataclasses

    from repro_torch.configs import get_smoke_config, memory_policy
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_trial_mesh
    from repro_torch.launch.op_stats import CollectiveLog
    from repro_torch.train import train_step as ts

    torch.set_num_threads(1)
    mesh = make_trial_mesh(world, shape=shape, device="cpu", init_method=f"file://{store}",
                           rank=rank, world_size=world, timeout_s=timeout_s)
    cfg = get_smoke_config(arch)
    pc = dataclasses.replace(memory_policy(arch, ShapeConfig("t", seq, batch, "train")),
                             mesh_shape=tuple(shape), mesh_axes=("data", "model"))
    step = ts.make_sharded_train_step(TrainConfig(model=cfg, parallel=pc), mesh)
    state = step.layout.init_state(torch.Generator().manual_seed(0))
    b = SyntheticLM(cfg.vocab_size, seq, batch, seed=0).make_batch(0)
    b = {k: torch.as_tensor(np.asarray(v, np.float32 if k == "mask" else np.int32))
         for k, v in b.items()}
    with CollectiveLog() as log:
        step(state, b)
    mesh.destroy()
    return log.stats().by_axis
