"""The population mesh (``--shard-population``) on the CPU, over gloo.

Ranks are spawned with ``torch.multiprocessing`` and meet through a
``file://`` store in the test's temporary directory (so parallel test
workers never share a port); their bodies are in ``torch_mesh_ranks.py``.
Each spawn has a join deadline of its own, and each gloo group a collective
timeout below it, so a hung collective fails the test instead of the suite.
Every rank of a world starts from the JAX package's init weights of the
seed, as the vmapped cells computed here do.

Held here:

* every sharded cell of the JAX package's engine matrix (per step and
  chunked, host and device rules, ring-fed) in both protocols, at world
  sizes 2 and 4 on the ``ladder(6)`` workload, against the port's vmapped
  cells: scores within 1e-6, the same truncations, reclaims and steps, as
  ``tests/test_engine_matrix.py`` holds JAX; and two cells against JAX's
  sharded engine on its 8-virtual-device mesh within 1e-4;
* the same matrix for a MoE model with MLA (deepseek-v2-lite) and a Mamba
  model (falcon-mamba), against their vmapped cells;
* the sharded lane ops across ranks (a clone chain whose donors live on
  other ranks, splice, init, a snapshot harvested on one rank and restored
  into another) against the port's vmapped lane ops and JAX's
  ``make_lane_*``, bit for bit;
* ``pad_population`` and ``_check_rows`` against JAX's;
* ``ShardedPopulationResourceManager``'s slots and flush;
* that a rank dying mid-flight makes rank 0 raise, and the refusals of the
  two-level mesh and of elastic regrid.
"""
import os
import time

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro_torch import interop
from repro_torch.core.job import Job
from repro_torch.core.resource.sharded import ShardedPopulationResourceManager
from repro_torch.distributed.sharding import PopulationMesh, population_mesh
from repro_torch.train import population as P

torch.set_num_threads(2)

JOIN_S = 280.0          # each spawn's deadline
COLLECTIVE_S = 120.0    # each gloo group's timeout: below the deadline
WORLDS = (2, 4)
CELL_NAMES = [c[0] for c in R.CELLS]
ARCHS = ("deepseek-v2-lite-16b", "falcon-mamba-7b")   # MoE with MLA; Mamba
# global lanes; with 2 ranks lanes 0-3 | 4-7, with 4 ranks 0-1 | 2-3 | 4-5 | 6-7
LANE_OPS = [
    ("clone", ([True, False, False, False, False, True, True, False],
               [7, 1, 2, 3, 4, 1, 5, 7])),            # 0 <- 7, 5 <- 1, 6 <- 5 (a chain)
    ("splice", (6, 3)),                               # lane 6 from fresh params 3
    ("init", ([False, True, False, False, True, False, False, False],)),  # lanes 1, 4
    ("snapshot_restore", (5, 2)),                     # lane 5 harvested, restored into 2
]


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    return jax, jnp


def _jtc():
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import ParallelConfig as JaxParallelConfig
    from repro.configs.base import TrainConfig as JaxTrainConfig

    return JaxTrainConfig(model=jax_smoke_config(R.ARCH),
                          parallel=JaxParallelConfig(remat="none"), total_steps=8)


def _tc():
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig

    return TrainConfig(model=get_smoke_config(R.ARCH), parallel=ParallelConfig(remat="none"),
                       total_steps=8)


def _jax_init_state(jax):
    """One lane's train state as the JAX package inits the seed (every
    trial of the cells starts from it)."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.train.train_step import init_train_state as jax_init_train_state

    return interop.to_torch(jax.device_get(jax_init_train_state(
        jax.random.PRNGKey(0), JaxTrainConfig(model=jax_smoke_config(R.ARCH)))))


def _jax_population(jax, jnp, k=R.LANES):
    """A JAX population of K distinct lanes, with latches, last losses and
    step counters that differ by lane; the port's copy; JAX init params of
    fresh keys, by index."""
    from repro.train import population as JP
    from repro.train.train_step import init_train_state as jax_init_train_state

    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), i) for i in range(k)])
    jp = JP.init_population_state_from_keys(keys, _jtc())
    inner = dict(jp["inner"], opt=dict(jp["inner"]["opt"],
                                       step=jnp.arange(k, dtype=jp["inner"]["opt"]["step"].dtype)))
    jp = dict(jp, inner=inner, diverged=jnp.asarray([i % 3 == 1 for i in range(k)]),
              last_loss=jnp.asarray([1.5 + i for i in range(k)], jnp.float32))
    fresh_keys = [jax.random.fold_in(jax.random.PRNGKey(9), i) for i in range(k)]
    fresh = [jax.device_get(jax_init_train_state(kk, _jtc())["params"]) for kk in fresh_keys]
    return jp, interop.to_torch(jax.device_get(jp)), fresh_keys, \
        [interop.to_torch(f) for f in fresh]


def _start(world, root, target, *args):
    """Spawn ``world`` ranks of ``target`` (a function of torch_mesh_ranks)."""
    ctx = torch.multiprocessing.get_context("spawn")
    store = os.path.join(root, "store")
    procs = [ctx.Process(target=target, args=(r, world, store, root) + args, daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs, root, deadline_s=JOIN_S):
    """Wait for every rank until the deadline; kill and fail on a hang or a
    rank that raised.  Returns each rank's saved result."""
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        pytest.fail(f"ranks {hung} still running after the {deadline_s:.0f} s deadline")
    out = []
    for r, p in enumerate(procs):
        err = os.path.join(root, f"rank{r}.err")
        if os.path.exists(err):
            pytest.fail(f"rank {r} raised:\n{open(err).read()}")
        path = os.path.join(root, f"rank{r}.pt")
        out.append(torch.load(path, weights_only=False) if os.path.exists(path) else None)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every cell at world sizes 2 and 4 (spawned), the vmapped reference
    cells (here, while the ranks run), and the lane-op inputs."""
    jax, jnp = _jax()
    init = _jax_init_state(jax)
    jp, tp, fresh_keys, fresh = _jax_population(jax, jnp)
    root = tmp_path_factory.mktemp("mesh")
    init_path, lane_path = str(root / "init.pt"), str(root / "lanes.pt")
    torch.save(init, init_path)
    torch.save({"state": tp, "fresh": fresh, "ops": LANE_OPS}, lane_path)
    procs = {}
    for w in WORLDS:
        d = root / f"w{w}"
        d.mkdir()
        procs[w] = (_start(w, str(d), R.matrix_rank, init_path, lane_path, COLLECTIVE_S),
                    str(d))
    from repro_torch.train import train_step as ts

    saved = (ts.init_train_state, ts.init_params)
    R.patch_init(init)
    try:
        vmapped = R.cells(R.ARCH)
    finally:
        ts.init_train_state, ts.init_params = saved
    got = {w: _join(p, d) for w, (p, d) in procs.items()}
    return {"vmapped": vmapped, "sharded": got, "jp": jp, "tp": tp, "fresh": fresh,
            "fresh_keys": fresh_keys, "init": init}


@pytest.fixture(scope="module")
def arch_worlds(tmp_path_factory):
    """``ARCHS``' cells at world sizes 2 and 4 (spawned) and on one device
    (here, while the ranks run), each trial from the port's init of the
    seed."""
    root = tmp_path_factory.mktemp("mesh_archs")
    procs = {}
    for arch in ARCHS:
        for w in WORLDS:
            d = root / f"{arch}_w{w}"
            d.mkdir()
            procs[arch, w] = (_start(w, str(d), R.arch_matrix_rank, arch, COLLECTIVE_S),
                              str(d))
    vmapped = {arch: R.cells(arch) for arch in ARCHS}
    got = {key: _join(p, d) for key, (p, d) in procs.items()}
    return {"vmapped": vmapped, "sharded": got}


# -- the engine matrix: sharded against vmapped --------------------------------------


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", CELL_NAMES)
@pytest.mark.parametrize("protocol", ["batch", "streaming"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cells_match_vmapped(worlds, world, protocol, name):
    """Each sharded cell at 2 and 4 ranks against the same cell on one
    device: scores within 1e-6 (bit-equal on the CPU so far), the same
    rung cuts, reclaims and trained steps (streaming: the same per-trial
    steps and divergences)."""
    ref = worlds["vmapped"][protocol][name]
    got = worlds["sharded"][world][0][protocol][name]
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0, atol=1e-6)
    assert got["n_truncated"] == ref["n_truncated"]
    assert got["n_reclaimed"] == ref["n_reclaimed"]
    assert got["train_steps"] == ref["train_steps"]
    if protocol == "streaming":
        assert got["steps"] == ref["steps"]
        assert got["diverged"] == ref["diverged"]
    else:
        # every rank's run_population returns the same global list
        for r, rank in enumerate(worlds["sharded"][world][1:], 1):
            assert rank[protocol][name]["scores"] == got["scores"], r


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", CELL_NAMES)
@pytest.mark.parametrize("protocol", ["batch", "streaming"])
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_cells_match_vmapped_for_moe_and_mamba(arch_worlds, arch, world, protocol,
                                                       name):
    """The matrix for a MoE model with MLA and a Mamba model: each sharded
    cell against the same cell on one device, scores within 1e-6 and the
    same decisions (their per-lane reductions, the MoE load-balance loss
    among them, are each lane's own); every rank returns the same list."""
    ref = arch_worlds["vmapped"][arch][protocol][name]
    got = arch_worlds["sharded"][arch, world][0][protocol][name]
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0, atol=1e-6)
    for key in ("n_truncated", "n_reclaimed", "train_steps") + (
            ("steps", "diverged") if protocol == "streaming" else ()):
        assert got[key] == ref[key], key
    if protocol == "batch":
        for r, rank in enumerate(arch_worlds["sharded"][arch, world][1:], 1):
            assert rank[protocol][name]["scores"] == got["scores"], r


@pytest.mark.timeout(600)
@pytest.mark.parametrize("world", WORLDS)
def test_a_rank_plans_the_rmsnorm_backward_for_the_whole_population(worlds, world):
    """Every rank of an N-rank mesh plans the RMSNorm backward's rows for N
    times its lanes (the unsharded launch's plan) while the mesh lives."""
    assert [r["rmsnorm_mesh_ranks"] for r in worlds["sharded"][world]] == [world] * world


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name,chunk,device", [
    ("sharded-perstep-host", 1, False),
    ("sharded-chunked-device", 8, True),
])
def test_sharded_cells_match_jax_sharded_engine(worlds, name, chunk, device):
    """Two batch cells against the JAX package's sharded engine on its
    8-virtual-device population mesh (the same workload, the same init
    weights): scores within 1e-4, the same cuts and reclaims."""
    jax, _ = _jax()
    from harness import run_batch_cell
    from repro.distributed.sharding import population_mesh as jax_population_mesh

    if jax.device_count() < 2:
        pytest.skip("needs the multi-device (virtual CPU) JAX mesh")
    want = run_batch_cell(R.ladder(6), chunk=chunk, device=device, mesh=jax_population_mesh())
    for world in WORLDS:
        got = worlds["sharded"][world][0]["batch"][name]
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-4)
        assert got["n_truncated"] == want["n_truncated"]
        assert got["n_reclaimed"] == want["n_reclaimed"]


# -- lane ops across ranks ------------------------------------------------------------


_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _raw(t):
    t = torch.as_tensor(t).detach()
    return t.to(torch.uint8) if t.dtype == torch.bool else t.view(_INT_OF_SIZE[t.element_size()])


def _bits_equal(a, b):
    la, lb = interop.tree_leaves(a), interop.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(_raw(x), _raw(y)) for x, y in zip(la, lb))


def _vmapped_sequence(tp, fresh):
    """The lane-op sequence through the port's vmapped lane ops."""
    from repro_torch.train import train_step as ts

    st = interop.tree_map(lambda t: t.clone(), tp)
    k = st["diverged"].shape[0]
    tc = _tc()
    op = {kind: P.get_lane_op(tc, k, kind) for kind in
          ("clone", "splice", "init", "snapshot", "restore")}
    states, snap = [], None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts, "init_params",
                   lambda g, tc, device: interop.tree_map(lambda t: t.clone(), fresh[g]))
        for kind, args in LANE_OPS:
            if kind == "clone":
                op["clone"](st, np.asarray(args[0]), np.asarray(args[1]))
            elif kind == "splice":
                op["splice"](st, args[0], args[1])
            elif kind == "init":
                op["init"](st, np.asarray(args[0]), list(range(k)))
            else:
                snap = interop.tree_map(lambda t: torch.as_tensor(t).clone(),
                                        op["snapshot"](st, args[0]))
                op["restore"](st, args[1], snap)
            states.append(interop.tree_map(lambda t: t.clone(), st))
    return states, snap


def _jax_sequence(jax, jnp, jp, fresh_keys):
    """The lane-op sequence through JAX's ``make_lane_*``."""
    from repro.train import population as JP

    jtc = _jtc()
    k = len(fresh_keys)
    keys = jnp.stack(fresh_keys)
    states, snap = [], None
    for kind, args in LANE_OPS:
        if kind == "clone":
            jp = JP.make_lane_clone(jtc)(jp, jnp.asarray(args[0]),
                                         jnp.asarray(args[1], jnp.int32))
        elif kind == "splice":
            jp = JP.make_lane_splice(jtc)(jp, jnp.asarray(args[0], jnp.int32), keys[args[1]])
        elif kind == "init":
            jp = JP.make_lane_init(jtc)(jp, jnp.asarray(args[0]), keys[:k])
        else:
            snap = JP.make_lane_snapshot(jtc)(jp, jnp.asarray(args[0], jnp.int32))
            jp = JP.make_lane_restore(jtc)(jp, jnp.asarray(args[1], jnp.int32), snap)
        states.append(jax.device_get(jp))
    return states, jax.device_get(snap)


def _np_leaves(tree):
    return [np.asarray(x, np.float64) if np.asarray(x).dtype.kind == "f" else np.asarray(x)
            for x in interop.tree_leaves(interop.to_numpy(tree))]


def _jax_leaves(jax, tree):
    return [np.asarray(x, np.float64) if np.asarray(x).dtype.kind == "f" else np.asarray(x)
            for x in jax.tree.leaves(tree)]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("step", range(len(LANE_OPS)), ids=[o[0] for o in LANE_OPS])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_lane_ops_match_vmapped_and_jax_bitwise(worlds, world, step):
    """After each lane op of the sequence (a clone chain whose donors live
    on other ranks, a splice, a masked init, a snapshot harvested on one
    rank and restored into another), the gathered state equals the port's
    vmapped lane ops' and JAX's ``make_lane_*``, bit for bit; so does the
    snapshot rank 0 received."""
    jax, jnp = _jax()
    got = worlds["sharded"][world][0]["lane_ops"]
    want, snap = _vmapped_sequence(worlds["tp"], worlds["fresh"])
    assert _bits_equal(got["states"][step], want[step])
    jstates, jsnap = _jax_sequence(jax, jnp, worlds["jp"], worlds["fresh_keys"])
    for g, w in zip(_np_leaves(got["states"][step]), _jax_leaves(jax, jstates[step])):
        np.testing.assert_array_equal(g, w)
    if LANE_OPS[step][0] == "snapshot_restore":
        assert _bits_equal(got["snapshot"], snap)
        for g, w in zip(_np_leaves(got["snapshot"]), _jax_leaves(jax, jsnap)):
            np.testing.assert_array_equal(g, w)


# -- padding, rows, the resource manager, failures and refusals ----------------------


def _fake_mesh(n, rank=0):
    """A mesh's arithmetic without a process group."""
    return PopulationMesh(rank=rank, world_size=n, device=torch.device("cpu"), backend="gloo",
                          devices=tuple(torch.device("cpu") for _ in range(n)))


@pytest.mark.parametrize("k", [1, 3, 4, 5, 8, 9])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_pad_population_and_check_rows_match_jax(k, n):
    """The padded population and the divide check equal JAX's on an n-device
    population mesh."""
    jax, _ = _jax()
    from repro.distributed.sharding import population_mesh as jax_population_mesh
    from repro.train import population as JP

    if jax.device_count() < n:
        pytest.skip(f"needs {n} JAX devices")
    jmesh = jax_population_mesh(jax.devices()[:n])
    mesh = _fake_mesh(n)
    assert P.pad_population(k, mesh) == JP.pad_population(k, jmesh)
    assert P.pad_population(k) == JP.pad_population(k, None)
    jax_raised = port_raised = None
    try:
        JP._check_rows(k, jmesh)
    except ValueError as e:
        jax_raised = str(e)
    try:
        P._check_rows(k, mesh)
    except ValueError as e:
        port_raised = str(e)
    assert (jax_raised is None) == (port_raised is None)
    if port_raised is not None:
        assert port_raised == jax_raised


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_rm_mesh_aware_slots_and_flush(n):
    """Slots round up to a multiple of the ranks and name the rank's slice
    and the lane; a partial batch flushes through ``run_population`` with the
    manager's mesh (``tests/test_sharded_population.py``'s case)."""
    rm = ShardedPopulationResourceManager(n_parallel=n + 1, mesh=_fake_mesh(n))
    assert rm.n_slots % n == 0 and rm.n_slots >= n + 1
    assert rm.lanes_per_device == rm.n_slots // n
    res = rm.get_available()
    assert str(res).startswith("slice[0:1,0:1]/lane") and rm.n_total() == rm.n_slots

    seen = {}

    class Target:
        def run_population(self, configs, mesh=None):
            seen["mesh"] = mesh
            return [1.0] * len(configs)

    rm.release(res)
    done = []
    jobs = [Job(i, {"x": i}, None, done.append) for i in range(2)]
    for j in jobs:
        j.resource_id = rm.get_available()
        rm.run(j, Target())
    rm.release(rm.get_available())  # partial-batch flush signal
    for j in jobs:
        j.wait(5.0)
    assert seen["mesh"] is rm.mesh
    assert all(j.result.score == 1.0 for j in jobs)


@pytest.mark.timeout(300)
def test_flights_started_together_take_turns_on_the_mesh(tmp_path):
    """Two batch flights started from two threads of rank 0 at once run
    one after the other on the mesh (their ops never interleave on the
    other ranks) and score as each does alone."""
    procs = _start(2, str(tmp_path), R.concurrent_rank, COLLECTIVE_S)
    got = _join(procs, str(tmp_path), deadline_s=200.0)[0]
    assert got["together"] == got["alone"]
    assert all(len(x) == 3 for x in got["together"])


@pytest.mark.timeout(300)
def test_a_dying_rank_makes_rank_0_raise(tmp_path):
    """Rank 1 exits as the first flight opens: rank 0's next collective
    raises within the group's timeout instead of hanging."""
    procs = _start(2, str(tmp_path), R.dying_rank, 60.0)
    end = time.monotonic() + 200.0
    procs[0].join(max(0.0, end - time.monotonic()))
    alive = procs[0].is_alive()
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    assert not alive, "rank 0 hung after rank 1 died"
    assert procs[1].exitcode == 3
    got = torch.load(str(tmp_path / "rank0.pt"), weights_only=False)
    assert got["raised"] is not None


@pytest.mark.parametrize("what", ["width", "rm-model-parallel", "rm-elastic", "regrid"])
def test_two_level_mesh_and_regrid_are_refused_naming_their_part(what):
    """Part (b) (a two-level mesh, ``model_parallel`` > 1) and part (c)
    (elastic regrid, the regrid lane op) raise naming their ROADMAP.md
    item."""
    with pytest.raises(NotImplementedError) as exc:
        if what == "width":
            population_mesh("cpu", width=2)
        elif what == "rm-model-parallel":
            ShardedPopulationResourceManager(n_parallel=2, mesh=_fake_mesh(2), model_parallel=2)
        elif what == "rm-elastic":
            ShardedPopulationResourceManager(n_parallel=2, mesh=_fake_mesh(2),
                                             elastic_regrid=True)
        else:
            P.get_lane_op(_tc(), 2, "regrid", mesh=_fake_mesh(2))
    part = "12(b)" if what in ("width", "rm-model-parallel") else "12(c)"
    assert f"item {part}" in str(exc.value) and "ROADMAP.md" in str(exc.value)
