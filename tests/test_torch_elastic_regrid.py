"""Elastic regrid (``--elastic-regrid``) on the port, on the CPU.

A regrid changes layout, never math.  Held here, as the JAX package's
``tests/test_elastic_regrid.py`` holds JAX:

* ``plan_regrid`` equals JAX's for every survivor count of pods of 1 to 16
  ranks, with twins of its geometry and full-occupancy tests;
* the ``regrid`` lane op against JAX's ``regrid_population_state`` on the
  same state carried over through ``interop``, bit for bit, for three
  architectures; its input unchanged and its output sharing no storage;
* the vmapped elastic cells (batch and streaming, per step and chunked, on
  the JAX harness's ``ladder(6)`` at K = 8) against the port's fixed-width
  cells: scores bit-equal and the same rule decisions.  (JAX's own twin of
  this test does not hold: XLA's bits for a lane depend on K; the port's
  lanes reduce on their own, so it holds the port to bit equality.);
* the pooled cells on 4 gloo CPU ranks (``ElasticLanePool``, survivors on
  fewer, wider lane rows): within 1e-6 of fixed width, the same decisions,
  every regrid tiling the ranks, widths that never fall, and a flight that
  leaves the process's RMSNorm plan and current mesh as it found them;
* the pool's scale events, the guards of the engine and the CLI, and the
  CLI against JAX's;
* on the card only: the RMSNorm backward of survivor lanes planned for the
  flight's first K gives those lanes' bits from the K-lane launch.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro_torch import interop
from repro_torch.distributed.sharding import PopulationMesh
from repro_torch.launch import hpo
from repro_torch.train import population as P

torch.set_num_threads(2)

WORLD = 4               # the pooled cells' ranks: K = 8 lanes, widths 1, 2, 4
JOIN_S = 280.0          # the spawn's deadline
COLLECTIVE_S = 120.0    # the gloo group's timeout: below the deadline
CELL_NAMES = [c[0] for c in R.ELASTIC_CELLS]
PROTOCOLS = ("batch", "streaming")
REGRID_ARCHS = ("starcoder2-3b", "falcon-mamba-7b", "qwen3-moe-30b-a3b")


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    return jax, jnp


# -- the cells: the vmapped references here, the pooled ones on spawned ranks -------------


def _start(world, root, target, *args):
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
    for r in range(len(procs)):
        err = os.path.join(root, f"rank{r}.err")
        if os.path.exists(err):
            pytest.fail(f"rank {r} raised:\n{open(err).read()}")
        path = os.path.join(root, f"rank{r}.pt")
        out.append(torch.load(path, weights_only=False) if os.path.exists(path) else None)
    return out


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The pooled cells on ``WORLD`` spawned ranks, and meanwhile here the
    fixed-width cells and the vmapped elastic cells, each once."""
    root = tmp_path_factory.mktemp("elastic")
    procs = _start(WORLD, str(root), R.elastic_rank, COLLECTIVE_S)
    cfgs = R.ladder(6)
    out = {"fixed": {}, "vmapped": {}}
    for name, chunk in R.ELASTIC_CELLS:
        out["fixed"][name] = {"batch": R.batch_cell(cfgs, chunk, False, False),
                              "streaming": R.streaming_cell(cfgs, chunk, False, False)}
        out["vmapped"][name] = {"batch": R.elastic_batch_cell(cfgs, chunk),
                                "streaming": R.elastic_streaming_cell(cfgs, chunk)}
    out["fixed"]["replicated"] = R.batch_cell(cfgs[2:3], 1, False, False, arch=R.REPLICATED_ARCH)
    out["ranks"] = _join(procs, str(root))
    return out


@pytest.mark.parametrize("name", CELL_NAMES)
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_vmapped_elastic_bit_equal_fixed_width(cells, protocol, name):
    """Without a pool a regrid is a pure lane compaction: the scores, the
    rule's decisions and (streaming) each trial's steps and latch are the
    fixed-width flight's, bit for bit, and the workload does regrid."""
    ref = cells["fixed"][name][protocol]
    got = cells["vmapped"][name][protocol]
    assert got["regrids"] > 0, "the workload never regridded: the cell tests nothing"
    assert got["scores"] == ref["scores"]
    assert got["n_truncated"] == ref["n_truncated"]
    assert got["n_reclaimed"] == ref["n_reclaimed"]
    if protocol == "streaming":
        assert got["steps"] == ref["steps"]
        assert got["diverged"] == ref["diverged"]
    # K shrinks to powers of two on one device, width 1
    assert all(w == 1 and k & (k - 1) == 0 for k, w in got["lane_width_history"])


@pytest.mark.parametrize("name", CELL_NAMES)
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_pooled_elastic_matches_fixed_width(cells, protocol, name):
    """Survivors re-laid onto wider lane rows over 4 gloo ranks: scores
    within 1e-6 of the fixed-width flight, every decision the same, and at
    least one regrid past width 1, so the wider rows' tensor-parallel
    programs ran."""
    ref = cells["fixed"][name][protocol]
    got = cells["ranks"][0][protocol][name + "-pooled"]
    assert got["regrids"] > 0
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0, atol=1e-6)
    assert got["n_truncated"] == ref["n_truncated"]
    assert got["n_reclaimed"] == ref["n_reclaimed"]
    if protocol == "streaming":
        assert got["steps"] == ref["steps"]
        assert got["diverged"] == ref["diverged"]
    assert any(w > 1 for _, w in got["lane_width_history"])


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_pooled_regrid_keeps_every_rank_busy(cells, protocol):
    """After every cut the ranks are fully re-leased: lanes x width tiles
    the ranks in whole rows, and the pool's width starts at 1 and never
    falls; the pool's mesh and leases are its last width's, and every rank
    applied the same regrids."""
    ranks = cells["ranks"]
    for name in CELL_NAMES:
        got = ranks[0][protocol][name + "-pooled"]
        assert got["lane_width_history"]
        for lanes, width in got["lane_width_history"]:
            assert WORLD % width == 0 and lanes % (WORLD // width) == 0, (lanes, width)
        widths = got["pool_widths"]
        assert widths[0] == 1 and widths == sorted(widths), widths
        last = widths[-1]
        assert got["pool_mesh_shape"] == {"pop": WORLD // last, "model": last}
        assert got["pool_total"] == WORLD // last
        assert all(i.endswith(f"xW{last}") for i in got["pool_lease_ids"])
        logs = [r[protocol][name + "-pooled"]["regrid_log"] for r in ranks]
        assert all([(x["k"], x["k2"], x["width"]) for x in log]
                   == [(x["k"], x["k2"], x["width"]) for x in logs[0]] for log in logs)
        assert [[x["k2"], x["width"]] for x in logs[0]] == got["lane_width_history"]


def test_pooled_regrid_replicates_rows_a_width_cannot_shard(cells):
    """qwen3-moe's smoke model shards no module at width 4 (its kv heads do
    not divide it, its experts stay replicated): a regrid onto rows of 4
    replicates the survivor over the row (``replicate_rows``) instead of
    failing, within 1e-6 of fixed width and with the same decisions."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import tp_width_rules

    assert not tp_width_rules(get_smoke_config(R.REPLICATED_ARCH), WORLD)
    ref = cells["fixed"]["replicated"]
    got = cells["ranks"][0]["batch"]["replicated-pooled"]
    assert got["lane_width_history"] == [[1, WORLD]]
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0, atol=1e-6)
    assert got["n_truncated"] == ref["n_truncated"]
    assert got["n_reclaimed"] == ref["n_reclaimed"]


def test_pooled_flights_leave_the_plan_and_the_current_mesh(cells):
    """A flight whose regrids made meshes of other widths leaves each rank's
    RMSNorm plan (its mesh's rows, no planned lanes) and current mesh as it
    found them."""
    for r in cells["ranks"]:
        assert r["after"] == [[WORLD, None, True]] * len(r["after"])


# -- plan_regrid ------------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 17))
def test_plan_regrid_matches_jax(n):
    _jax()
    from repro.train.population import plan_regrid as jax_plan_regrid

    for s in range(1, 2 * n + 1):
        assert P.plan_regrid(n, s) == jax_plan_regrid(n, s), (n, s)


@pytest.mark.parametrize("n,s,want", [
    (8, 8, (8, 1, 8)),   # full house: no widening possible
    (8, 4, (4, 2, 4)),   # halve the lanes, double the width
    (8, 3, (2, 4, 4)),   # 3 survivors pad to 4 lanes of width 4
    (8, 5, (2, 4, 6)),   # 4 rows would idle one
    (8, 1, (1, 8, 1)),   # the last survivor takes every rank
    (6, 4, (2, 3, 4)),   # a pod of 6
    (1, 3, (1, 1, 3)),   # one rank: the width never grows
])
def test_plan_regrid_geometry(n, s, want):
    assert P.plan_regrid(n, s) == want


@pytest.mark.parametrize("n", [1, 2, 6, 8, 12])
def test_plan_regrid_full_occupancy_invariant(n):
    """For every survivor count rows x width tiles the ranks, every row
    carries a live survivor, and lanes >= survivors (pads only)."""
    for s in range(1, 2 * n + 1):
        rows, width, lanes = P.plan_regrid(n, s)
        assert rows * width == n
        assert lanes >= s and lanes % rows == 0
        assert (rows - 1) * (lanes // rows) < s


# -- the regrid lane op against JAX's --------------------------------------------------------


def _raw(t):
    t = t.detach().contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t.view(
        {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("arch", REGRID_ARCHS)
def test_regrid_op_matches_jax_bit_for_bit(arch):
    """``regrid_population_state(pad_to=4)`` of survivors ``[2, 0]`` on a
    population whose lanes all differ (weights, moments, step counters,
    latches, last losses): the port's result is JAX's, bit for bit, leaf by
    leaf; the source is unchanged and shares no storage with the result;
    ``out=`` writes the same bits into a state of the new geometry."""
    jax, jnp = _jax()
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import ParallelConfig as JaxParallelConfig
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.train import population as JP
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig

    jtc = JaxTrainConfig(model=jax_smoke_config(arch), parallel=JaxParallelConfig(remat="none"))
    tc = TrainConfig(model=get_smoke_config(arch), parallel=ParallelConfig(remat="none"))
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(3), i) for i in range(4)])
    jp = JP.init_population_state_from_keys(keys, jtc)
    gen = np.random.default_rng(0)
    # moments and step counters that differ by lane, as after training
    opt = jax.tree.map(lambda x: x if x.ndim < 1 or x.dtype == jnp.int32 else
                       x + jnp.asarray(gen.normal(size=x.shape), x.dtype), jp["inner"]["opt"])
    opt = dict(opt, step=jnp.arange(4, dtype=jp["inner"]["opt"]["step"].dtype) + 5)
    jp = dict(jp, inner=dict(jp["inner"], opt=opt),
              diverged=jnp.asarray([False, True, False, True]),
              last_loss=jnp.asarray([1.5, 2.5, 3.5, 4.5], jnp.float32))
    want = interop.tree_leaves(interop.to_torch(jax.device_get(
        JP.regrid_population_state(jp, [2, 0], jtc, pad_to=4))))
    tp = interop.to_torch(jax.device_get(jp))
    before = [t.clone() for t in interop.tree_leaves(tp)]
    got = P.regrid_population_state(tp, [2, 0], tc, pad_to=4)
    src = interop.tree_leaves(tp)
    assert len(interop.tree_leaves(got)) == len(want)
    for g, w, b, s in zip(interop.tree_leaves(got), want, before, src):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(_raw(g), _raw(w))
        assert torch.equal(_raw(s), _raw(b))
        assert g.untyped_storage().data_ptr() != s.untyped_storage().data_ptr()
    out = interop.tree_map(torch.zeros_like, got)
    assert P.regrid_population_state(tp, [2, 0], tc, pad_to=4, out=out) is out
    for g, w in zip(interop.tree_leaves(out), want):
        assert torch.equal(_raw(g), _raw(w))
    with pytest.raises(ValueError, match="shares storage"):
        P.get_lane_op(tc, 4, "regrid")(tp, [0, 1, 2, 3], out=tp)


def test_regrid_lane_op_is_in_the_table_with_its_sharded_twin():
    """``get_lane_op(..., "regrid")`` is the gather; with a mesh its sharded
    twin; an unknown op still raises ``KeyError``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig

    tc = TrainConfig(model=get_smoke_config(R.ARCH), parallel=ParallelConfig(remat="none"))
    mesh = PopulationMesh(rank=0, world_size=2, device=torch.device("cpu"), backend="gloo",
                          devices=(torch.device("cpu"),) * 2)
    assert P.get_lane_op(tc, 4, "regrid").__qualname__.startswith("make_lane_regrid")
    twin = P.get_lane_op(tc, 4, "regrid", mesh=mesh)
    assert twin.__qualname__.startswith("make_sharded_lane_regrid") and twin.recv_bytes == 0
    with pytest.raises(KeyError):
        P.get_lane_op(tc, 4, "regrid-bogus")


def test_a_geometrys_graphs_are_keyed_by_the_rmsnorm_backward_plan():
    """A chunk graph bakes the RMSNorm backward's plan in when it is
    captured, so the plan keys a geometry's graphs: K' lanes planned for an
    elastic flight's first K get graphs of their own beside a fixed K'
    flight's (no card is touched until a graph is captured); a mesh rank's
    block keys as the whole population's launch; dropping one geometry
    leaves the other."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import rmsnorm

    tc = TrainConfig(model=get_smoke_config(R.ARCH), parallel=ParallelConfig(remat="none"))
    data = SyntheticLM(tc.model.vocab_size, R.SEQ, R.BATCH, seed=0)

    def graphs(k):
        return P._flight_graphs(tc, k, True, data, "cuda:0")

    P.clear_population_cache()
    try:
        fixed = graphs(2)
        with rmsnorm.plan_lanes(8):
            planned = graphs(2)
            assert planned is not fixed and graphs(2) is planned
            assert P.drop_flight_graphs(tc, 2, data, True, "cuda:0") == []
            assert graphs(2) is not planned
        assert graphs(2) is fixed
        try:
            rmsnorm.plan_for_mesh(4)
            assert graphs(2) is not fixed   # 2 lanes a rank of 4: planned for 8
            with rmsnorm.plan_lanes(8):
                assert graphs(2) is P._flight_graphs(tc, 2, True, data, "cuda:0")
        finally:
            rmsnorm.plan_for_mesh(1)
        assert graphs(2) is fixed
    finally:
        P.clear_population_cache()


def test_a_trial_times_its_dispatches_when_asked():
    """With ``dispatch_times`` a list, each training dispatch of a flight is
    timed alone as ``(lanes, steps, seconds)``: the steps add up to the
    trial's, and the lanes follow the flight's regrids."""
    t = R.elastic_trial(1)
    assert t.dispatch_times is None
    t.dispatch_times = []
    t.run_population(R.ladder(6))
    got = t.dispatch_times
    assert sum(n for _, n, _ in got) == t.n_train_steps and all(s >= 0 for *_, s in got)
    lanes = [k for k, _, _ in got]
    assert lanes[0] == R.LANES and t.n_regrids > 0
    assert [k for i, k in enumerate(lanes) if i and k != lanes[i - 1]] == [
        k for k, _ in t.lane_width_history]


# -- ElasticLanePool --------------------------------------------------------------------------


def _fake_mesh(n):
    """A mesh's arithmetic without a process group (the pool's lease
    bookkeeping reads only its ranks)."""
    return PopulationMesh(rank=0, world_size=n, device=torch.device("cpu"), backend="gloo",
                          devices=tuple(torch.device("cpu") for _ in range(n)))


def test_elastic_pool_emits_scale_events():
    """Width-1 leases first; a regrid to half the survivors scales out the
    wider leases and scales in the old ones, observably in the elastic
    manager; the same survivor count again emits nothing."""
    from repro_torch.core.resource.sharded import ElasticLanePool

    n = 8
    pool = ElasticLanePool(mesh=_fake_mesh(n))
    assert pool.width == 1 and len(pool._lease_ids) == n
    assert all(i.endswith("xW1") for i in pool._lease_ids)
    rows, width, lanes = pool.regrid(n // 2)
    assert (rows, width, lanes) == (4, 2, 4) and rows * width == n and pool.n_regrids == 1
    assert len(pool._lease_ids) == rows
    assert all(i.endswith(f"xW{width}") for i in pool._lease_ids)
    assert pool.manager.n_total() == rows
    pool.regrid(n // 2)
    assert pool.n_regrids == 1 and pool.width_history.count(width) == 1


def test_elastic_pool_rejects_untileable_width():
    """The pool starts at width 1 over every rank; a width that does not
    tile its ranks is refused and leaves the leases as they were."""
    from repro_torch.core.resource.sharded import ElasticLanePool

    pool = ElasticLanePool(_fake_mesh(2))
    assert pool.width_history == [1] and len(pool._lease_ids) == 2
    with pytest.raises(ValueError, match="does not tile"):
        pool._retile(3 * 2)
    assert pool.width == 1 and len(pool._lease_ids) == 2


def test_sharded_manager_builds_its_pool_and_hands_it_to_the_runner():
    """``elastic_regrid=True``: the manager leases its ranks through an
    ``ElasticLanePool`` over its own mesh and passes it to a runner that
    takes ``elastic``; with ``model_parallel`` it refuses, as JAX's CLI."""
    from repro_torch.core.resource.sharded import ElasticLanePool, \
        ShardedPopulationResourceManager

    rm = ShardedPopulationResourceManager(n_parallel=4, mesh=_fake_mesh(2),
                                          elastic_regrid=True)
    assert isinstance(rm.elastic, ElasticLanePool) and rm.elastic.base is rm.mesh
    seen = {}

    def runner(configs, mesh=None, elastic=None):
        seen.update(mesh=mesh, elastic=elastic)
        return [1.0] * len(configs)

    assert rm._run_batch(runner, [{}, {}]) == [1.0, 1.0]
    assert seen == {"mesh": rm.mesh, "elastic": rm.elastic}
    with pytest.raises(ValueError, match="elastic"):
        ShardedPopulationResourceManager(n_parallel=4, mesh=_fake_mesh(2), elastic_regrid=True,
                                         model_parallel=2)


# -- guards ------------------------------------------------------------------------------------


def test_elastic_rejects_device_rules():
    trial = R.elastic_trial(1)
    trial.device_rules = True
    with pytest.raises(ValueError, match="device-rules"):
        trial.run_population(R.ladder(2))


def test_elastic_streaming_rejects_streaming_pbt():
    from repro_torch.core.resource.vectorized import QueueFeedScheduler

    trial = R.elastic_trial(1)
    trial.lifecycle = object()
    with pytest.raises(ValueError, match="streaming PBT"):
        trial.run_population([], scheduler=QueueFeedScheduler(R.ladder(2)))


GUARD_BASE = ["--proposer", "asha", "--vectorize", "4", "--inflight-stop", "--n-samples", "2",
              "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu"]


@pytest.mark.parametrize("argv,words", [
    (GUARD_BASE + ["--elastic-regrid", "--device-rules"], "incompatible with --device-rules"),
    (["--proposer", "pbt", "--vectorize", "4", "--pbt-streaming", "--elastic-regrid",
      "--n-samples", "2", "--steps", "2", "--device", "cpu"], "incompatible with --pbt-streaming"),
    (["--proposer", "asha", "--elastic-regrid", "--n-samples", "2", "--device", "cpu"],
     "requires --vectorize K"),
    (GUARD_BASE + ["--elastic-regrid", "--chunk-steps", "4", "--data-ring"],
     "--data-ring is incompatible with --elastic-regrid"),
    (GUARD_BASE + ["--elastic-regrid", "--shard-population", "--model-parallel", "2"],
     "--model-parallel is incompatible with --elastic-regrid"),
], ids=["device-rules", "pbt-streaming", "no-vectorize", "data-ring", "model-parallel"])
def test_cli_rejects_incompatible_engines(capsys, argv, words):
    """The JAX CLI's refusals, in its words (exit 2 at parse time)."""
    with pytest.raises(SystemExit) as exc:
        hpo.main(argv)
    assert exc.value.code == 2
    assert words in capsys.readouterr().err


def test_cli_matches_jax_cli(monkeypatch, capsys):
    """``--proposer asha --vectorize 4 --inflight-stop --elastic-regrid``
    through JAX's CLI and the port's (from JAX's init weights): the same
    best config, best scores within 1e-4, the same regrids and lane widths,
    every key JAX prints, and the ``+elastic`` engine."""
    jax, _ = _jax()
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.launch import hpo as jax_hpo
    from repro.train.train_step import init_train_state as jax_init_train_state
    from repro_torch.train import train_step as ts

    state = jax.device_get(jax_init_train_state(
        jax.random.PRNGKey(0), JaxTrainConfig(model=jax_smoke_config("starcoder2-3b"))))
    monkeypatch.setattr(ts, "init_train_state",
                        lambda gen, tc, device: interop.to_torch(state, device))
    argv = ["--proposer", "asha", "--vectorize", "4", "--inflight-stop", "--elastic-regrid",
            "--n-samples", "4", "--steps", "2", "--batch", "2", "--seq", "16"]
    assert jax_hpo.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert hpo.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["engine"] == want["engine"] == "vmapped+elastic"
    assert got["best_config"] == want["best_config"]
    np.testing.assert_allclose(got["best_score"], want["best_score"], atol=1e-4, rtol=1e-4)
    assert got["regrids"] == want["regrids"] > 0
    assert got["lane_width_history"] == want["lane_width_history"]
    assert not set(want) - set(got), set(want) - set(got)


# -- on the card --------------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k0,survivors", [(4, [1, 3]), (4, [2]), (8, [0, 5, 6, 7])])
def test_rmsnorm_bwd_of_survivors_planned_for_the_first_k_keeps_their_bits(k0, survivors):
    """After a regrid from K to K' lanes an elastic flight plans the
    backward for its first K (``rmsnorm.plan_lanes``): the survivors' dx and
    dgamma are then the bits the K-lane launch gave them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (k0, 4096, 3072)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    g = (0.1 * torch.randn((k0, 3072), generator=gen, device=dev)).to(torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    whole = rn.rmsnorm_bwd_cuda(x, g, dy, 1e-6)
    idx = torch.as_tensor(survivors, device=dev)
    with rn.plan_lanes(k0):
        part = rn.rmsnorm_bwd_cuda(*(t.index_select(0, idx) for t in (x, g, dy)), 1e-6)
    assert rn.planned_lanes is None
    torch.cuda.synchronize()
    for w, p in zip(whole, part):
        assert torch.equal(w.index_select(0, idx), p)


@pytest.mark.cuda
def test_a_fixed_flight_after_an_elastic_one_captures_its_own_graphs():
    """An elastic chunked flight (K = 8 regridded down to K') leaves its
    last geometry's graphs in the cache, captured under the RMSNorm plan of
    its first K.  A fixed-width flight of K' lanes run next, with the cache
    kept, captures graphs of its own and scores bit for bit as from an
    empty cache; the elastic flight scores as the fixed flight of K = 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels and graphs run only on the card")
    from repro_torch.core.proposer.early_stop import InFlightSuccessiveHalving

    torch.backends.cuda.matmul.allow_tf32 = False
    cfgs = R.ladder(6)

    def run(k, elastic, configs):
        t = hpo.PopulationTrial(R.ARCH, steps=R.STEPS_PER_UNIT, batch=R.BATCH, seq=64, seed=0,
                                population=k, refill_idle_grace_s=0.0, chunk_steps=8,
                                device="cuda", elastic_regrid=elastic,
                                early_stop=InFlightSuccessiveHalving(eta=2.0, min_iter=2,
                                                                     max_iter=8))
        return t, t.run_population(list(configs))

    def scan_graphs(k):
        return [g for g in P.graph_stats() if g["kind"] == "scan" and g["lanes"] == k]

    P.clear_population_cache()
    try:
        _, wide = run(R.LANES, False, cfgs)
        P.clear_population_cache()
        el, got = run(R.LANES, True, cfgs)
        assert got == wide and el.n_regrids > 0
        k2 = el.lane_width_history[-1][0]
        left = scan_graphs(k2)
        assert left and len(left) == len(P.graph_stats())   # the geometries left are gone
        _, after = run(k2, False, cfgs[:k2])
        assert len(scan_graphs(k2)) > len(left)
        P.clear_population_cache()
        _, alone = run(k2, False, cfgs[:k2])
        assert after == alone
    finally:
        P.clear_population_cache()
