"""Crash safety in the port: lane snapshots, the checkpointer, the snapshot
store, supervised flight restarts that restore lanes, and ``--resume``.

Against the JAX package: the snapshot and restore lane ops against JAX's
``make_lane_snapshot`` / ``make_lane_restore`` on a converted state,
exactly; the CLI with ``--snapshot-every 1`` against the JAX CLI within
1e-4.  Inside the port: the checkpointer's atomic replace, ``.old``
fallback and junk skipping; the store's disk round trip with bfloat16 raw
bits; a snapshot leaves the state as it was; a flight killed in process
restores its lanes and scores as the unbroken flight, bit for bit (per
step, chunked, ring-fed); and the CLI killed with SIGKILL at an event pass
then resumed with ``--resume`` scores as the unbroken run within 1e-6,
plain and ring-fed mid-window.  On an NVIDIA GPU (marker ``cuda``):
snapshot and restore on the card, and the flash backward giving every lane
of a batch the same gradient bits (a restored lane may land in another
lane).

JAX is imported inside the tests that compare with it.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.checkpoint import Checkpointer, LaneSnapshotStore
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import faultinject
from repro_torch.core.job import Job, JobStatus
from repro_torch.core.resource.vectorized import VectorizedResourceManager
from repro_torch.core.tracking.database import TrackingDB
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.launch import hpo
from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
from repro_torch.train import population as P
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "starcoder2-3b"
SEQ, BATCH = 16, 2
_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@pytest.fixture(autouse=True)
def _no_armed_faults():
    """Fault plans are process-global: never leak one across tests."""
    faultinject.disarm()
    yield
    faultinject.disarm()


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    return jax, jnp


def _tc():
    return TrainConfig(model=get_smoke_config(ARCH), parallel=ParallelConfig(remat="none"),
                       total_steps=8)


def _raw(t):
    t = torch.as_tensor(t).detach()
    return t.to(torch.uint8) if t.dtype == torch.bool else t.view(_INT_OF_SIZE[t.element_size()])


def _bits_equal(a, b):
    """Equal trees: the same leaves, dtypes, shapes and raw bits."""
    la, lb = interop.tree_leaves(a), interop.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(_raw(x), _raw(y))
        for x, y in zip(la, lb))


def _lane(tree, i):
    return interop.tree_map(lambda t: t[i], tree)


def _trained_state(k=3, steps=2):
    """A K-lane population of the smoke config in bfloat16 trained a few
    steps: lanes differ from their init and from each other (per-lane init,
    per-lane learning rates); lane 1's latch is set."""
    tc = dataclasses.replace(_tc(), model=dataclasses.replace(
        _tc().model, param_dtype="bfloat16", compute_dtype="bfloat16"))
    pstate = P.init_population_state_from_keys(
        [torch.Generator().manual_seed(i) for i in range(k)], tc, "cpu")
    data = SyntheticLM(tc.model.vocab_size, SEQ, BATCH, seed=0)
    hp = stack_hparams([hparams_from_dict({"learning_rate": 1e-3 * (i + 1), "total_steps": 8},
                                          tc) for i in range(k)], "cpu")
    step = P.make_population_train_step(tc, per_trial_batch=True)
    for s in range(steps):
        pstate, _ = step(pstate, to_device(data.make_population_batch(s, list(range(k))), "cpu"),
                         hp)
    pstate["diverged"][1] = True
    return tc, pstate


# ------------------------------------------------------------- lane ops vs JAX
@pytest.fixture(scope="module")
def jax_trained():
    """The JAX package's population of 3 lanes trained 2 steps (lane 1's
    latch set), a fresh JAX population, and their snapshot/restore ops;
    the port copies each test's own tensors from the numpy trees."""
    jax, jnp = _jax()
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import ParallelConfig as JaxParallelConfig
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
    from repro.optim.hparams import hparams_from_dict as jax_hparams
    from repro.optim.hparams import stack_hparams as jax_stack
    from repro.train import population as JP

    jtc = JaxTrainConfig(model=jax_smoke_config(ARCH), parallel=JaxParallelConfig(remat="none"),
                         total_steps=8)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), i) for i in range(3)])
    jp = JP.init_population_state_from_keys(keys, jtc)
    step = jax.jit(JP.make_population_train_step(jtc, per_trial_batch=False))
    data = JaxSyntheticLM(jtc.model.vocab_size, SEQ, BATCH, seed=0)
    hp = jax_stack([jax_hparams({"learning_rate": 1e-3 * (i + 1), "total_steps": 8}, jtc)
                    for i in range(3)])
    for s in range(2):
        jp, _ = step(jp, data.make_batch(s), hp)
    jp = dict(jp, diverged=jnp.asarray([False, True, False]))
    fresh = JP.init_population_state_from_keys(
        jnp.stack([jax.random.fold_in(jax.random.PRNGKey(5), i) for i in range(3)]), jtc)
    return (jax, jnp, JP.make_lane_snapshot(jtc), JP.make_lane_restore(jtc),
            jax.device_get(jp), jax.device_get(fresh))


def _np(tree):
    return [np.asarray(x) for x in interop.tree_leaves(interop.to_numpy(tree))]


def _jnp(jax, tree):
    out = []
    for x in jax.tree.leaves(jax.device_get(tree)):
        x = np.asarray(x)
        out.append(x.astype(np.float32) if x.dtype.name == "bfloat16" else x)
    return out


@pytest.mark.parametrize("lane", [0, 1, 2])
def test_lane_snapshot_matches_jax(jax_trained, lane):
    """The port's snapshot of a converted JAX state equals JAX's
    ``make_lane_snapshot`` leaf for leaf, exactly, the latched lane too."""
    jax, jnp, jsnap, _, jp, _ = jax_trained
    want = jsnap(jp, jnp.asarray(lane, jnp.int32))
    got = P.get_lane_op(_tc(), 3, "snapshot")(interop.to_torch(jp), lane)
    assert all(t.device.type == "cpu" for t in interop.tree_leaves(got))
    for g, w in zip(_np(got), _jnp(jax, want)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("src,dst", [(0, 2), (1, 0), (2, 2)])
def test_lane_restore_matches_jax(jax_trained, src, dst):
    """A snapshot of lane ``src`` written into lane ``dst`` of a fresh
    population: the port's in-place restore equals JAX's
    ``make_lane_restore`` on every leaf, exactly."""
    jax, jnp, jsnap, jrestore, jp, jfresh = jax_trained
    want = jrestore(jfresh, jnp.asarray(dst, jnp.int32), jsnap(jp, jnp.asarray(src, jnp.int32)))
    fresh = interop.to_torch(jfresh)
    snap = P.get_lane_op(_tc(), 3, "snapshot")(interop.to_torch(jp), src)
    got = P.get_lane_op(_tc(), 3, "restore")(fresh, dst, snap)
    assert got is fresh
    for g, w in zip(_np(got), _jnp(jax, want)):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- lane ops, port
def test_snapshot_is_read_only_and_restore_is_raw_bit_exact():
    """A snapshot leaves every leaf of the state bit for bit as it was (two
    harvests give the same bits); restoring it into another lane makes that
    lane equal to the source in raw bits, dtypes included (bfloat16
    parameters), and leaves the other lanes untouched."""
    tc, pstate = _trained_state()
    before = interop.tree_map(lambda t: t.clone(), pstate)
    snap_fn = P.get_lane_op(tc, 3, "snapshot")
    s1, s2 = snap_fn(pstate, 1), snap_fn(pstate, 1)
    assert _bits_equal(pstate, before) and _bits_equal(s1, s2)
    assert _bits_equal(s1, _lane(pstate, 1))
    assert any(t.dtype == torch.bfloat16 for t in interop.tree_leaves(s1))
    got = P.get_lane_op(tc, 3, "restore")(pstate, 2, s1)
    assert got is pstate
    assert _bits_equal(_lane(pstate, 2), _lane(pstate, 1))
    for i in (0, 1):
        assert _bits_equal(_lane(pstate, i), _lane(before, i))
    assert bool(pstate["diverged"][2])


def test_snapshot_slots_are_bounded_and_reused():
    """A geometry's snapshots go into at most K + 1 host slots: with every
    slot held the next harvest gets fresh host tensors, and a released
    snapshot's slot takes the next harvest; each snapshot holds its lane."""
    tc, pstate = _trained_state()
    P.clear_population_cache()
    snap_fn = P.make_lane_snapshot(tc)
    held = [snap_fn(pstate, i % 3) for i in range(4)]
    extra = snap_fn(pstate, 2)
    bufs = lambda snap: {t.untyped_storage().data_ptr()  # noqa: E731
                         for t in interop.tree_leaves(snap)}
    assert all(len(bufs(s)) == 1 for s in held)          # one flat buffer a slot
    assert len(set().union(*map(bufs, held))) == 4
    assert not bufs(extra) & set().union(*map(bufs, held))
    stats = P.lane_snapshot_slot_stats()
    assert [(s["slots"], s["max_slots"], s["held"], s["pinned_bytes"]) for s in stats] == \
        [(4, 4, 4, 0)]
    for i, s in enumerate(held + [extra]):
        assert _bits_equal(s, _lane(pstate, i % 3 if i < 4 else 2))
    P.release_lane_snapshot(extra)      # not a slot: nothing to hand back
    P.release_lane_snapshot(None)
    P.release_lane_snapshot(held[1])
    assert P.lane_snapshot_slot_stats()[0]["held"] == 3
    again = snap_fn(pstate, 0)
    assert again is held[1] and _bits_equal(again, _lane(pstate, 0))
    assert P.lane_snapshot_slot_stats()[0]["held"] == 4
    P.clear_population_cache()
    assert P.lane_snapshot_slot_stats() == []


def test_store_hands_back_the_snapshot_it_lets_go():
    """``put`` returns the snapshot it supersedes and ``forget`` the one it
    drops, so the flight can hand their host slots back."""
    store = LaneSnapshotStore()
    a, b = {"w": torch.zeros(2)}, {"w": torch.ones(2)}
    meta = {"local": 1}
    assert store.put(7, a, meta) is None
    assert store.put(7, a, meta) is None       # the same snapshot again: nothing let go
    assert store.put(7, b, meta) is a
    assert store.forget(7) is b and store.forget(7) is None


# ------------------------------------------------------------- checkpointer
def test_checkpoint_atomic_replace_and_old_fallback(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, {"w": torch.arange(3.0)})
    ck.save(1, {"w": torch.arange(3.0) * 2})   # the same step: atomic replace
    assert ck.all_steps() == [1]
    state, _ = ck.restore(1)
    assert torch.equal(state["w"], torch.arange(3.0) * 2)
    assert not os.path.exists(str(tmp_path / "step_00000001.old"))
    # a crash between _write's two renames: only the .old copy survives, and
    # all_steps counts it and restore falls back to it
    os.rename(str(tmp_path / "step_00000001"), str(tmp_path / "step_00000001.old"))
    assert ck.all_steps() == [1]
    state, _ = ck.restore()
    assert torch.equal(state["w"], torch.arange(3.0) * 2)


def test_checkpoint_all_steps_skips_junk_and_keeps_the_newest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (2, 3, 4):
        ck.save(step, {"w": np.full(1, step)})
    (tmp_path / "step_garbage").mkdir()
    (tmp_path / "step_12extra").write_text("junk")
    (tmp_path / "step_00000009.tmp").mkdir()  # a partial write: ignored silently
    with pytest.warns(UserWarning, match="non-checkpoint"):
        assert ck.all_steps() == [3, 4]   # keep=2 removed step 2


def test_checkpoint_save_async_surfaces_the_background_error(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    ck.save_async(1, {"w": torch.ones(2)})
    ck.wait()
    assert ck.all_steps() == [1]

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    ck.save_async(2, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()   # the error is raised once


def test_lane_snapshot_store_disk_round_trip_keeps_raw_bits(tmp_path):
    """A snapshot through the store's disk copy and back: every leaf's
    dtype and raw bits, bfloat16 NaN payloads and subnormals included (a
    float32 round trip would change them), and 0-d leaves stay 0-d."""
    bits = torch.tensor([0x7FC1, 0x0001, -0x8000, 0x3F80, 0x7F80, -0x0042], dtype=torch.int16)
    snap = {"inner": {"params": {"w": bits.view(torch.bfloat16)},
                      "opt": {"mu": torch.randn(3, 2), "step": torch.tensor(6, dtype=torch.int32)}},
            "diverged": torch.tensor(False), "last_loss": torch.tensor(2.5)}
    meta = {"local": 6, "stream": 3, "applied": 6, "applied0": 0, "budget": 12.0,
            "data_cursor": 6}
    store = LaneSnapshotStore(root=str(tmp_path))
    store.put(3, snap, meta)
    assert store.n_persisted == 1
    fresh = LaneSnapshotStore(root=str(tmp_path))   # a resumed process reads the disk
    assert fresh.lineages() == [3]
    got, gmeta = fresh.get(3)
    assert _bits_equal(got, snap)
    assert got["last_loss"].dim() == 0 and got["inner"]["opt"]["step"].dim() == 0
    assert int(gmeta["local"]) == 6 and int(gmeta["data_cursor"]) == 6
    fresh.forget(3)
    assert fresh.get(3) is None
    assert LaneSnapshotStore(root=str(tmp_path)).get(3) is None   # gone on disk


# ------------------------------------------------------------- flight death
_FLIGHTS = {"per-step": dict(chunk_steps=1), "chunked": dict(chunk_steps=4),
            "ring": dict(chunk_steps=4, data_ring=True)}


def _supervised_pair(fault, kind, snapshot_every=1, steps=12):
    """Two jobs on a 2-lane supervised streaming flight with an in-memory
    snapshot store; ``{stream: (status, score)}``, the trial and the
    manager."""
    faultinject.disarm()
    if fault:
        faultinject.arm(fault)
    try:
        trial = hpo.PopulationTrial(ARCH, steps=steps, batch=BATCH, seq=SEQ, seed=0,
                                    population=2, device="cpu", refill_idle_grace_s=0.1,
                                    snapshot_every=snapshot_every, snapshots=LaneSnapshotStore(),
                                    **_FLIGHTS[kind])
        rm = VectorizedResourceManager(n_parallel=2, lane_refill=True, restart_backoff_s=0.001)
        jobs = [Job(i, {"learning_rate": 1e-3 * (i + 1), "stream": 100 + i}, f"slot{i}",
                    lambda j: None) for i in range(2)]
        for j in jobs:
            rm._busy[j.resource_id] = None
            rm.run(j, trial)
        for j in jobs:
            assert j.wait(300.0), "streaming flight timed out"
    finally:
        faultinject.disarm()
    return ({j.config["stream"]: (j.status, j.result.score if j.result else None)
             for j in jobs}, trial, rm)


@pytest.mark.parametrize("kind", sorted(_FLIGHTS))
def test_flight_death_restores_lanes_and_scores_match(kind):
    """A flight killed mid-stream (``raise@step=10``) restarts under the
    supervisor, both lanes restore from their snapshot at step 8 (not step
    0), and every score equals the unbroken flight's bit for bit."""
    base, t0, _ = _supervised_pair(None, kind)
    assert all(st == JobStatus.FINISHED for st, _ in base.values())
    faulted, t1, rm = _supervised_pair("raise@step=10,times=1", kind)
    assert faulted == base, "scores differ after the restore"
    assert rm.n_flight_deaths == 1 and rm.n_flight_restarts == 1 and rm.n_quarantined == 0
    assert t1.n_lane_restores == 2 and t1.resumed_from_steps == [8, 8]
    assert t1.n_snapshots >= 2
    # every harvest went into the geometry's K + 1 = 3 host slots, and every
    # finished trial handed its slot back
    assert [(s["slots"] <= 3, s["held"]) for s in P.lane_snapshot_slot_stats()
            if s["max_slots"] == 3] == [(True, 0)]
    if kind == "ring":
        assert t1.n_ring_fills >= 2


def test_snapshots_off_restart_from_step_zero_with_the_same_scores():
    """Without harvests (``snapshot_every=0``) a restart retrains from step
    0: the same scores, no restore."""
    base, _, _ = _supervised_pair(None, "chunked", snapshot_every=0)
    faulted, trial, rm = _supervised_pair("raise@step=10,times=1", "chunked", snapshot_every=0)
    assert faulted == base and rm.n_flight_deaths == 1
    assert trial.n_lane_restores == 0 and trial.n_snapshots == 0


# ------------------------------------------------------------- CLI
def _cli(tmp, db, extra, env_extra=None, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "2")
    env.pop(faultinject.ENV_VAR, None)
    env.update(env_extra or {})
    cmd = [sys.executable, "-m", "repro_torch.launch.hpo", "--device", "cpu",
           "--proposer", "random", "--vectorize", "4", "--lane-refill", "--n-samples", "8",
           "--steps", "12", "--batch", "2", "--seq", "16", "--db", db] + extra
    return subprocess.run(cmd, cwd=str(tmp), env=env, capture_output=True, text=True,
                          timeout=timeout)


def _scores_by_stream(db_path):
    db = TrackingDB(db_path)
    eid = db.latest_experiment_id()
    return {r["config"].get("stream", r["job_id"]): r["score"]
            for r in db.jobs(eid) if r["status"] == "finished"}


@pytest.mark.parametrize("feed", [[], ["--chunk-steps", "8", "--data-ring"]],
                         ids=["plain", "ring"])
def test_cli_sigkill_then_resume_is_score_equivalent(tmp_path, feed):
    """The CLI killed with SIGKILL at the third event pass (armed through
    the environment) keeps its lane snapshots on disk; ``--resume``
    restores the lanes mid-budget (ring-fed: mid-window, the ring re-keyed
    from each snapshot's data cursor) and every trial scores as in the
    unbroken run, within 1e-6."""
    base = _cli(tmp_path, str(tmp_path / "base.sqlite"), feed + ["--snapshot-every", "1"])
    assert base.returncode == 0, base.stderr[-2000:]

    db = str(tmp_path / "t.sqlite")
    killed = _cli(tmp_path, db, feed + ["--snapshot-every", "1"],
                  env_extra={faultinject.ENV_VAR: "kill@event=3"})
    assert killed.returncode in (-signal.SIGKILL, 128 + signal.SIGKILL), \
        f"expected SIGKILL, got rc={killed.returncode}\n{killed.stderr[-2000:]}"
    assert os.path.isdir(db + ".lanes"), "no lane snapshots on disk"

    resumed = _cli(tmp_path, db, feed + ["--resume"])
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    out = json.loads(resumed.stdout[resumed.stdout.index("{"):])
    assert out["resumed"] is True and out["resumed_lanes"] >= 1
    assert min(out["resumed_from_steps"]) > 0, "a resumed lane restarted from step 0"
    if feed:
        assert out["engine"].endswith("+ring") and out["ring_fills"] >= 1
        assert 0.0 <= out["overlap_frac"] <= 1.0

    a = _scores_by_stream(str(tmp_path / "base.sqlite"))
    b = _scores_by_stream(db)
    assert set(a) == set(b) and len(a) == 8
    worst = max(abs(a[k] - b[k]) for k in a)
    assert worst <= 1e-6, f"kill + resume differs from the unbroken run by {worst}"


@pytest.fixture
def jax_init(monkeypatch):
    """The port's trials start from the JAX init weights of the CLI's seed."""
    jax, _ = _jax()
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.train.train_step import init_train_state as jax_init_train_state

    state = jax.device_get(jax_init_train_state(
        jax.random.PRNGKey(0), JaxTrainConfig(model=jax_smoke_config(ARCH))))
    monkeypatch.setattr(ts, "init_train_state",
                        lambda gen, tc, device: interop.to_torch(state, device))
    monkeypatch.setattr(ts, "init_params",
                        lambda gen, tc, device: interop.to_torch(state["params"], device))


def test_snapshot_cli_matches_jax_cli(jax_init, capsys):
    """``--lane-refill --snapshot-every 1`` through the JAX CLI and the
    port's: the same best config, best scores within 1e-4, the same count
    of snapshots, and the crash-safety keys of the JAX CLI's output."""
    from repro.launch import hpo as jax_hpo

    argv = ["--n-samples", "4", "--steps", "10", "--batch", "2", "--seq", "16",
            "--vectorize", "4", "--lane-refill", "--snapshot-every", "1"]
    assert jax_hpo.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert hpo.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["best_config"] == want["best_config"]
    np.testing.assert_allclose(got["best_score"], want["best_score"], atol=1e-4, rtol=1e-4)
    for key in ("snapshots", "resumed", "resumed_lanes", "resumed_from_steps"):
        assert got[key] == want[key], key
    assert got["snapshots"] > 0


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the snapshot's device-to-host path runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [False, True], ids=["pageable", "pinned"])
def test_snapshot_and_restore_on_the_card(cuda, pinned):
    """On the card: a snapshot (into a page-locked slot, or into pageable
    memory once the K + 1 slots are held) equals the CPU state's lane in raw
    bits and leaves the state unchanged; restoring it into another lane
    makes that lane equal the source in raw bits, allocating nothing on the
    card beyond a few bytes."""
    tc, cpu = _trained_state()
    card = interop.tree_map(lambda t: t.to(cuda, copy=True), cpu)
    before = interop.tree_map(lambda t: t.clone(), card)
    P.clear_population_cache()
    snap_fn = P.make_lane_snapshot(tc)
    held = [] if pinned else [snap_fn(card, 1) for _ in range(4)]
    snap = snap_fn(card, 0)
    assert all(t.device.type == "cpu" and t.is_pinned() == pinned
               for t in interop.tree_leaves(snap))
    assert [s["pinned_bytes"] > 0 for s in P.lane_snapshot_slot_stats()] == [True]
    del held
    assert _bits_equal(snap, _lane(cpu, 0)) and _bits_equal(card, before)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    P.get_lane_op(tc, 3, "restore")(card, 2, snap)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 1 << 20
    assert _bits_equal(_lane(card, 2), _lane(before, 0))
    assert _bits_equal(_lane(card, 1), _lane(before, 1))
    P.clear_population_cache()
    assert P.lane_snapshot_slot_stats() == []


@pytest.mark.cuda
def test_flash_backward_gives_every_lane_the_same_bits(cuda):
    """Four lanes holding the same batch (starcoder2-3b's attention shape,
    bf16 through the tensor-core forward and the plain blocked backward):
    every lane's gradients are equal bit for bit, so a restored lane trains
    as it would have in its old lane.  Before the row sums of dO * O were a
    reduction, the einsum behind them gave the last lane other bits."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    one = [torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
           for shape in ((4, 1024, 24, 128), (4, 1024, 2, 128), (4, 1024, 2, 128))]
    q, k, v = (t.repeat(4, 1, 1, 1).requires_grad_(True) for t in one)
    from repro_torch.kernels import ops

    out = ops.attention(q, k, v, causal=True)
    dout = torch.randn(one[0].shape, generator=gen, device=cuda).to(torch.bfloat16)
    grads = torch.autograd.grad(out, (q, k, v), dout.repeat(4, 1, 1, 1))
    for g in grads:
        lanes = _raw(g).reshape(4, -1)
        assert all(torch.equal(lanes[0], lanes[i]) for i in range(1, 4))
