"""The port's prefetch ring (``repro_torch.data.ring``), its host datasets and
the ring-fed chunk, against the JAX package and against in-chunk synthesis.

On the CPU: ``SynthHostDataset`` against the JAX package's, bit for bit;
``ArrayHostDataset``'s rows; the ring's fences (it fills ahead and stops at
capacity, a new lane table drops the prefetch, an unchanged one keeps it,
``stop`` wakes a waiter, a fill error reaches the consumer, the overlap
share stays in [0, 1]); the ring chunk against JAX's
``make_population_ring_scan_step`` within 1e-4 and against in-chunk
synthesis bit for bit across the ring's wraparound; a ring-fed batch
flight and a ring-fed refill flight bit-equal to their in-chunk twins, and
one fed from a token array in host memory; the
CLI with ``--data-ring`` against the JAX CLI within 1e-4.  On an NVIDIA GPU
(marker ``cuda``): the ring's side-stream fill read by replayed chunk
graphs, bit-equal to in-chunk synthesis.

JAX is imported inside the tests that compare with it.
"""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.resource.vectorized import QueueFeedScheduler
from repro_torch.data.pipeline import (
    ArrayHostDataset,
    SynthHostDataset,
    SyntheticLM,
    split_streams,
    synth_population_batch_device,
    tokens_to_batch_device,
)
from repro_torch.data.ring import PrefetchRing
from repro_torch.launch import hpo
from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
from repro_torch.train import population as P
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

ARCH = "starcoder2-3b"
SEQ, BATCH, K = 16, 2, 4
_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    return jax, jnp


def _spec():
    return SyntheticLM(vocab_size=256, seq_len=SEQ, global_batch=BATCH)


def _tc():
    return TrainConfig(model=get_smoke_config(ARCH), parallel=ParallelConfig(remat="none"),
                       total_steps=8)


def _raw(t):
    t = t.detach()
    return t.to(torch.uint8) if t.dtype == torch.bool else t.view(_INT_OF_SIZE[t.element_size()])


def _bits_equal(a, b):
    return all(torch.equal(_raw(x), _raw(y))
               for x, y in zip(interop.tree_leaves(a), interop.tree_leaves(b)))


# ------------------------------------------------------------- host datasets
STREAMS, STEPS = [3, 11, -5, 7], [0, 4, 9, 2]


def test_synth_host_dataset_matches_jax_and_the_device_synthesis():
    """``lane_block`` and ``lane_window`` equal the JAX package's adapter bit
    for bit, and ``lane_block`` equals the port's device synthesis."""
    _jax()
    from repro.data.pipeline import SynthHostDataset as JaxSynthHostDataset
    from repro.data.pipeline import SyntheticLM as JaxSyntheticLM

    spec = _spec()
    ds = SynthHostDataset(spec)
    jds = JaxSynthHostDataset(JaxSyntheticLM(vocab_size=256, seq_len=SEQ, global_batch=BATCH))
    block = ds.lane_block(STREAMS, STEPS)
    assert block.shape == (4, BATCH, SEQ + 1) and block.dtype == np.int32
    np.testing.assert_array_equal(block, jds.lane_block(STREAMS, STEPS))
    np.testing.assert_array_equal(ds.lane_window(STREAMS, STEPS, 5),
                                  jds.lane_window(STREAMS, np.asarray(STEPS, np.int64), 5))
    lo, hi = (torch.from_numpy(w.astype(np.int64)) for w in split_streams(STREAMS))
    want = synth_population_batch_device(spec, lo, hi, torch.tensor(STEPS))
    np.testing.assert_array_equal(block[:, :, :-1], want["tokens"].numpy())
    np.testing.assert_array_equal(block[:, :, 1:], want["targets"].numpy())


def test_array_host_dataset_reads_consecutive_rows_and_wraps():
    n, stride = 64, 997
    toks = np.arange(n * (SEQ + 1), dtype=np.int32).reshape(n, SEQ + 1)
    ds = ArrayHostDataset(toks, global_batch=BATCH)
    block = ds.lane_block([0, 1], [0, 2])
    np.testing.assert_array_equal(block[0], toks[:BATCH])
    np.testing.assert_array_equal(block[1], toks[(stride + 2 * BATCH + np.arange(BATCH)) % n])
    short = ArrayHostDataset(toks[:5], global_batch=BATCH)   # forces wraparound reads
    for step in range(7):
        np.testing.assert_array_equal(short.lane_block([0], [step])[0],
                                      toks[:5][((step * BATCH) + np.arange(BATCH)) % 5])
    with pytest.raises(ValueError, match="non-empty"):
        ArrayHostDataset(np.zeros((0, SEQ + 1), np.int32), global_batch=BATCH)


@pytest.mark.parametrize("make_ds", [
    lambda: SynthHostDataset(_spec()),
    lambda: ArrayHostDataset(np.arange(64 * (SEQ + 1), dtype=np.int32).reshape(64, SEQ + 1),
                             global_batch=BATCH),
], ids=["synth", "array"])
def test_lane_window_bit_equals_stacked_lane_blocks(make_ds):
    ds = make_ds()
    got = ds.lane_window(STREAMS, np.asarray(STEPS, np.int64), 5)
    want = np.stack([ds.lane_block(STREAMS, [s + t for s in STEPS]) for t in range(5)])
    assert got.shape == (5, 4, BATCH, SEQ + 1)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- ring fences
def _ring(win_steps=2, windows=2, dataset=None):
    return PrefetchRing(dataset or SynthHostDataset(_spec()), population=K,
                        win_steps=win_steps, windows=windows)


def test_ring_fills_ahead_and_blocks_at_capacity():
    ring = _ring(win_steps=4)
    try:
        ring.set_lanes(list(range(K)), [0] * K, at_step=0)
        assert ring.wait_filled(0, 8) == 8   # both windows fill unprompted
        time.sleep(0.05)
        assert ring.n_fills == 2, "the filler must stop at capacity"
        ring.consume_to(4)                   # frees one window
        assert ring.wait_filled(4, 8) == 8
        assert ring.n_fills == 3
    finally:
        ring.stop()


def test_ring_set_lanes_drops_the_prefetch_and_an_unchanged_table_keeps_it():
    ds = SynthHostDataset(_spec())
    ring = _ring(dataset=ds)
    try:
        streams = list(range(K))
        ring.set_lanes(streams, [0] * K, at_step=0)
        ring.wait_filled(0, 4)
        fills = ring.n_fills
        ring.set_lanes(streams, [0] * K, at_step=2)   # an unchanged table: a no-op
        assert ring.n_invalidations == 0 and ring.wait_filled(2, 2) >= 2
        assert ring.n_fills == fills
        ring.set_lanes(list(range(K, 2 * K)), [3] * K, at_step=2)
        assert ring.n_invalidations == 1
        ring.wait_filled(2, 2)
        np.testing.assert_array_equal(ring.slots[2 % ring.capacity].numpy(),
                                      ds.lane_block(list(range(K, 2 * K)), [5] * K))
    finally:
        ring.stop()


def test_ring_stop_wakes_a_waiter():
    ring = _ring()
    errs = []

    def waiter():
        try:
            ring.wait_filled(10_000)   # lanes never set: would block for ever
        except RuntimeError as e:
            errs.append(e)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    ring.stop()
    t.join(timeout=5.0)
    assert not t.is_alive() and len(errs) == 1


def test_ring_fill_errors_reach_the_consumer():
    class Broken:
        seq_len, global_batch = SEQ, BATCH

        def lane_block(self, streams, steps):
            raise ValueError("boom")

    ring = _ring(dataset=Broken())
    try:
        ring.set_lanes(list(range(K)), [0] * K, at_step=0)
        with pytest.raises(RuntimeError, match="ring fill failed"):
            ring.wait_filled(0)
    finally:
        ring.stop()


def test_ring_overlap_frac_bounds_and_refusals():
    ring = _ring()
    try:
        assert ring.overlap_frac == 1.0   # no fills yet
        ring.set_lanes(list(range(K)), [0] * K, at_step=0)
        ring.wait_filled(0, 4)
        assert 0.0 <= ring.overlap_frac <= 1.0
        with pytest.raises(ValueError, match="streams for"):
            ring.set_lanes([0], [0], at_step=0)
    finally:
        ring.stop()
    with pytest.raises(ValueError, match="two windows"):
        _ring(windows=1)
    with pytest.raises(ValueError, match="ring buffer"):
        PrefetchRing(SynthHostDataset(_spec()), K, 2, buffer=torch.zeros(3, dtype=torch.int32))


def test_ring_slabs_stay_right_under_fast_thread_switching():
    """The fill thread against the consumer with the interpreter switching
    threads every microsecond: 60 chunks of 1 or 2 steps, the lane table
    re-keyed every few chunks; every slab the consumer reads between
    ``wait_filled`` and ``consume_to`` is the dataset's block for its step
    and the current table."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    ds = SynthHostDataset(_spec())
    ring = _ring(win_steps=2, windows=3)
    try:
        streams, offsets, s = list(range(K)), [0] * K, 0
        ring.set_lanes(streams, offsets, at_step=0)
        for i in range(60):
            t = 1 + i % 2
            ring.wait_filled(s, t)
            for j in range(t):
                np.testing.assert_array_equal(
                    ring.slots[(s + j) % ring.capacity].numpy(),
                    ds.lane_block(streams, [o + s + j for o in offsets]))
            ring.consume_to(s + t)
            s += t
            if i % 7 == 3:
                streams, offsets = [x + 1 for x in streams], [i] * K
                ring.set_lanes(streams, offsets, at_step=s)
        assert ring.n_invalidations >= 1
    finally:
        ring.stop()
        sys.setswitchinterval(old)
    assert not ring._thread.is_alive()


# ------------------------------------------------------------- the ring chunk
def test_ring_chunk_matches_jax_ring_scan_step():
    """Two ring chunks of 4 (the second wraps a ring of capacity 6) against
    JAX's ``make_population_ring_scan_step`` from the same JAX init and the
    same slabs: per-step losses, last_loss and parameters within 1e-4, step
    counters and latches exactly."""
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
    tc, chunk, cap = _tc(), 4, 6
    data = SyntheticLM(tc.model.vocab_size, SEQ, BATCH, seed=0)
    jdata = JaxSyntheticLM(tc.model.vocab_size, SEQ, BATCH, seed=0)
    cfgs = [dict(learning_rate=lr, total_steps=8, warmup_frac=0.25)
            for lr in (1e-3, 3e-3, 2e-3, 5e-3)]
    jhp = jax_stack([jax_hparams(c, jtc) for c in cfgs])
    hp = stack_hparams([hparams_from_dict(c, tc) for c in cfgs])
    jp = JP.init_population_state_from_keys(jax.random.split(jax.random.PRNGKey(0), K), jtc)
    tp = interop.to_torch(jax.device_get(jp))
    streams = [0, 5, 2, 7]
    slabs = SynthHostDataset(data).lane_window(streams, [0] * K, 8)
    ring = np.zeros((cap,) + slabs.shape[1:], np.int32)
    jscan = jax.jit(JP.make_population_ring_scan_step(jtc, jdata, chunk, cap))
    prog = P.get_compiled_population_ring_scan_step(tc, K, data, chunk, cap)
    for c in range(2):
        for t in range(chunk):
            ring[(c * chunk + t) % cap] = slabs[c * chunk + t]
        slot0 = (c * chunk) % cap
        jp, jm = jscan(jp, jhp, jnp.asarray(ring), jnp.asarray(slot0, jnp.int32))
        tp, m = prog(tp, hp, torch.from_numpy(ring.copy()), slot0)
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tp["last_loss"].numpy(), np.asarray(jp["last_loss"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tp["inner"]["opt"]["step"].numpy(),
                                  np.asarray(jp["inner"]["opt"]["step"]))
    np.testing.assert_array_equal(tp["diverged"].numpy(), np.asarray(jp["diverged"]))
    for g, w in zip(interop.tree_leaves(interop.to_numpy(tp["inner"]["params"])),
                    jax.tree.leaves(jp["inner"]["params"])):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4)


def _population(tc):
    pstate = P.init_population_state_from_keys(
        [torch.Generator().manual_seed(i) for i in range(K)], tc, "cpu")
    hp = stack_hparams([hparams_from_dict({"learning_rate": 1e-3 * (i + 1), "total_steps": 8},
                                          tc) for i in range(K)], "cpu")
    return pstate, hp


def test_ring_chunk_bit_equals_in_chunk_synthesis_across_wraparound():
    """Three chunks of 2 through a ring of capacity 4 (the third wraps), the
    lanes at different data cursors: every state leaf and every step's loss
    equal the in-chunk synthesis chunks' bit for bit."""
    tc, chunk = _tc(), 2
    data = SyntheticLM(tc.model.vocab_size, SEQ, BATCH, seed=0)
    streams, offsets = [2, 9, -3, 15], [0, 3, 5, 1]
    lo, hi = (torch.from_numpy(w.astype(np.int64)) for w in split_streams(streams))
    a, hp = _population(tc)
    scan = P.get_compiled_population_scan_step(tc, K, data, chunk)
    want = []
    for c in range(3):
        a, m = scan(a, hp, torch.tensor(offsets) + c * chunk, lo, hi)
        want.append(m["loss"].clone())
    b, hp = _population(tc)
    ring = PrefetchRing(SynthHostDataset(data), population=K, win_steps=chunk, windows=2)
    rscan = P.get_compiled_population_ring_scan_step(tc, K, data, chunk, ring.capacity)
    try:
        ring.set_lanes(streams, offsets, at_step=0)
        for c in range(3):
            s = c * chunk
            ring.wait_filled(s, chunk)
            b, m = rscan(b, hp, ring.slots, s % ring.capacity)
            ring.consume_to(s + chunk)
            assert torch.equal(_raw(m["loss"]), _raw(want[c]))
        assert ring.n_fills >= 3
    finally:
        ring.stop()
    assert _bits_equal(a, b)


# ------------------------------------------------------------- flights
def _flight_trial(chunk=4, data_ring=False, population=K, steps=8, **kw):
    trial = hpo.PopulationTrial(ARCH, steps=steps, batch=BATCH, seq=SEQ, seed=0,
                                population=population, refill_idle_grace_s=0.0,
                                chunk_steps=chunk, data_ring=data_ring, device="cpu", **kw)
    record = []
    trial.record_flight = lambda losses, pstate: record.append(
        (losses.clone(), interop.tree_map(lambda t: t.clone(), pstate)))
    return trial, record


def test_ring_fed_batch_flight_bit_equals_in_chunk_synthesis():
    """A batch flight of 8 steps in chunks of 4 (two windows of a ring of
    8), ring-fed and with in-chunk synthesis: the same scores, per-step
    losses and final state bit for bit."""
    cfgs = [{"learning_rate": 1e-3 * (i + 1), "stream": 10 + i} for i in range(K)]
    out = {}
    for ring in (False, True):
        trial, record = _flight_trial(data_ring=ring)
        out[ring] = (trial.run_population(cfgs), record[0], trial)
    assert out[True][0] == out[False][0]
    assert torch.equal(_raw(out[True][1][0]), _raw(out[False][1][0]))
    assert _bits_equal(out[True][1][1], out[False][1][1])
    ringed = out[True][2]
    assert ringed.n_ring_fills >= 2 and ringed.n_dispatches == 2
    assert 0.0 <= ringed.ring_overlap_frac <= 1.0


def test_ring_fed_refill_flight_bit_equals_in_chunk_synthesis():
    """A refill flight (trials of 2, 2, 4 and 4 steps on 4 lanes, then two of
    2 steps refilling lanes 0 and 1 at step 2, re-keying the ring at their
    own cursors; no lane idles, so every step's loss is a trial's):
    ring-fed and in-chunk synthesis stream the same scores in the same
    order, with the same per-step losses and final state bit for bit."""
    cfgs = [{"learning_rate": 1e-3 * (i + 1), "n_iterations": n, "stream": i}
            for i, n in enumerate((1, 1, 2, 2, 1, 1))]
    out = {}
    for ring in (False, True):
        trial, record = _flight_trial(data_ring=ring, steps=2)
        feed = QueueFeedScheduler(cfgs)
        trial.run_population([], scheduler=feed)
        out[ring] = (feed.ordered_scores(6), list(feed.scores), record[0], trial)
    assert out[True][:2] == out[False][:2]
    assert torch.equal(_raw(out[True][2][0]), _raw(out[False][2][0]))
    assert _bits_equal(out[True][2][1], out[False][2][1])
    assert out[True][3].n_refills >= 2 and out[True][3].n_ring_fills >= 2


def test_ring_fed_flight_reads_a_host_array_dataset():
    """A trial's ``host_dataset`` feeds its ring: a batch flight trained on
    a token array in host memory scores as the same flight fed that
    array's rows by hand (the per-step loop on the same batches), and not
    as the synthetic stream."""
    tc = _tc()
    toks = np.random.default_rng(0).integers(0, tc.model.vocab_size, (40, SEQ + 1),
                                             dtype=np.int32)
    ds = ArrayHostDataset(toks, global_batch=BATCH)
    cfgs = [{"learning_rate": 1e-3 * (i + 1), "stream": i} for i in range(K)]
    trial, _ = _flight_trial(data_ring=True, steps=4)
    trial.host_dataset = ds
    got = trial.run_population(cfgs)
    synth, _ = _flight_trial(data_ring=True, steps=4)
    assert got != synth.run_population(cfgs)
    data = SyntheticLM(tc.model.vocab_size, SEQ, BATCH, seed=0)
    pstate = P.init_population_state(trial._generator(0), tc, K, "cpu")
    hp = stack_hparams([trial._hparams(c, 4) for c in cfgs], "cpu")
    step = P.make_population_train_step(tc, per_trial_batch=True)
    for s in range(4):
        slab = torch.from_numpy(ds.lane_block(list(range(K)), [s] * K))
        pstate, _ = step(pstate, tokens_to_batch_device(data, slab), hp)
    assert got == P.population_scores(pstate, trial.DIVERGED_SCORE).tolist()


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


@pytest.mark.parametrize("extra", [[], ["--lane-refill"]], ids=["batch", "refill"])
def test_data_ring_cli_matches_jax_cli(jax_init, capsys, extra):
    """``--chunk-steps 4 --data-ring`` through the JAX CLI and the port's:
    the same best config, best scores within 1e-4, the ``+ring`` engine and
    the ring's keys of the JAX CLI's output."""
    from repro.launch import hpo as jax_hpo

    argv = ["--n-samples", "4", "--steps", "8", "--batch", "2", "--seq", "16",
            "--vectorize", "4", "--chunk-steps", "4", "--data-ring"] + extra
    assert jax_hpo.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert hpo.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["best_config"] == want["best_config"]
    np.testing.assert_allclose(got["best_score"], want["best_score"], atol=1e-4, rtol=1e-4)
    assert got["engine"] == want["engine"] and got["engine"].endswith("+ring")
    for key in ("ring_windows", "ring_fills", "ring_invalidations", "ring_fill_wait_s",
                "ring_fill_busy_s", "overlap_frac"):
        assert key in got, key
    assert got["ring_fills"] >= 1 and 0.0 <= got["overlap_frac"] <= 1.0


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ring's side-stream fill and the chunk "
                    "graphs run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_ring_chunk_graphs_on_the_card_equal_in_chunk_synthesis(cuda):
    """On the card: four ring chunks of 2 (the ring wraps twice), each one
    replay of a captured graph reading the geometry's ring tensor, filled
    on the ring's side stream, leave the state bit-equal to four in-chunk
    synthesis chunks from the same start."""
    tc, chunk = _tc(), 2
    data = SyntheticLM(tc.model.vocab_size, SEQ, BATCH, seed=0)
    streams = [2, 9, -3, 15]
    lo, hi = (torch.from_numpy(w.astype(np.int64)).to(cuda) for w in split_streams(streams))
    cpu, hp_cpu = _population(tc)
    hp = stack_hparams([hparams_from_dict({"learning_rate": 1e-3 * (i + 1), "total_steps": 8},
                                          tc) for i in range(K)], cuda)
    a = interop.tree_map(lambda t: t.to(cuda, copy=True), cpu)
    scan = P.get_compiled_population_scan_step(tc, K, data, chunk)
    for c in range(4):
        a, _ = scan(a, hp, torch.full((K,), c * chunk, device=cuda), lo, hi)
    a = interop.tree_map(lambda t: t.clone(), a)
    P.clear_population_cache()
    b = interop.tree_map(lambda t: t.to(cuda, copy=True), cpu)
    buf = P.ring_buffer(tc, K, data, 2 * chunk, cuda)
    ring = PrefetchRing(SynthHostDataset(data), K, chunk, windows=2, buffer=buf)
    rscan = P.get_compiled_population_ring_scan_step(tc, K, data, chunk, ring.capacity)
    try:
        ring.set_lanes(streams, [0] * K, at_step=0)
        for c in range(4):
            s = c * chunk
            ring.wait_filled(s, chunk)
            b, _ = rscan(b, hp, ring.slots, s % ring.capacity)
            ring.consume_to(s + chunk)
        torch.cuda.synchronize()
    finally:
        ring.stop()
        stats = P.graph_stats()
        P.clear_population_cache()
    assert [g["kind"] for g in stats] == ["ringscan"]
    assert _bits_equal(a, b)
