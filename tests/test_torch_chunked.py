"""The port's fused chunked engine against its per-step loop and the JAX package.

On the CPU: device-side batch synthesis (plain PyTorch) bit for bit against
the numpy host path and JAX's ``synth_population_batch(xp=jnp)``; a chunk
bit for bit against the per-step loop inside the port (mid-chunk budget end,
mid-chunk divergence, shared stream); the chunk against JAX's
``make_population_scan_step`` within 1e-4 in both batch modes; the chunk
cache's bound; the lease on a geometry's captured state; and the CLI with
``--chunk-steps`` against the JAX CLI (1e-4) and against its own per-step
run (bit for bit).  Initial states come
from JAX through ``repro_torch.interop``.  On an NVIDIA GPU (marker
``cuda``): the synthesis kernel against its plain version, a chunk replayed
from its CUDA graph against the eager per-step loop, and two overlapping
chunked flights against their per-step flights, bit for bit.

JAX is imported inside the tests that compare with it, so the card-only
cases also run where JAX is not installed:
``python -m pytest tests/test_torch_chunked.py -m cuda``.
"""
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.data import pipeline as dp
from repro_torch.data.pipeline import SyntheticLM, split_stream, split_streams
from repro_torch.kernels import build
from repro_torch.kernels import synth as sk
from repro_torch.launch import hpo
from repro_torch.launch.chunkplan import pow2_floor
from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
from repro_torch.train import population as P

torch.set_num_threads(2)

ARCH = "starcoder2-3b"
SEQ, BATCH = 16, 2
STREAMS = (0, 1, 7, 12345, -1, -3)


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    return jax, jnp


def _tc():
    return TrainConfig(model=get_smoke_config(ARCH), parallel=ParallelConfig(remat="none"),
                       total_steps=8)


def _data(tc, seq=SEQ, batch=BATCH):
    return SyntheticLM(tc.model.vocab_size, seq, batch, seed=0)


def _words(streams):
    return tuple(torch.from_numpy(w.astype(np.int64)) for w in split_streams(streams))


def _hp(tc, lrs, budgets, **kw):
    return stack_hparams([hparams_from_dict(dict(kw, learning_rate=lr, total_steps=b), tc)
                          for lr, b in zip(lrs, budgets)])


def _state(tc, k):
    return P.init_population_state_from_keys(
        [torch.Generator().manual_seed(i) for i in range(k)], tc, "cpu")


def _clone(tree):
    return interop.tree_map(lambda t: t.clone(), tree)


_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _raw(t):
    """A tensor's raw bits as integers (so NaNs compare equal to themselves)."""
    t = t.detach()
    return t.to(torch.uint8) if t.dtype == torch.bool else t.view(_INT_OF_SIZE[t.element_size()])


def _bits_equal(a, b):
    return all(torch.equal(_raw(x), _raw(y))
               for x, y in zip(interop.tree_leaves(a), interop.tree_leaves(b)))


def _loop(tc, data, pstate, hp, steps, streams, per_trial_batch=True):
    """The per-step loop on host-built batches; per-step losses (steps, K)."""
    step = P.make_population_train_step(tc, per_trial_batch=per_trial_batch)
    losses = []
    for s in range(steps):
        b = (data.make_population_batch(s, streams) if per_trial_batch else data.make_batch(s))
        pstate, m = step(pstate, dp.to_device(b, "cpu"), hp)
        losses.append(m["loss"].clone())
    return pstate, torch.stack(losses)


# ------------------------------------------------------------- device synthesis
@pytest.mark.parametrize("stream", STREAMS)
def test_device_batch_matches_host_batch_bitwise(stream):
    """``synth_batch_device`` at cursor 4 + offset 1 equals ``make_batch(5,
    stream)`` bit for bit, dtypes included; sentinel streams too."""
    data = SyntheticLM(1000, 24, 3, seed=5)
    lo, hi = (torch.tensor(w, dtype=torch.int64) for w in split_stream(stream))
    got = dp.synth_batch_device(data, lo, hi, torch.tensor(4), offset=1)
    want = data.make_batch(5, stream=stream)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_device_population_batch_matches_host_and_jax():
    """Per-lane cursors [0, 3, 1, 7] over real and sentinel streams: the
    torch device synthesis equals the numpy host path and JAX's
    ``synth_population_batch`` traced with ``xp=jnp``, bit for bit."""
    jax, jnp = _jax()
    from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
    from repro.data.pipeline import synth_population_batch

    streams, steps = [0, 9, -1, -2], np.asarray([0, 3, 1, 7])
    data = SyntheticLM(512, 32, 3, seed=3)
    jdata = JaxSyntheticLM(512, 32, 3, seed=3)
    lo, hi = split_streams(streams)
    got = dp.synth_population_batch_device(data, *_words(streams), torch.from_numpy(steps))
    host = data.make_population_batch(steps, streams)
    dev = jax.jit(lambda st: synth_population_batch(jdata, lo, hi, st, xp=jnp))(
        jnp.asarray(steps, jnp.int32))
    for k in host:
        np.testing.assert_array_equal(got[k].numpy(), host[k])
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(dev[k]))
    for i, (s, st) in enumerate(zip(streams, steps)):
        np.testing.assert_array_equal(got["tokens"][i].numpy(),
                                      data.make_batch(int(st), stream=s)["tokens"])


def test_device_synthesis_takes_the_low_32_bits_of_wide_cursors():
    """A cursor past 2^32 and int32 stream words above 2^31 (as negative
    int32) hash exactly as the host path's uint32 words."""
    data = SyntheticLM(300, 8, 2, seed=-7)
    step = (1 << 33) + 5
    lo, hi = split_stream(-2)
    got = dp.synth_batch_device(data, torch.tensor(lo).to(torch.int32),
                                torch.tensor(hi).to(torch.int32), torch.tensor(step))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  data.make_batch(step, stream=-2)["tokens"])


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

U32 = st.integers(min_value=0, max_value=0xFFFFFFFF)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.lists(U32, min_size=1, max_size=8), min_size=1, max_size=6))
def test_torch_hash_matches_numpy_hash_over_the_uint32_range(rows):
    """``_hash_u32_t`` (masked int64, products by 16-bit halves) equals the
    numpy uint32 ``_hash_u32`` bit for bit on words drawn from the full
    uint32 range; each row is one list of words."""
    n_words = max(len(r) for r in rows)
    words = np.asarray([r + [0] * (n_words - len(r)) for r in rows], np.uint32)
    want = dp._hash_u32((len(rows),), [words[:, j] for j in range(n_words)])
    cols = [torch.from_numpy(words[:, j].astype(np.int64)) for j in range(n_words)]
    got = dp._hash_u32_t((len(rows),), cols, "cpu")
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@settings(max_examples=200, deadline=None)
@given(U32, U32)
def test_mul32_matches_uint32_multiply(a, c):
    want = (a * c) & 0xFFFFFFFF
    assert int(dp._mul32(torch.tensor([a], dtype=torch.int64), c)[0]) == int(want)


def test_synth_wrapper_on_cpu_launches_nothing_and_checks_inputs():
    """A CPU tensor takes the plain version (no launch counted); wrong shapes
    and float cursors are refused before any launch."""
    data = SyntheticLM(100, 8, 2)
    sk.reset_launches()
    z = torch.zeros(3, dtype=torch.int64)
    assert sk.synth_tokens(data, z, z, z).shape == (3, 2, 9)
    assert sk.launches == 0
    with pytest.raises(ValueError, match="must be"):
        sk.synth_tokens(data, z, z[:2], z)
    with pytest.raises(TypeError, match="integer"):
        sk.synth_tokens(data, z.float(), z, z)


def test_synth_kernel_source_and_signature():
    text = (build.CSRC / "synth_tokens.cu").read_text()
    assert "synth_tokens" in text and "Bound on this card" in text
    assert "synth_tokens_fwd" in build.SIGNATURES


# ------------------------------------------------------------- chunk vs loop
def test_chunk_matches_per_step_loop_bitwise():
    """A chunk of 8 against 8 per-step calls on host batches: every state leaf
    and every per-step loss equal bit for bit; the lane with budget 5 stops
    at step 5 inside the chunk; metrics stacked (chunk, K)."""
    tc = _tc()
    data = _data(tc)
    streams = [0, 5, -1, 7]
    hp = _hp(tc, [1e-3, 3e-3, 2e-3, 5e-3], [8, 5, 8, 8])
    init = _state(tc, 4)
    want, want_loss = _loop(tc, data, _clone(init), hp, 8, streams)
    scan = P.get_compiled_population_scan_step(tc, 4, data, 8)
    got, metrics = scan(_clone(init), hp, torch.zeros(4, dtype=torch.int64), *_words(streams))
    assert metrics["loss"].shape == (8, 4)
    assert torch.equal(_raw(metrics["loss"]), _raw(want_loss))
    assert _bits_equal(got, want)
    assert got["inner"]["opt"]["step"].tolist() == [8, 5, 8, 8]


def test_chunk_shared_stream_matches_loop_bitwise():
    """``per_trial_batch=False``: one (B, S) batch of stream 0 made on the
    device and broadcast to every lane, bit for bit the per-step loop."""
    tc = _tc()
    data = _data(tc)
    hp = _hp(tc, [1e-3, 4e-3], [4, 4])
    init = _state(tc, 2)
    want, _ = _loop(tc, data, _clone(init), hp, 4, None, per_trial_batch=False)
    lo, hi = (torch.tensor(w, dtype=torch.int64) for w in split_stream(0))
    scan = P.get_compiled_population_scan_step(tc, 2, data, 4, per_trial_batch=False)
    got, _ = scan(_clone(init), hp, torch.tensor(0, dtype=torch.int64), lo, hi)
    assert _bits_equal(got, want)


def test_divergence_latches_mid_chunk_like_the_loop():
    """Lane 1 (lr 1e9, no clipping) goes non-finite inside the chunk: it
    latches and freezes there, lane 0 trains on, and the state equals the
    per-step loop's bit for bit."""
    tc = _tc()
    data = _data(tc)
    hp = stack_hparams([hparams_from_dict(dict(learning_rate=1e-3, total_steps=8), tc),
                        hparams_from_dict(dict(learning_rate=1e9, grad_clip=0.0,
                                               warmup_steps=1, total_steps=8), tc)])
    init = _state(tc, 2)
    want, want_loss = _loop(tc, data, _clone(init), hp, 8, [0, 1])
    scan = P.get_compiled_population_scan_step(tc, 2, data, 8)
    got, metrics = scan(_clone(init), hp, torch.zeros(2, dtype=torch.int64), *_words([0, 1]))
    assert got["diverged"].tolist() == [False, True]
    assert 0 < int(got["inner"]["opt"]["step"][1]) < 8
    assert int(got["inner"]["opt"]["step"][0]) == 8
    assert _bits_equal(got, want)
    assert torch.equal(_raw(metrics["loss"]), _raw(want_loss))


def test_population_init_into_an_existing_state_equals_a_fresh_one():
    """``init_population_state(..., out=)`` and the per-key variant write the
    fresh state into a trained one: bit for bit a fresh init, latch and
    last_loss reset."""
    tc = _tc()
    data = _data(tc)
    used = _state(tc, 2)
    used, _ = _loop(tc, data, used, _hp(tc, [1e-3, 1e9], [3, 3], grad_clip=0.0), 3, [0, 1])
    fresh = P.init_population_state(torch.Generator().manual_seed(4), tc, 2, "cpu")
    got = P.init_population_state(torch.Generator().manual_seed(4), tc, 2, "cpu", out=used)
    assert got is used and _bits_equal(got, fresh)
    keyed = P.init_population_state_from_keys(
        [torch.Generator().manual_seed(i) for i in (5, 6)], tc, "cpu", out=used)
    want = P.init_population_state_from_keys(
        [torch.Generator().manual_seed(i) for i in (5, 6)], tc, "cpu")
    assert _bits_equal(keyed, want)


# ------------------------------------------------------------- against JAX
@pytest.mark.parametrize("per_trial_batch", [True, False], ids=["per-trial", "shared-stream"])
def test_chunk_matches_jax_scan_step(per_trial_batch):
    """The chunked step against JAX's ``make_population_scan_step`` from the
    same JAX init (mid-chunk budget end on lane 1): last_loss, parameters
    and per-step losses within 1e-4, step counters and latches equal."""
    jax, jnp = _jax()
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import ParallelConfig as JaxParallelConfig
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
    from repro.optim.hparams import hparams_from_dict as jax_hparams_from_dict
    from repro.optim.hparams import stack_hparams as jax_stack_hparams
    from repro.train import population as JP

    k, chunk = 4, 4
    jtc = JaxTrainConfig(model=jax_smoke_config(ARCH),
                         parallel=JaxParallelConfig(remat="none"), total_steps=8)
    tc = _tc()
    jdata = JaxSyntheticLM(tc.model.vocab_size, SEQ, BATCH, seed=0)
    data = _data(tc)
    cfgs = [dict(learning_rate=lr, total_steps=b, warmup_frac=0.25)
            for lr, b in zip([1e-3, 3e-3, 2e-3, 5e-3], [4, 3, 4, 4])]
    jhp = jax_stack_hparams([jax_hparams_from_dict(c, jtc) for c in cfgs])
    hp = stack_hparams([hparams_from_dict(c, tc) for c in cfgs])
    keys = jax.random.split(jax.random.PRNGKey(0), k)
    jp = JP.init_population_state_from_keys(keys, jtc)
    tp = interop.to_torch(jax.device_get(jp))
    streams = [0, 5, -1, 7]
    if per_trial_batch:
        jlo, jhi = (jnp.asarray(w) for w in split_streams(streams))
        jsteps, steps = jnp.zeros(k, jnp.int32), torch.zeros(k, dtype=torch.int64)
        lo, hi = _words(streams)
    else:
        jlo, jhi = (jnp.uint32(w) for w in split_stream(0))
        jsteps, steps = jnp.asarray(0, jnp.int32), torch.tensor(0)
        lo, hi = (torch.tensor(w, dtype=torch.int64) for w in split_stream(0))
    jscan = jax.jit(JP.make_population_scan_step(jtc, jdata, chunk,
                                                 per_trial_batch=per_trial_batch))
    jp, jm = jscan(jp, jhp, jsteps, jlo, jhi)
    scan = P.get_compiled_population_scan_step(tc, k, data, chunk,
                                               per_trial_batch=per_trial_batch)
    tp, m = scan(tp, hp, steps, lo, hi)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tp["last_loss"].numpy(), np.asarray(jp["last_loss"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tp["inner"]["opt"]["step"].numpy(),
                                  np.asarray(jp["inner"]["opt"]["step"]))
    np.testing.assert_array_equal(tp["diverged"].numpy(), np.asarray(jp["diverged"]))
    for g, w in zip(interop.tree_leaves(interop.to_numpy(tp["inner"]["params"])),
                    jax.tree.leaves(jp["inner"]["params"])):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------- cache
def test_chunk_cache_is_bounded_and_cleared():
    """A flight of 13 steps dispatches a chunk of 8, one of 4 and one of a
    single step, each a chunk program: repeated chunked flights keep at most
    log2(T)+1 chunk programs, and ``clear_population_cache`` empties the
    cache."""
    P.clear_population_cache()
    trial = hpo.PopulationTrial(ARCH, steps=13, batch=BATCH, seq=SEQ, seed=0, population=2,
                                chunk_steps=8, device="cpu")
    cfgs = [dict(learning_rate=1e-3, stream=0), dict(learning_rate=2e-3, stream=1)]
    first = trial.run_population(cfgs)
    size = len(P._POP_CACHE)
    assert trial.n_dispatches == 3 and trial.n_train_steps == 13
    assert trial.run_population(cfgs) == first
    assert size == len(P._POP_CACHE) == 3 <= pow2_floor(8).bit_length()
    P.clear_population_cache()
    assert not P._POP_CACHE and not P._GRAPHS


def test_driver_keeps_losses_and_hands_over_the_final_state():
    """``record_flight`` gets a flight's per-step losses (steps, K), equal
    between a chunked and a per-step flight, and its final state; without
    it the driver keeps no losses."""
    seen = {}
    runs = {}
    for chunk in (1, 4):
        trial = hpo.PopulationTrial(ARCH, steps=8, batch=BATCH, seq=SEQ, seed=0,
                                    population=2, chunk_steps=chunk, device="cpu")
        trial.record_flight = lambda ls, ps, c=chunk: seen.__setitem__(c, (ls, _clone(ps)))
        scores = trial.run_population([dict(learning_rate=1e-3), dict(learning_rate=3e-3)])
        runs[chunk] = (scores, trial.n_dispatches)
    assert runs[1][0] == runs[4][0]
    assert seen[1][0].shape == (8, 2) and torch.equal(_raw(seen[1][0]), _raw(seen[4][0]))
    assert (runs[1][1], runs[4][1]) == (8, 2)
    assert _bits_equal(seen[1][1], seen[4][1])
    quiet = hpo.PopulationTrial(ARCH, steps=8, batch=BATCH, seq=SEQ, seed=0, population=2,
                                chunk_steps=4, device="cpu")
    assert quiet.record_flight is None
    assert quiet.run_population([dict(learning_rate=1e-3), dict(learning_rate=3e-3)]) \
        == runs[4][0]


# ------------------------------------------------------------- the captured state
def test_flight_lease_makes_a_second_flight_of_the_geometry_wait():
    """``flight_lease`` on a card's geometry (no card is touched until a
    graph is captured): a second flight of the same geometry waits until the
    first has left; one of another geometry does not."""
    tc = _tc()
    data = _data(tc)
    order = []
    entered, release = threading.Event(), threading.Event()

    def first():
        with P.flight_lease(tc, 2, data, True, "cuda:0"):
            order.append("first in")
            entered.set()
            release.wait(10)
            order.append("first out")

    def second(k):
        with P.flight_lease(tc, k, data, True, "cuda:0"):
            order.append(f"K={k} in")

    P.clear_population_cache()
    a = threading.Thread(target=first)
    a.start()
    assert entered.wait(10)
    other = threading.Thread(target=second, args=(4,))
    other.start()
    other.join(10)
    same = threading.Thread(target=second, args=(2,))
    same.start()
    same.join(0.5)
    assert same.is_alive() and order == ["first in", "K=4 in"]
    release.set()
    for t in (a, same):
        t.join(10)
    assert order == ["first in", "K=4 in", "first out", "K=2 in"]
    P.clear_population_cache()


def test_captured_state_is_never_written_from_another_state():
    """After the first call binds a state as the geometry's captured state,
    a call with another state raises instead of copying it over the
    captured tensors; the captured state itself binds again."""
    tc = _tc()
    data = _data(tc)
    P.clear_population_cache()
    fg = P._flight_graphs(tc, 2, True, data, "cuda:0")
    hp = _hp(tc, [1e-3, 2e-3], [4, 4])
    words = _words([0, 1])
    steps0 = torch.zeros(2, dtype=torch.int64)
    mine, theirs = _state(tc, 2), _state(tc, 2)
    fg.bind(mine, hp, steps0, *words)
    fg.bind(mine, hp, steps0 + 4, *words)
    assert fg.inputs[1].tolist() == [4, 4]
    with pytest.raises(ValueError, match="captured another population state"):
        fg.bind(theirs, hp, steps0, *words)
    with P.flight_lease(tc, 2, data, True, "cuda:0") as st:
        assert st is mine
    P.clear_population_cache()


# ------------------------------------------------------------- CLI
BASE = ["--proposer", "asha", "--vectorize", "4", "--inflight-stop", "--steps", "4",
        "--batch", "2", "--seq", "16", "--n-samples", "4"]


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


@pytest.fixture
def jax_init(monkeypatch):
    """The port's trials start from the JAX init weights (the two RNGs differ)."""
    jax, _ = _jax()
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.train.train_step import init_train_state as jax_init_train_state
    from repro_torch.train import train_step as ts

    jtc = JaxTrainConfig(model=jax_smoke_config(ARCH))
    state = jax.device_get(jax_init_train_state(jax.random.PRNGKey(0), jtc))
    monkeypatch.setattr(ts, "init_train_state",
                        lambda gen, tc, device: interop.to_torch(state, device))


def test_cli_chunked_matches_jax_cli(jax_init, capsys):
    """``--chunk-steps 8 --inflight-stop``: the JAX CLI's engine name, best
    config, dispatch and step counts, and best score within 1e-4."""
    from repro.launch import hpo as jax_hpo

    argv = BASE + ["--chunk-steps", "8"]
    want = _run(jax_hpo.main, argv, capsys)
    got = _run(hpo.main, argv + ["--device", "cpu"], capsys)
    assert got["engine"] == want["engine"] == "vmapped+chunked"
    assert got["best_config"] == want["best_config"]
    for key in ("chunk_steps", "device_dispatches", "trained_steps",
                "inflight_truncated_lanes"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["best_score"], want["best_score"], atol=1e-4, rtol=1e-4)


def test_cli_chunked_equals_per_step_bitwise(capsys):
    """Inside the port the same flags with ``--chunk-steps 8`` and ``1`` give
    the same best score bit for bit, with fewer dispatches chunked."""
    per_step = _run(hpo.main, BASE + ["--chunk-steps", "1", "--device", "cpu"], capsys)
    chunked = _run(hpo.main, BASE + ["--chunk-steps", "8", "--device", "cpu"], capsys)
    assert chunked["best_score"] == per_step["best_score"]
    assert chunked["best_config"] == per_step["best_config"]
    assert chunked["trained_steps"] == per_step["trained_steps"]
    assert chunked["device_dispatches"] < per_step["device_dispatches"]


def test_cli_chunk_steps_needs_vectorize(capsys):
    with pytest.raises(SystemExit):
        hpo.main(["--chunk-steps", "4", "--device", "cpu"])
    assert "requires --vectorize" in capsys.readouterr().err


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels and graphs run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,rows,seq", [(4, 4, 1024), (4, 2, 1024), (3, 5, 4100), (1, 1, 1)])
def test_synth_kernel_matches_plain_bitwise(cuda, k, rows, seq):
    """The kernel against the plain version on the card: real and sentinel
    streams, per-lane cursors with an offset, a row longer than one tile."""
    data = SyntheticLM(49152, seq, rows, seed=11)
    streams = ([0, 12345, -1, -3] * k)[:k]
    lo, hi = (w.to(cuda) for w in _words(streams))
    steps = torch.arange(k, dtype=torch.int64, device=cuda) * 7
    sk.reset_launches()
    got = sk.synth_tokens_cuda(data, steps, lo, hi, offset=3)
    want = sk.synth_tokens_plain(data, steps, lo, hi, offset=3)
    torch.cuda.synchronize()
    assert sk.launches == 1
    assert torch.equal(got, want)
    host = data.make_population_batch((steps + 3).cpu().numpy(), streams)
    np.testing.assert_array_equal(got[..., :-1].cpu().numpy(), host["tokens"])


@pytest.mark.cuda
@pytest.mark.parametrize("per_trial_batch", [True, False], ids=["per-trial", "shared-stream"])
def test_graph_chunk_matches_eager_loop_bitwise(cuda, per_trial_batch):
    """Two replays of a captured chunk of 4 (steps 0-3, 4-7) against eight
    eager per-step calls on host batches, at the smoke config: every state
    leaf and every per-step loss equal bit for bit; the lane with budget 5
    stops at step 5; a later flight writes its initial state into the
    captured one (``flight_lease``) and replays without capturing again."""
    tc = _tc()
    data = _data(tc, seq=64, batch=2)
    k = 4
    streams = [0, 5, -1, 7]
    hp = _hp(tc, [1e-3, 3e-3, 2e-3, 5e-3], [8, 5, 8, 8])
    hp = type(hp)(**{f: getattr(hp, f).to(cuda) for f in vars(hp)})
    init = interop.tree_map(lambda t: t.to(cuda), _state(tc, k))
    step = P.make_population_train_step(tc, per_trial_batch=per_trial_batch)
    want, want_loss = _clone(init), []
    for s in range(8):
        b = data.make_population_batch(s, streams) if per_trial_batch else data.make_batch(s)
        want, m = step(want, dp.to_device(b, cuda), hp)
        want_loss.append(m["loss"].clone())
    P.clear_population_cache()
    scan = P.get_compiled_population_scan_step(tc, k, data, 4, per_trial_batch=per_trial_batch)
    if per_trial_batch:
        lo, hi = (w.to(cuda) for w in _words(streams))
    else:
        lo, hi = (torch.tensor(w, dtype=torch.int64, device=cuda) for w in split_stream(0))
    shape = (k,) if per_trial_batch else ()
    for run in range(2):
        if run == 0:
            got = _clone(init)
        else:
            with P.flight_lease(tc, k, data, per_trial_batch, cuda) as got:
                interop.tree_map(lambda dst, x: dst.copy_(x), got, init)
        losses = []
        for s in (0, 4):
            got, m = scan(got, hp, torch.full(shape, s, dtype=torch.int64, device=cuda), lo, hi)
            losses.append(m["loss"].clone())
        torch.cuda.synchronize()
        assert torch.equal(_raw(torch.cat(losses)), _raw(torch.stack(want_loss)))
        assert _bits_equal(got, want)
        assert got["inner"]["opt"]["step"].tolist() == [8, 5, 8, 8]
        assert [g["chunk"] for g in P.graph_stats()] == [4]
    P.clear_population_cache()


@pytest.mark.cuda
def test_overlapping_chunked_flights_take_turns_on_the_captured_state(cuda):
    """Two chunked flights of one geometry started together from two threads
    (as the vectorized resource manager may start two batches): the second
    waits for the first's lease on the captured state, and each gives the
    scores of its own per-step flight bit for bit.  The rung rule's
    boundaries (1 and 3 of 9 steps) make chunks of 1, 2, 4 and 2 steps."""
    from repro_torch.core.proposer.early_stop import InFlightSuccessiveHalving

    P.clear_population_cache()
    batches = [[dict(learning_rate=lr, stream=i) for i, lr in enumerate(lrs)]
               for lrs in ((1e-3, 3e-3, 2e-3), (5e-3, 4e-4, 2e-3, 1e-2))]

    def trial(chunk):
        t = hpo.PopulationTrial(ARCH, steps=9, batch=2, seq=64, seed=0, population=4,
                                chunk_steps=chunk, device=cuda)
        t.early_stop = InFlightSuccessiveHalving(eta=3, min_iter=1, max_iter=9)
        return t

    want = [trial(1).run_population(b) for b in batches]
    chunked = trial(4)
    got = [None, None]
    start = threading.Barrier(2)

    def fly(i):
        start.wait()
        got[i] = chunked.run_population(batches[i])

    threads = [threading.Thread(target=fly, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert got == want
    assert chunked.n_dispatches == 2 * 4 and chunked.n_train_steps == 2 * 9
    assert sorted(g["chunk"] for g in P.graph_stats()) == [1, 2, 4]
    P.clear_population_cache()


class _DumpedGraph:
    """Stands in for a captured graph in debug mode: ``debug_dump`` writes
    the DOT text ``cudaGraphDebugDotPrint`` gives (two kernel nodes, a memset
    and their edges)."""

    DOT = ('digraph dot {\nsubgraph cluster_1 {\nlabel="graph_1" graph[style="dashed"];\n'
           '"graph_1_node_0"[style="bold" shape="record" label="{KERNEL\n| {ID | 0 (topoId: 2)'
           ' | _Z14rmsnorm_kernelIffLi2EEvPKT_\\<\\<\\<\\{4,2\\},512,1024\\>\\>\\>}\n'
           '| {cooperative | 0}\n}"];\n\n'
           '"graph_1_node_1"[style="solid" shape="record" label="{MEMSET\n| {ID | 1}\n}"];\n\n'
           '"graph_1_node_2"[style="bold" shape="record" label="{KERNEL\n| {ID | 2 (topoId: 0)'
           ' | _Z18rmsnorm_bwd_kernelIfEvPKT_\\<\\<\\<32,128,0\\>\\>\\>}\n}"];\n\n'
           '"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];\n'
           '"graph_1_node_1" -> "graph_1_node_2" [headlabel=0];\n}\n}\n')

    def debug_dump(self, path):
        with open(path, "w") as f:
            f.write(self.DOT)


def test_graph_nodes_are_read_one_per_declaration():
    """``population._dot_nodes`` keeps one entry a node declaration (not the
    edges' lines), each naming its kernel once, so ``chip_smoke.py`` can
    count a replayed chunk's launches in its graph."""
    nodes = P._dot_nodes(_DumpedGraph())
    assert len(nodes) == 3
    assert [("rmsnorm_kernel" in n, "rmsnorm_bwd_kernel" in n) for n in nodes] == [
        (True, False), (False, False), (False, True)]
    assert all(n.count("graph_1_node_") == 1 for n in nodes)
