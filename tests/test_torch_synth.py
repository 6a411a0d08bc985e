"""The token synthesis kernel's algorithm, on the CPU and on the card.

``csrc/synth_tokens.cu`` splits each row into independent chains of the
bigram rule, walks them one a thread, and takes the remainder by the
vocabulary through a reciprocal.  Its plain helpers in
``repro_torch.kernels.synth`` carry that algorithm to the CPU:
``synth_tokens_chains`` (the chains walked in any order, the kernel's step
written out in Python ints) against ``synth_tokens_device`` and JAX's
``synth_population_batch(xp=jnp)``, bit for bit; ``vocab_reciprocal`` /
``mod_vocab`` against ``%``; ``chain_starts`` / ``chain_rule_steps``, the
split and the latency bound ``chip_smoke.py`` reckons from them.  On an
NVIDIA GPU (marker ``cuda``): the kernel against its plain version, bit for
bit.  JAX is imported inside the test that compares with it:
``python -m pytest tests/test_torch_synth.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticLM, split_streams
from repro_torch.kernels import build
from repro_torch.kernels import synth as sk

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

U32 = st.integers(min_value=0, max_value=0xFFFFFFFF)


def _words(streams):
    lo, hi = split_streams(streams)
    return lo.astype(np.int64), hi.astype(np.int64)


def _plain(data, steps, lo, hi, offset=0):
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64))  # noqa: E731
    return sk.synth_tokens_plain(data, t(steps), t(lo), t(hi), offset=offset).numpy()


# ------------------------------------------------------------ the chain walk
@settings(max_examples=20, deadline=None)
@given(mix=st.sampled_from([0.0, 0.85, 1.0]), seq=st.integers(1, 3000),
       k=st.integers(1, 3), rows=st.integers(1, 3),
       cursors=st.lists(st.integers(0, (1 << 40) - 1), min_size=3, max_size=3),
       streams=st.lists(st.integers(-(1 << 40), 1 << 40), min_size=3, max_size=3),
       tile=st.sampled_from([sk.TILE, None, 7, 64]), order_seed=U32)
def test_chains_in_any_order_match_device_synthesis_and_jax(mix, seq, k, rows, cursors,
                                                            streams, tile, order_seed):
    """The kernel's algorithm (chains walked in a random order, tile by tile;
    wide cursors and stream ids) equals the plain device synthesis and JAX's
    ``synth_population_batch`` traced with ``xp=jnp``, bit for bit."""
    import jax.numpy as jnp

    from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
    from repro.data.pipeline import synth_population_batch

    data = SyntheticLM(49152, seq, rows, seed=3, order_mix=mix)
    lo, hi = _words(streams[:k])
    steps = np.asarray(cursors[:k], dtype=np.int64)
    rng = np.random.default_rng(order_seed)
    got = sk.synth_tokens_chains(data, steps, lo, hi, offset=2, tile=tile,
                                 order=lambda s: [s[i] for i in rng.permutation(len(s))])
    np.testing.assert_array_equal(got, _plain(data, steps, lo, hi, offset=2))
    words = ((steps + 2) & 0xFFFFFFFF).astype(np.uint32)    # a cursor's hash word
    jdata = JaxSyntheticLM(49152, seq, rows, seed=3, order_mix=mix)
    want = synth_population_batch(jdata, lo.astype(np.uint32), hi.astype(np.uint32),
                                  jnp.asarray(words), xp=jnp)
    np.testing.assert_array_equal(got[..., :-1], np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got[..., 1:], np.asarray(want["targets"]))


@pytest.mark.parametrize("mix", [0.0, 0.5, 0.85, 1.0])
@pytest.mark.parametrize("tile", [sk.TILE, None, 5])
def test_chain_split_covers_every_rule_position_once(mix, tile):
    """Every rule position belongs to exactly one chain: the chains' rule
    steps sum to the rule positions of the row; a start is a rule position
    whose two predecessors are fixed or lie in an earlier tile; order_mix 0
    has no chain, order_mix 1 one chain a tile."""
    seq = 3000
    data = SyntheticLM(1000, seq, 3, seed=1, order_mix=mix)
    lo, hi = _words([0, 5, -2])
    rule = sk.rule_positions(data, np.asarray([0, 1, 1 << 35]), lo, hi)
    assert not rule[..., :2].any()
    steps = sk.chain_rule_steps(rule, tile)
    starts = sk.chain_starts(rule, tile)
    np.testing.assert_array_equal(steps.sum(-1), rule.sum(-1))
    assert ((steps > 0) == starts).all()
    n_tiles = -(-(seq + 1) // (tile or seq + 1))
    if mix == 0.0:
        assert not starts.any()
    if mix == 1.0:
        assert (starts.sum(-1) == n_tiles).all()
        size = tile or seq + 1       # every position from 2 on a tile, one chain
        assert steps.max() == max(min(t0 + size, seq + 1) - max(t0, 2)
                                  for t0 in range(0, seq + 1, size))
    t = np.arange(seq + 1)
    first = (t // tile) * tile if tile else np.zeros_like(t)
    r = rule[0, 0]
    for i in np.flatnonzero(starts[0, 0]):
        assert r[i]
        for j in (i - 1, i - 2):
            assert j < first[i] or not r[j]


def test_the_main_batch_splits_into_chains_far_shorter_than_the_row():
    """At the starcoder2 path's batch (K 4, batch 4, seq 1024, seed 0, cursor
    0) a row has 13 to 28 chains and the longest holds 279 dependent rule
    steps, against up to 889 rule positions on a row; at K 2, batch 2 the
    longest holds 144.  ``chip_smoke.py`` reckons the kernel's bound from
    these."""
    for k, rows, longest, chains in ((4, 4, 279, (13, 28)), (2, 2, 144, None)):
        data = SyntheticLM(49152, 1024, rows, seed=0)
        lo, hi = _words(list(range(k)))
        rule = sk.rule_positions(data, np.zeros(k, dtype=np.int64), lo, hi)
        steps = sk.chain_rule_steps(rule)
        assert steps.max() == longest
        assert rule.sum(-1).max() > 3 * longest
        if chains:
            n = (steps > 0).sum(-1)
            assert (n.min(), n.max()) == chains


# --------------------------------------------------------- the reciprocal
def _config_vocabs():
    return sorted({int(get(a).vocab_size) for a in ARCH_IDS
                   for get in (get_config, get_smoke_config)})


@pytest.mark.parametrize("vocab", _config_vocabs())
def test_reciprocal_remainder_is_exact_for_every_config_vocab(vocab):
    """``mod_vocab`` with ``vocab_reciprocal`` equals ``%`` for the vocabulary
    of every config under ``configs/`` (full and smoke) on the edge words (0,
    1, vocab - 1, vocab, vocab + 1, multiples, 2^31, 2^32 - 1) and 100,000
    random ones."""
    recip = sk.vocab_reciprocal(vocab)
    edges = [0, 1, vocab - 1, vocab, vocab + 1, 2 * vocab - 1, 2 * vocab,
             (0xFFFFFFFF // vocab) * vocab, (0xFFFFFFFF // vocab) * vocab - 1,
             1 << 31, 0xFFFFFFFE, 0xFFFFFFFF]
    x = np.concatenate([np.asarray([e for e in edges if 0 <= e <= 0xFFFFFFFF], np.uint64),
                        np.random.default_rng(vocab).integers(0, 1 << 32, 100_000,
                                                              dtype=np.uint64)])
    np.testing.assert_array_equal(sk.mod_vocab(x, vocab, recip), (x % vocab).astype(np.uint32))
    for e in edges:
        assert sk.mod_vocab(e, vocab, recip) == e % vocab


@settings(max_examples=300, deadline=None)
@given(vocab=st.integers(1, (1 << 31) - 1), x=U32)
def test_reciprocal_remainder_is_exact_for_any_vocab(vocab, x):
    recip = sk.vocab_reciprocal(vocab)
    for w in (x, vocab - 1, vocab, min(vocab + 1, 0xFFFFFFFF), 0xFFFFFFFF, 0):
        assert sk.mod_vocab(w, vocab, recip) == w % vocab


@pytest.mark.parametrize("vocab", [0, -5, 1 << 31])
def test_reciprocal_refuses_a_vocab_out_of_range(vocab):
    with pytest.raises(ValueError, match="vocab"):
        sk.vocab_reciprocal(vocab)


def test_kernel_source_states_its_bound_and_tile():
    text = (build.CSRC / "synth_tokens.cu").read_text()
    assert "Bound on this card" in text and "chain" in text
    assert f"TILE = {sk.TILE}" in text
    assert build.SIGNATURES["synth_tokens_fwd"][10] is build._U   # the reciprocal


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,rows,seq,mix", [
    (4, 4, 1024, 0.85),     # the starcoder2 path's batch: (4, 4, 1025)
    (2, 3, 5000, 0.85),     # rows of three tiles
    (2, 2, 4100, 1.0),      # one chain a tile, carried across tiles
    (4, 4, 1024, 0.0),      # no chain: every token a draw
    (3, 2, 2047, 0.5),      # a tile and one position, many short chains
])
def test_synth_kernel_matches_plain_bitwise_by_order_mix(cuda, k, rows, seq, mix):
    data = SyntheticLM(49152, seq, rows, seed=11, order_mix=mix)
    lo, hi = (torch.from_numpy(w).to(cuda) for w in _words([0, 12345, -1, -3][:k]))
    steps = torch.arange(k, dtype=torch.int64, device=cuda) * 7 + (1 << 33)
    before = sk.launches
    got = sk.synth_tokens_cuda(data, steps, lo, hi, offset=3)
    want = sk.synth_tokens_plain(data, steps, lo, hi, offset=3)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_synth_launcher_refuses_a_wrong_reciprocal(cuda):
    z = torch.zeros(1, dtype=torch.int64, device=cuda)
    out = torch.empty((1, 1, 9), dtype=torch.int32, device=cuda)
    err = build.library().synth_tokens_fwd(
        z.data_ptr(), z.data_ptr(), z.data_ptr(), out.data_ptr(), 1, 1, 9, 0, 0, 1000,
        sk.vocab_reciprocal(1000) + 1, 0.85, 0, torch.cuda.current_stream().cuda_stream)
    assert err != 0
