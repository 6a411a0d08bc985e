"""The port's streaming engines against the JAX package and against themselves.

On the CPU: the lane ops (init, clone, splice) against JAX's
``make_lane_init`` / ``make_lane_clone`` / ``make_lane_splice`` fed the same
state through ``repro_torch.interop``; the device-side rule updates against
JAX's and against the host rules on seeded random cases; the rule-carrying
chunk against JAX's ``make_population_rule_scan_step`` within 1e-4; inside
the port, a refilled lane against a fresh flight, streaming chunked against
per-step, device rules against host rules, streaming PBT against the serial
PBT driver, a flight killed by an injected fault against an unbroken one;
and the CLI with ``--lane-refill``, ``--pbt-streaming`` and
``--device-rules`` against the JAX CLI within 1e-4.  On an NVIDIA GPU
(marker ``cuda``): lane ops on the leased captured state, a clone chain
against the CPU's, and a replayed rule chunk against its eager loop.

JAX is imported inside the tests that compare with it, so the card-only
cases also run where JAX is not installed:
``python -m pytest tests/test_torch_streaming.py -m cuda``.
"""
import json
import math
import warnings

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import faultinject
from repro_torch.core.experiment import Experiment
from repro_torch.core.job import Job, JobStatus
from repro_torch.core.proposer import make_proposer
from repro_torch.core.proposer import pbt as pbt_mod
from repro_torch.core.proposer.early_stop import InFlightSuccessiveHalving
from repro_torch.core.resource.vectorized import QueueFeedScheduler, VectorizedResourceManager
from repro_torch.core.search_space import SearchSpace
from repro_torch.data.pipeline import SyntheticLM, split_streams
from repro_torch.launch import hpo
from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
from repro_torch.train import population as P
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

ARCH = "starcoder2-3b"
SEQ, BATCH = 16, 2


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    return jax, jnp


def _tc():
    return TrainConfig(model=get_smoke_config(ARCH), parallel=ParallelConfig(remat="none"),
                       total_steps=8)


def _jtc():
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import ParallelConfig as JaxParallelConfig
    from repro.configs.base import TrainConfig as JaxTrainConfig

    return JaxTrainConfig(model=jax_smoke_config(ARCH),
                          parallel=JaxParallelConfig(remat="none"), total_steps=8)


_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _raw(t):
    t = t.detach()
    return t.to(torch.uint8) if t.dtype == torch.bool else t.view(_INT_OF_SIZE[t.element_size()])


def _bits_equal(a, b):
    return all(torch.equal(_raw(x), _raw(y))
               for x, y in zip(interop.tree_leaves(a), interop.tree_leaves(b)))


def _clone(tree):
    return interop.tree_map(lambda t: t.clone(), tree)


def _np_leaves(tree):
    return [np.asarray(x, np.float64) if np.asarray(x).dtype.kind == "f" else np.asarray(x)
            for x in interop.tree_leaves(interop.to_numpy(tree))]


def _jax_leaves(jax, tree):
    return [np.asarray(x, np.float64) if np.asarray(x).dtype.kind == "f" else np.asarray(x)
            for x in jax.tree.leaves(jax.device_get(tree))]


# ------------------------------------------------------------- lane ops vs JAX
def _jax_population(jax, jnp, k=4):
    """A JAX population of K distinct lanes (per-lane init keys), with a
    divergence latch and last losses that differ by lane; the port's copy."""
    from repro.train import population as JP

    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), i) for i in range(k)])
    jp = JP.init_population_state_from_keys(keys, _jtc())
    jp = dict(jp, diverged=jnp.asarray([False, True, False, True][:k]),
              last_loss=jnp.asarray([1.5, 2.5, 3.5, 4.5][:k], jnp.float32))
    return jp, interop.to_torch(jax.device_get(jp))


@pytest.mark.parametrize("mask,donors", [
    ([True, True, False, False], [1, 2, 2, 3]),      # a chain: 0 <- 1, 1 <- 2
    ([False, False, True, False], [0, 1, 2, 3]),     # a self-clone
    ([False, False, False, False], [3, 2, 1, 0]),    # nothing masked: identity
], ids=["chain", "self", "unmasked"])
def test_lane_clone_matches_jax_bitwise(mask, donors):
    """Clone in place, leaf by leaf, against JAX's functional clone: every
    leaf equal bit for bit, the chain's targets reading the pre-op donors."""
    jax, jnp = _jax()
    from repro.train import population as JP

    jp, tp = _jax_population(jax, jnp)
    before = _clone(tp)
    want = JP.make_lane_clone(_jtc())(jp, jnp.asarray(mask), jnp.asarray(donors, jnp.int32))
    got = P.get_lane_op(_tc(), 4, "clone")(tp, np.asarray(mask), np.asarray(donors))
    assert got is tp
    for g, w in zip(_np_leaves(got), _jax_leaves(jax, want)):
        np.testing.assert_array_equal(g, w)
    if not any(mask):
        assert _bits_equal(got, before)


def _patch_init_params(monkeypatch, jax, keys):
    """``train_step.init_params(g, ...)`` gives the JAX init parameters of
    ``keys[g]``: the lane ops are fed lane indices as their generators."""
    from repro.train.train_step import init_train_state as jax_init_train_state

    jtc = _jtc()
    params = [jax.device_get(jax_init_train_state(kk, jtc)["params"]) for kk in keys]
    monkeypatch.setattr(ts, "init_params",
                        lambda g, tc, device: interop.to_torch(params[g], device))


@pytest.mark.parametrize("op", ["init", "splice"])
def test_lane_init_and_splice_match_jax(monkeypatch, op):
    """Re-init lanes 1 and 3 (init) or lane 2 (splice) with the JAX init of
    fresh keys: the re-initialised lanes equal JAX's result bit for bit
    (fresh parameters, zero moments and step, latch cleared, last_loss
    inf); every other lane keeps every leaf bit for bit."""
    jax, jnp = _jax()
    from repro.train import population as JP

    jp, tp = _jax_population(jax, jnp)
    fresh = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(9), i) for i in range(4)])
    _patch_init_params(monkeypatch, jax, list(fresh))
    before = _clone(tp)
    if op == "init":
        mask = np.asarray([False, True, False, True])
        want = JP.make_lane_init(_jtc())(jp, jnp.asarray(mask), fresh)
        got = P.get_lane_op(_tc(), 4, "init")(tp, mask, list(range(4)))
    else:
        mask = np.asarray([False, False, True, False])
        want = JP.make_lane_splice(_jtc())(jp, jnp.asarray(2, jnp.int32), fresh[2])
        got = P.get_lane_op(_tc(), 4, "splice")(tp, 2, 2)
    assert got is tp
    for g, w, b in zip(_np_leaves(got), _jax_leaves(jax, want), _np_leaves(before)):
        np.testing.assert_array_equal(g[mask], w[mask])
        np.testing.assert_array_equal(g[~mask], b[~mask])
    assert not got["diverged"][mask].any()
    assert torch.isinf(got["last_loss"][mask]).all()


def test_later_lane_ops_raise_naming_their_item():
    # snapshot and restore came with item 9 (tests/test_torch_crash_safety.py),
    # regrid with item 12(c) (tests/test_torch_elastic_regrid.py)
    assert callable(P.get_lane_op(_tc(), 4, "snapshot"))
    assert callable(P.get_lane_op(_tc(), 4, "restore"))
    assert callable(P.get_lane_op(_tc(), 4, "regrid"))
    with pytest.raises(KeyError):
        P.get_lane_op(_tc(), 4, "bogus")


# ------------------------------------------------------------- rule updates
def _rung_hook():
    return InFlightSuccessiveHalving(eta=2.0, min_iter=2, max_iter=8)


def test_cohort_rule_update_matches_jax_and_host_on_random_cases():
    """25 seeded cases (seed 7, as the JAX package's test): budgets equal to
    the host rule's and to JAX's in-scan rule's, exactly."""
    jax, jnp = _jax()
    from repro.train import population as JP

    rng = np.random.default_rng(7)
    k = 8
    for _ in range(25):
        hook = _rung_hook()
        step = int(rng.choice(hook.boundaries + [3]))   # off a boundary: no-op
        budgets = rng.choice([0.0, 2.0, 4.0, 8.0], k)
        losses = rng.choice([0.5, 0.625, 0.75, 0.75, 1.0, np.inf], k)
        diverged = rng.random(k) < 0.25
        want = hook(step, losses, budgets, diverged)
        args = (budgets, np.zeros(k), np.zeros(k), hook.boundaries, hook.eta)
        got = P.cohort_rule_update(P.cohort_rule_state(*args), torch.tensor(losses).float(),
                                   torch.tensor(diverged), torch.full((k,), step,
                                                                      dtype=torch.int32))
        jgot = JP.cohort_rule_update(JP.cohort_rule_state(*args),
                                     jnp.asarray(losses, jnp.float32), jnp.asarray(diverged),
                                     jnp.full((k,), step, jnp.int32))
        np.testing.assert_array_equal(got["budgets"].numpy().astype(np.float64), want)
        np.testing.assert_array_equal(got["budgets"].numpy(), np.asarray(jgot["budgets"]))


def test_staggered_rule_update_matches_jax_and_host_on_random_cases():
    """25 seeded cases (seed 11) on one tape: budgets, history and counts
    equal to JAX's in-scan rule's after every case, and the histories and
    cuts equal to the host rule's (simultaneous boundary hits included)."""
    jax, jnp = _jax()
    from repro.train import population as JP

    rng = np.random.default_rng(11)
    k = 8
    host, dev = _rung_hook(), _rung_hook()
    spec = dev.device_rule()
    for _ in range(25):
        budgets = rng.choice([0.0, 2.0, 4.0, 8.0], k)
        local = np.array([rng.integers(0, int(b) + 1) for b in budgets])
        losses = rng.choice([0.5, 0.625, 0.75, 0.75, 1.0, np.inf], k)
        diverged = rng.random(k) < 0.25
        want = host.observe(local, losses, budgets, diverged)
        hist, counts = spec.lower_history(64)
        args = (budgets, np.zeros(k), np.zeros(k), spec.boundaries, spec.eta, hist, counts)
        got = P.staggered_rule_update(P.staggered_rule_state(*args),
                                      torch.tensor(losses).float(), torch.tensor(diverged),
                                      torch.tensor(local, dtype=torch.int32))
        jgot = JP.staggered_rule_update(JP.staggered_rule_state(*args),
                                        jnp.asarray(losses, jnp.float32),
                                        jnp.asarray(diverged), jnp.asarray(local, jnp.int32))
        for name in ("budgets", "hist", "counts"):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(jgot[name]), name)
        spec.absorb_history(got["hist"].numpy(), got["counts"].numpy())
        np.testing.assert_array_equal(got["budgets"].numpy().astype(np.float64), want)
    assert dev._rung_history == host._rung_history
    assert host.n_truncated > 0


def test_staggered_rule_capacity_padding_changes_no_output():
    """The same cases at history capacities 16, 32 and 128 (the streaming
    driver keeps the largest power of two it reached): budgets and counts
    equal, and the histories equal over the shortest capacity with the rest
    left +inf."""
    rng = np.random.default_rng(5)
    k = 8
    hooks = {cap: _rung_hook() for cap in (16, 32, 128)}
    for _ in range(10):
        budgets = rng.choice([0.0, 2.0, 4.0, 8.0], k)
        local = np.array([rng.integers(0, int(b) + 1) for b in budgets])
        losses = rng.choice([0.5, 0.625, 0.75, 1.0, np.inf], k)
        diverged = rng.random(k) < 0.25
        outs = {}
        for cap, hook in hooks.items():
            spec = hook.device_rule()
            hist, counts = spec.lower_history(cap)
            outs[cap] = P.staggered_rule_update(
                P.staggered_rule_state(budgets, np.zeros(k), np.zeros(k), spec.boundaries,
                                       spec.eta, hist, counts),
                torch.tensor(losses).float(), torch.tensor(diverged),
                torch.tensor(local, dtype=torch.int32))
            spec.absorb_history(outs[cap]["hist"].numpy(), outs[cap]["counts"].numpy())
        small = outs[16]
        for cap, got in outs.items():
            assert torch.equal(got["budgets"], small["budgets"])
            assert torch.equal(got["counts"], small["counts"])
            assert torch.equal(got["hist"][:, :16], small["hist"])
            assert torch.isinf(got["hist"][:, 16:]).all()


def test_window_quantile_twin_matches_numpy():
    """The tensor ``window_quantile`` against the copied numpy one (and the
    sorted window) on 25 seeded rings (seed 3)."""
    rng = np.random.default_rng(3)
    for _ in range(25):
        w = int(rng.integers(4, 17))
        n = int(rng.integers(1, 2 * w + 1))
        q = float(rng.choice([0.25, 0.4, 0.5]))
        ring = rng.choice(np.arange(-8, 8, 0.25), w).astype(np.float32)
        want = pbt_mod.window_quantile(ring, np.int32(n), np.float32(q))
        got = P.window_quantile(torch.from_numpy(ring), torch.tensor(n, dtype=torch.int32),
                                torch.tensor(q))
        assert float(got[0]) == float(want[0]) and float(got[1]) == float(want[1])
        valid = sorted(float(x) for x in ring[:min(n, w)])
        kq = max(1, int(np.float32(q) * np.float32(min(n, w))))
        assert float(got[0]) == valid[kq - 1] and float(got[1]) == valid[-kq]


def test_pbt_rule_update_matches_jax_on_random_cases():
    """25 seeded cases (seed 13): window ring, count and the latched
    verdicts (vbottom, vready, vlo, vhi) equal to JAX's, exactly; a lane
    latches only at its round end."""
    jax, jnp = _jax()
    from repro.train import population as JP

    rng = np.random.default_rng(13)
    k, w = 6, 8
    for _ in range(25):
        budgets = rng.choice([0.0, 2.0, 3.0, 4.0], k)
        local = np.array([rng.integers(0, int(b) + 2) for b in budgets])
        losses = rng.choice([0.5, 0.625, 0.75, 0.75, 1.0, np.inf], k).astype(np.float32)
        diverged = rng.random(k) < 0.2
        wscore = rng.choice(np.arange(-4, 0, 0.125), w).astype(np.float32)
        wcount = int(rng.integers(0, 2 * w))
        q = float(rng.choice([0.25, 0.5]))
        args = (budgets, np.zeros(k), np.zeros(k), q, wscore, wcount)
        got = P.pbt_rule_update(P.pbt_rule_state(*args), torch.from_numpy(losses),
                                torch.tensor(diverged), torch.tensor(local, dtype=torch.int32))
        jgot = JP.pbt_rule_update(JP.pbt_rule_state(*args), jnp.asarray(losses),
                                  jnp.asarray(diverged), jnp.asarray(local, jnp.int32))
        for name in ("budgets", "wscore", "wcount", "vbottom", "vready", "vlo", "vhi"):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(jgot[name]), name)
        hit = (budgets > 0) & (local == budgets)
        np.testing.assert_array_equal(got["vready"].numpy(), hit)


# ------------------------------------------------------------- rule chunk vs JAX
_RULE_CASES = {
    # mode: (budgets, local0, extra rule-state arguments)
    "cohort": ([4, 4, 4, 2], [0, 0, 0, 0], dict(boundaries=[2], eta=2.0)),
    "staggered": ([4, 3, 4, 2], [0, 1, 0, 1], dict(boundaries=[2], eta=2.0)),
    "pbt": ([2, 3, 4, 4], [0, 0, 1, 0], dict(quantile=0.5)),
}


def _rule_state(mod, mode, base):
    budgets, local0, kw = _RULE_CASES[mode]
    k = len(budgets)
    if mode == "cohort":
        return mod.cohort_rule_state(budgets, base, local0, kw["boundaries"], kw["eta"])
    if mode == "staggered":
        hist = np.full((1, 8), np.inf, np.float32)
        return mod.staggered_rule_state(budgets, base, local0, kw["boundaries"], kw["eta"],
                                        hist, np.zeros(1, np.int32))
    return mod.pbt_rule_state(budgets, base, local0, kw["quantile"],
                              np.zeros(8, np.float32), 0)


@pytest.mark.parametrize("mode", ["cohort", "staggered", "pbt"])
def test_rule_chunk_matches_jax_rule_scan_step(mode):
    """A rule chunk of 4 steps against JAX's ``make_population_rule_scan_step``
    from the same JAX init: per-step losses, last_loss and parameters within
    1e-4, and so the losses the rule state keeps; the budgets log, the rest
    of the rule state, the step counters and latches equal exactly.  The cohort and staggered cases cut lanes at
    step 2."""
    jax, jnp = _jax()
    from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
    from repro.optim.hparams import hparams_from_dict as jax_hparams_from_dict
    from repro.optim.hparams import stack_hparams as jax_stack_hparams
    from repro.train import population as JP

    k, chunk = 4, 4
    jtc, tc = _jtc(), _tc()
    jdata = JaxSyntheticLM(tc.model.vocab_size, SEQ, BATCH, seed=0)
    data = SyntheticLM(tc.model.vocab_size, SEQ, BATCH, seed=0)
    cfgs = [dict(learning_rate=lr, total_steps=8, warmup_frac=0.25)
            for lr in (1e-3, 3e-3, 2e-3, 5e-3)]
    jhp = jax_stack_hparams([jax_hparams_from_dict(c, jtc) for c in cfgs])
    hp = stack_hparams([hparams_from_dict(c, tc) for c in cfgs])
    keys = jax.random.split(jax.random.PRNGKey(0), k)
    jp = JP.init_population_state_from_keys(keys, jtc)
    tp = interop.to_torch(jax.device_get(jp))
    streams = [0, 5, 2, 7]
    base = np.zeros(k)
    jlo, jhi = (jnp.asarray(w) for w in split_streams(streams))
    lo, hi = (torch.from_numpy(w.astype(np.int64)) for w in split_streams(streams))
    local0 = np.asarray(_RULE_CASES[mode][1])
    jscan = jax.jit(JP.make_population_rule_scan_step(jtc, jdata, chunk, mode))
    (jp, jrules), jm = jscan(jp, jhp, jnp.asarray(local0, jnp.int32), jlo, jhi,
                             _rule_state(JP, mode, base))
    prog = P.get_compiled_population_rule_scan_step(tc, k, data, chunk, mode)
    (tp, rules), m = prog(tp, hp, torch.from_numpy(local0.astype(np.int64)), lo, hi,
                          _rule_state(P, mode, base))
    np.testing.assert_array_equal(m["budgets"].numpy(), np.asarray(jm["budgets"]))
    for name in jrules:
        if name in ("hist", "wscore", "vlo", "vhi"):   # losses the rule kept
            np.testing.assert_allclose(rules[name].numpy(), np.asarray(jrules[name]),
                                       atol=1e-4, rtol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(rules[name].numpy(), np.asarray(jrules[name]), name)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tp["last_loss"].numpy(), np.asarray(jp["last_loss"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tp["inner"]["opt"]["step"].numpy(),
                                  np.asarray(jp["inner"]["opt"]["step"]))
    np.testing.assert_array_equal(tp["diverged"].numpy(), np.asarray(jp["diverged"]))
    for g, w in zip(interop.tree_leaves(interop.to_numpy(tp["inner"]["params"])),
                    jax.tree.leaves(jp["inner"]["params"])):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4)
    if mode != "pbt":
        assert (m["budgets"][-1] < torch.tensor(_RULE_CASES[mode][0]).float()).any()


# ------------------------------------------------------------- inside the port
def _trial(chunk=1, device_rules=False, hook=None, population=4, steps=2, **kw):
    return hpo.PopulationTrial(ARCH, steps=steps, batch=BATCH, seq=SEQ, seed=0,
                               population=population, early_stop=hook,
                               refill_idle_grace_s=0.0, chunk_steps=chunk,
                               device_rules=device_rules, device="cpu", **kw)


def _stream(trial, cfgs):
    feed = QueueFeedScheduler(cfgs)
    assert trial.run_population([], scheduler=feed) == []
    n = len(cfgs)
    assert len(feed.scores) == n, "every queued config must stream a result"
    return {"scores": feed.ordered_scores(n), "extras": [feed.extras[i] for i in range(n)],
            "order": list(feed.scores), "dispatches": trial.n_dispatches,
            "train_steps": trial.n_train_steps,
            "truncated": trial.early_stop.n_truncated if trial.early_stop else None}


def test_refilled_lane_matches_fresh_flight_and_serial():
    """A config spliced into a used lane mid-flight scores bit for bit what it
    scores as the first lane of a fresh batch flight (same stream, same init
    generator), and the serial driver's score at rtol 1e-5 / atol 1e-6."""
    cfgs = [{"learning_rate": 1e-3, "stream": 0, "n_iterations": 2},
            {"learning_rate": 2e-3, "stream": 1, "n_iterations": 4},
            {"learning_rate": 3e-3, "stream": 2, "n_iterations": 2}]
    trial = _trial(population=2, steps=1, per_trial_init=True)
    got = _stream(trial, cfgs)
    assert trial.n_refills >= 1, "config 2 must have refilled a freed lane"
    assert trial.n_splices >= 1
    assert trial.run_population([cfgs[2]])[0] == got["scores"][2]
    np.testing.assert_allclose(got["scores"][2], trial(dict(cfgs[2])), rtol=1e-5, atol=1e-6)
    assert [e["steps"] for e in got["extras"]] == [2, 4, 2]


def _ladder(n=6):
    """Geometric learning rates with budgets cycling 1, 2, 4 units (2, 4 and
    8 steps), on 4 lanes: lanes retire at different steps, refill, and the
    rung boundaries 2 and 4 cut some of them."""
    lrs = np.geomspace(3e-4, 4e-3, n)
    return [{"learning_rate": float(lr), "stream": i, "n_iterations": [1, 2, 4][i % 3]}
            for i, lr in enumerate(lrs)]


def test_streaming_chunked_equals_per_step_bitwise():
    """The refill ladder at ``--chunk-steps 4`` and ``1`` (host rules): the
    same scores, steps, cuts and streamed order bit for bit, with fewer
    dispatches chunked."""
    per_step = _stream(_trial(1, hook=_rung_hook()), _ladder())
    chunked = _stream(_trial(4, hook=_rung_hook()), _ladder())
    for key in ("scores", "extras", "order", "train_steps", "truncated"):
        assert chunked[key] == per_step[key], key
    assert chunked["dispatches"] < per_step["dispatches"]
    assert per_step["truncated"] >= 1
    assert any(e["lane"] == per_step["extras"][0]["lane"] for e in per_step["extras"][4:])


def _waves():
    """Two waves of 4 on 4 lanes: 4 trials of 2 steps (they end together and
    every lane refills), then 4 of 4 steps that meet the rung boundary 3
    together with nothing left to lease, so host and device rules see the
    same history in the same order.  The second wave's first lane has the
    largest learning rate, so the rule cuts the rest."""
    lrs = [3e-3, 2e-3, 1e-3, 5e-4]
    return ([{"learning_rate": lr, "stream": i, "n_iterations": 1} for i, lr in enumerate(lrs)]
            + [{"learning_rate": lr * 3, "stream": 4 + i, "n_iterations": 2}
               for i, lr in enumerate(lrs)])


def _wave_hook():
    return InFlightSuccessiveHalving(eta=4.0, min_iter=3, max_iter=4)


def test_device_rules_equal_host_rules_bitwise():
    """The two-wave workload with the rung rule on the host (per-step and
    chunked) and in the chunks (``device_rules``): the same scores, steps,
    cuts and streamed order bit for bit, with fewer dispatches under device
    rules."""
    host = _stream(_trial(1, hook=_wave_hook()), _waves())
    chunked = _stream(_trial(4, hook=_wave_hook()), _waves())
    device = _stream(_trial(4, True, hook=_wave_hook()), _waves())
    for got in (chunked, device):
        for key in ("scores", "extras", "order", "train_steps", "truncated"):
            assert got[key] == host[key], key
    assert host["truncated"] >= 1
    assert device["dispatches"] < chunked["dispatches"] < host["dispatches"]


def test_device_rule_ladder_fitting_one_chunk_is_one_dispatch():
    """Four trials of 2, 4, 8 and 2 steps, rung boundaries 2 and 4, chunks of
    up to 8: under device rules the whole ladder is one dispatch (the first
    fill is not one) and equals the host-rule flight bit for bit."""
    cfgs = _ladder(4)
    trial = _trial(8, True, hook=_rung_hook())
    got = _stream(trial, cfgs)
    assert trial.ladder_dispatches == 1 and got["dispatches"] == 1
    host = _stream(_trial(8, hook=_rung_hook()), cfgs)
    assert host["dispatches"] > 1
    for key in ("scores", "extras", "truncated"):
        assert got[key] == host[key], key


@pytest.mark.parametrize("device_rules", [False, True], ids=["host-rules", "device-rules"])
def test_zero_budget_lease_completes_without_training(device_rules):
    """A lease of 0 steps retires on the spot (0 steps, not diverged) beside
    a lane that trains its 2 steps; no dispatch is spent on it."""
    cfgs = [{"learning_rate": 1e-3, "stream": 0, "n_iterations": 0},
            {"learning_rate": 2e-3, "stream": 1, "n_iterations": 2}]
    trial = _trial(8, device_rules, hook=_rung_hook(), population=2, steps=1)
    got = _stream(trial, cfgs)
    assert [e["steps"] for e in got["extras"]] == [0, 2]
    assert got["extras"][1]["diverged"] is False
    assert trial.n_train_steps == 2


PBT_SPACE = [
    {"name": "learning_rate", "type": "float", "range": [1e-4, 3e-3], "scale": "log"},
    {"name": "weight_decay", "type": "float", "range": [0.0, 0.2]},
]


def _pbt_proposer(k=4, rounds=3, seed=7):
    return make_proposer("pbt", SearchSpace.from_json(PBT_SPACE), maximize=True, seed=seed,
                         population=k, n_generations=rounds, streaming=True, quantile=0.25)


def _pbt_stream(trial, k=4, rounds=3, seed=7):
    exp = Experiment({"proposer": "pbt", "parameter_config": PBT_SPACE,
                      "n_samples": k * rounds, "n_parallel": k, "target": "max",
                      "seed": seed, "population": k, "n_generations": rounds,
                      "streaming": True, "quantile": 0.25, "resource": "vectorized",
                      "lane_refill": True}, trial)
    got = {}
    exp.add_result_callback(lambda job: got.__setitem__(
        (job.config.get("pbt_member"), job.config.get("pbt_round")),
        job.result.score if job.result else None))
    exp.run()
    return exp, got


@pytest.mark.parametrize("chunk", [1, 4], ids=["per-step", "chunked"])
def test_streaming_pbt_matches_serial_pbt_driver(chunk):
    """Streaming PBT (sync rounds) against the port's generation-barriered
    serial driver, per (member, round) at rtol 1e-5 / atol 1e-6; at least
    one clone ran on the device and no train state went through the host."""
    k, rounds, steps = 4, 3, 3
    serial_trial = hpo.PopulationTrial(ARCH, steps=steps, batch=BATCH, seq=SEQ, seed=0,
                                       per_trial_init=True, device="cpu")
    serial = hpo.run_pbt_serial(serial_trial, _pbt_proposer(k, rounds))
    assert serial_trial.n_host_ckpt_roundtrips > 0
    trial = _trial(chunk, population=k, steps=steps, per_trial_init=True)
    exp, got = _pbt_stream(trial, k, rounds)
    assert set(got) == set(serial)
    np.testing.assert_allclose([got[key] for key in sorted(serial)],
                               [serial[key] for key in sorted(serial)], rtol=1e-5, atol=1e-6)
    assert trial.lifecycle is exp.proposer.lifecycle_hook()
    assert trial.n_clones >= 1
    assert trial.n_host_ckpt_roundtrips == 0 and trial.n_lineage_resets == 0
    assert exp.rm.n_streamed == k * rounds


def _supervised_pair(fault):
    """Two jobs on a 2-lane supervised streaming flight; ``{stream: (status,
    score)}`` and the manager."""
    faultinject.disarm()
    if fault:
        faultinject.arm(fault)
    try:
        trial = _trial(1, population=2, steps=6)
        trial.refill_idle_grace_s = 0.1
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
    return {j.config["stream"]: (j.status, j.result.score if j.result else None)
            for j in jobs}, rm


def test_injected_flight_death_restarts_and_every_job_completes():
    """``raise@step=3`` kills the flight once: the supervisor restarts it,
    the reclaimed jobs train again from their step 0, and both finish with
    the unbroken flight's scores bit for bit."""
    base, rm0 = _supervised_pair(None)
    assert rm0.n_flight_deaths == 0
    faulted, rm = _supervised_pair("raise@step=3,times=1")
    assert rm.n_flight_deaths == 1 and rm.n_flight_restarts == 1
    assert all(st == JobStatus.FINISHED for st, _ in faulted.values())
    assert faulted == base


def test_nan_poison_retires_the_lane_with_the_sentinel():
    base, _ = _supervised_pair(None)
    poisoned, rm = _supervised_pair("nan@lane=0,step=2")
    assert rm.n_flight_deaths == 0
    assert poisoned[100] == (JobStatus.FINISHED, hpo.PopulationTrial.DIVERGED_SCORE)
    assert poisoned[101] == base[101]


def test_streaming_needs_per_trial_streams_and_an_empty_batch():
    with pytest.raises(ValueError, match="per-trial data streams"):
        _trial(per_trial_streams=False).run_population([], scheduler=QueueFeedScheduler([]))
    with pytest.raises(ValueError, match="streaming mode"):
        _trial().run_population([{"learning_rate": 1e-3}], scheduler=QueueFeedScheduler([]))


def test_active_lane_share_rises_with_refill():
    """The two-wave workload as batch flights under the rung rule and as one
    streaming flight: the share of computed lane-steps that trained an
    active lane is higher streaming, and at most 1."""
    batch = _trial(4, hook=_wave_hook())
    cfgs = _waves()
    batch.run_population(cfgs[:4])
    batch.run_population(cfgs[4:])
    stream = _trial(4, hook=_wave_hook())
    _stream(stream, cfgs)
    assert 0 < batch.active_lane_share < stream.active_lane_share <= 1


def test_active_lane_share_leaves_out_the_diverging_step():
    """A lane whose learning rate is NaN applies its first step, then gives a
    non-finite loss: that step is computed and active but not applied, so
    the share counts 1 + 3 of the 2 x 3 lane-steps."""
    trial = _trial(population=2, steps=3)
    scores = trial.run_population([{"learning_rate": float("nan"), "stream": 0},
                                   {"learning_rate": 1e-3, "stream": 1}])
    assert scores[0] == hpo.PopulationTrial.DIVERGED_SCORE and math.isfinite(scores[1])
    assert (trial.n_active_lane_steps, trial.n_lane_steps) == (4, 6)


# ------------------------------------------------------------- CLI
BASE = ["--n-samples", "4", "--steps", "3", "--batch", "2", "--seq", "16", "--vectorize", "4"]


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


@pytest.fixture
def jax_init(monkeypatch):
    """The port's trials start from the JAX init weights of the CLI's seed,
    through both init entry points (the two RNGs differ)."""
    jax, _ = _jax()
    from repro.train.train_step import init_train_state as jax_init_train_state

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import TrainConfig as JaxTrainConfig

    state = jax.device_get(jax_init_train_state(
        jax.random.PRNGKey(0), JaxTrainConfig(model=jax_smoke_config(ARCH))))
    monkeypatch.setattr(ts, "init_train_state",
                        lambda gen, tc, device: interop.to_torch(state, device))
    monkeypatch.setattr(ts, "init_params",
                        lambda gen, tc, device: interop.to_torch(state["params"], device))


# what each CLI case must report exactly as the JAX CLI does.  A streaming
# flight leases what the experiment loop has offered when it gets there, so
# dispatch and step counts are exact only where nothing is offered while
# lanes train: the ASHA cases (3 trials on 4 lanes, and the one promotion
# offered while the flight idles).  Streaming PBT's rounds may start
# apart, and with --pbt-async a decision reads the window as the loop has
# seen it; their scores and counts of device work are exact all the same.
_REFILL_KEYS = ("engine", "chunk_steps", "device_dispatches", "trained_steps",
                "ladder_device_dispatches", "lane_refills", "streamed_results",
                "refill_flights", "flight_deaths", "flight_restarts", "quarantined",
                "inflight_truncated_lanes", "device_rules")
_PBT_KEYS = ("engine", "streamed_results", "refill_flights", "flight_deaths",
             "pbt_splices", "pbt_host_ckpt_roundtrips", "pbt_device_verdicts", "device_rules")


@pytest.mark.parametrize("extra,keys", [
    (["--lane-refill", "--proposer", "asha", "--inflight-stop", "--n-samples", "3"],
     _REFILL_KEYS),
    (["--lane-refill", "--proposer", "asha", "--inflight-stop", "--n-samples", "3",
      "--chunk-steps", "4", "--device-rules"], _REFILL_KEYS),
    (["--pbt-streaming", "--proposer", "pbt", "--n-samples", "12"],
     _PBT_KEYS + ("pbt_clones", "pbt_keeps", "lane_refills")),
    (["--pbt-streaming", "--proposer", "pbt", "--pbt-async", "--device-rules",
      "--n-samples", "12"], _PBT_KEYS),
], ids=["refill-asha", "refill-asha-devrules", "pbt-streaming", "pbt-async-devrules"])
def test_streaming_cli_matches_jax_cli(jax_init, capsys, extra, keys):
    """The same flags through the JAX CLI and the port's (``--device cpu``):
    the same best config, best scores within 1e-4, every key of the JAX
    CLI's output, the same values of ``keys``, and the port's
    ``active_lane_share``."""
    from repro.launch import hpo as jax_hpo

    want = _run(jax_hpo.main, BASE + extra, capsys)
    got = _run(hpo.main, BASE + extra + ["--device", "cpu"], capsys)
    assert got["best_config"] == want["best_config"]
    np.testing.assert_allclose(got["best_score"], want["best_score"], atol=1e-4, rtol=1e-4)
    assert set(want) - {"device"} <= set(got)
    for key in keys:
        assert got.get(key) == want.get(key), key
    assert 0 < got["active_lane_share"] <= 1
    assert got["streamed_results"] > 0


def test_lane_refill_cli_streams_without_a_batch_fallback(capsys):
    """``--lane-refill`` reaches the streaming protocol: a refill flight ran,
    results streamed, and the manager never warned of a fallback to batch
    flights."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = _run(hpo.main, BASE + ["--lane-refill", "--device", "cpu"], capsys)
    assert got["refill_flights"] >= 1 and got["streamed_results"] == 4
    assert got["engine"] == "vmapped+refill"
    assert not [w for w in caught if "falling back" in str(w.message)]


@pytest.mark.parametrize("argv,words", [
    (["--pbt-streaming", "--proposer", "asha"], "needs --proposer pbt"),
    (["--device-rules"], "needs an in-scan rule"),
    (["--pbt-async"], "only applies with --pbt-streaming"),
], ids=["pbt-streaming-without-pbt", "device-rules-without-rule", "pbt-async-alone"])
def test_streaming_cli_refusals_use_the_jax_cli_words(capsys, argv, words):
    with pytest.raises(SystemExit):
        hpo.main(BASE + ["--device", "cpu"] + argv)
    assert words in capsys.readouterr().err


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels and graphs run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_state(tc, k, device):
    return P.init_population_state_from_keys(
        [torch.Generator(device=device).manual_seed(i) for i in range(k)], tc, device)


@pytest.mark.cuda
def test_lane_ops_keep_the_captured_state_leaves(cuda):
    """After a chunk graph captured a flight's state (2 steps trained), init
    (lane 0), splice (lane 1) and clone (lane 2 <- 3) on the leased state
    write in place: every leaf keeps its address, the clone equals its
    donor bit for bit, and the next replay trains the new lanes from their
    new step counts."""
    tc = _tc()
    data = SyntheticLM(tc.model.vocab_size, 64, 2, seed=0)
    k = 4
    P.clear_population_cache()
    state = _card_state(tc, k, cuda)
    hp = stack_hparams([hparams_from_dict(dict(learning_rate=1e-3, total_steps=8), tc)] * k,
                       cuda)
    lo, hi = (torch.from_numpy(w.astype(np.int64)).to(cuda) for w in split_streams(range(k)))
    prog = P.get_compiled_population_scan_step(tc, k, data, 2)
    prog(state, hp, torch.zeros(k, dtype=torch.int64, device=cuda), lo, hi)
    with P.flight_lease(tc, k, data, True, cuda) as st:
        assert st is state
        ptrs = [t.data_ptr() for t in interop.tree_leaves(st)]
        P.get_lane_op(tc, k, "init")(st, [True, False, False, False],
                                     [torch.Generator(device=cuda).manual_seed(9)] * k)
        P.get_lane_op(tc, k, "splice")(st, 1, torch.Generator(device=cuda).manual_seed(3))
        P.get_lane_op(tc, k, "clone")(st, [False, False, True, False], [0, 1, 3, 3])
        assert [t.data_ptr() for t in interop.tree_leaves(st)] == ptrs
        assert st["inner"]["opt"]["step"].tolist() == [0, 0, 2, 2]
        assert _bits_equal(interop.tree_map(lambda t: t[2], st),
                           interop.tree_map(lambda t: t[3], st))
        st, _ = prog(st, hp, torch.zeros(k, dtype=torch.int64, device=cuda), lo, hi)
        torch.cuda.synchronize()
        assert st["inner"]["opt"]["step"].tolist() == [2, 2, 4, 4]
    P.clear_population_cache()


@pytest.mark.cuda
def test_clone_chain_on_the_card_equals_the_cpu(cuda):
    tc = _tc()
    cpu = _card_state(tc, 4, "cpu")
    cpu["last_loss"].copy_(torch.tensor([1.0, 2.0, 3.0, 4.0]))
    card = interop.tree_map(lambda t: t.to(cuda, copy=True), cpu)
    mask, donors = [True, True, False, True], [1, 2, 2, 0]
    P.get_lane_op(tc, 4, "clone")(cpu, mask, donors)
    P.get_lane_op(tc, 4, "clone")(card, mask, donors)
    assert _bits_equal(interop.tree_map(lambda t: t.cpu(), card), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cohort", "staggered", "pbt"])
def test_rule_chunk_replay_equals_its_eager_loop(cuda, mode):
    """A rule chunk of 4 replayed from its CUDA graph against the same chunk
    run eagerly on the card, at the smoke config in fp32: state, losses,
    budgets log and rule state equal bit for bit; against the CPU's chunk
    within 1e-4."""
    tc = _tc()
    data = SyntheticLM(tc.model.vocab_size, 64, 2, seed=0)
    k, chunk = 4, 4
    cfgs = [dict(learning_rate=lr, total_steps=8, warmup_frac=0.25)
            for lr in (1e-3, 3e-3, 2e-3, 5e-3)]
    init = _card_state(tc, k, "cpu")
    local0 = np.asarray(_RULE_CASES[mode][1])
    lo, hi = (torch.from_numpy(w.astype(np.int64)) for w in split_streams([0, 5, 2, 7]))
    runs = {}
    for name, dev in (("cpu", "cpu"), ("eager", cuda), ("graph", cuda)):
        hp = stack_hparams([hparams_from_dict(c, tc) for c in cfgs], dev)
        rules = {n: v.to(dev) for n, v in _rule_state(P, mode, np.zeros(k)).items()}
        st = interop.tree_map(lambda t: t.to(dev, copy=True), init)
        args = (hp, torch.from_numpy(local0.astype(np.int64)).to(dev), lo.to(dev), hi.to(dev),
                rules)
        if name == "eager":
            out = P.make_population_rule_scan_step(tc, data, chunk, mode)(st, *args)
        else:
            P.clear_population_cache()
            out = P.get_compiled_population_rule_scan_step(tc, k, data, chunk, mode)(st, *args)
        runs[name] = interop.tree_map(lambda t: t.detach().cpu().clone(), out)
    P.clear_population_cache()
    assert _bits_equal(runs["graph"], runs["eager"])
    (cst, crules), cm = runs["cpu"]
    (gst, grules), gm = runs["graph"]
    np.testing.assert_allclose(gm["loss"].numpy(), cm["loss"].numpy(), atol=1e-4, rtol=1e-4)
    assert torch.equal(gm["budgets"], cm["budgets"])
    for g, c in zip(interop.tree_leaves(gst["inner"]["params"]),
                    interop.tree_leaves(cst["inner"]["params"])):
        np.testing.assert_allclose(g.float().numpy(), c.float().numpy(), atol=1e-4, rtol=1e-4)
    assert math.isfinite(float(gm["loss"][-1].max()))
