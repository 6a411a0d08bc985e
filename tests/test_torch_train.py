"""The port's train step and population step against the JAX package.

Initial states come from JAX through ``repro_torch.interop``; batches from
the shared numpy host synthesis.  fp32 on the CPU: 1e-4 on losses and
parameters against JAX, 1e-6 between the port's K=1 and K-lane steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import SyntheticLM
from repro.optim.hparams import hparams_from_dict as jax_hparams_from_dict
from repro.optim.hparams import stack_hparams as jax_stack_hparams
from repro.train import population as JP
from repro.train.train_step import init_train_state as jax_init_train_state
from repro.train.train_step import make_hparam_train_step as jax_make_step
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
from repro_torch.train import population as P
from repro_torch.train.train_step import make_hparam_train_step

torch.set_num_threads(2)

ARCH = "starcoder2-3b"
B, S, STEPS = 2, 16, 3
LANES = [
    dict(learning_rate=3e-3, warmup_frac=0.34, weight_decay=0.1, b2=0.95, grad_clip=1.0),
    dict(learning_rate=1e-2, warmup_frac=0.2, weight_decay=0.0, b2=0.99, grad_clip=0.0),
    dict(learning_rate=5e-3, warmup_frac=0.5, weight_decay=0.3, b2=0.9, grad_clip=0.5),
]


def _configs(mb=0):
    jtc = JaxTrainConfig(model=jax_smoke_config(ARCH),
                         parallel=JaxParallelConfig(remat="none", microbatch=mb))
    tc = TrainConfig(model=get_smoke_config(ARCH),
                     parallel=ParallelConfig(remat="none", microbatch=mb))
    return jtc, tc


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_tree_close(got, want, tol):
    for g, w in zip(interop.tree_leaves(interop.to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=tol)


@pytest.mark.parametrize("mb", [0, 1], ids=["full-batch", "microbatch"])
def test_train_step_three_steps_match_jax(mb):
    """Three steps of ``make_hparam_train_step`` (K=1): losses and parameters
    within 1e-4 of JAX, optimizer step counters equal."""
    jtc, tc = _configs(mb)
    data = SyntheticLM(tc.model.vocab_size, S, B, seed=0)
    jstate = jax_init_train_state(jax.random.PRNGKey(0), jtc)
    state = interop.add_lane_axis(interop.to_torch(jax.device_get(jstate)))
    cfg = dict(LANES[0], total_steps=STEPS)
    jhp = jax_hparams_from_dict(cfg, jtc)
    hp = stack_hparams([hparams_from_dict(cfg, tc)])
    jstep = jax.jit(jax_make_step(jtc))
    step = make_hparam_train_step(tc)
    for t in range(STEPS):
        batch = data.make_batch(t, stream=0)
        jstate, jm = jstep(jstate, batch, jhp)
        state, m = step(state, {k: v[None] for k, v in _t(batch).items()}, hp)
        np.testing.assert_allclose(float(m["loss"][0]), float(jm["loss"]), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"][0]), float(jm["grad_norm"]),
                                   atol=1e-4, rtol=1e-4)
    assert int(state["opt"]["step"][0]) == int(jstate["opt"]["step"]) == STEPS
    _assert_tree_close(interop.tree_map(lambda t: t[0], state["params"]),
                       jstate["params"], 1e-4)


def _population(jtc, tc, budgets):
    """K lanes with per-lane init keys and hyperparameters; lane 3 carries a
    NaN gain so its first loss is non-finite."""
    k = len(budgets)
    keys = jax.random.split(jax.random.PRNGKey(0), k)
    jp = JP.init_population_state_from_keys(keys, jtc)
    gains = jp["inner"]["params"]["final_norm"]
    jp["inner"]["params"]["final_norm"] = gains.at[3, 0].set(jnp.nan)
    cfgs = [dict(LANES[i % len(LANES)], total_steps=int(b)) for i, b in enumerate(budgets)]
    jhp = jax_stack_hparams([jax_hparams_from_dict(c, jtc) for c in cfgs])
    hp = stack_hparams([hparams_from_dict(c, tc) for c in cfgs])
    return jp, interop.to_torch(jax.device_get(jp)), jhp, hp


def test_population_step_matches_jax():
    """A K=4 population step: per-lane hyperparameters (clipping off on one
    lane), a 0-budget lane and a lane whose loss is NaN.  last_loss, the
    divergence latch, step counters and parameters match JAX; the frozen
    lanes keep their state bit for bit."""
    jtc, tc = _configs()
    budgets = [STEPS, 2, 0, STEPS]
    jp, tp, jhp, hp = _population(jtc, tc, budgets)
    init = interop.to_numpy(tp)
    data = SyntheticLM(tc.model.vocab_size, S, B, seed=0)
    streams = list(range(len(budgets)))
    jstep = jax.jit(JP.make_population_train_step(jtc, per_trial_batch=True))
    step = P.make_population_train_step(tc, per_trial_batch=True)
    for t in range(STEPS):
        batch = data.make_population_batch(t, streams)
        jp, jm = jstep(jp, batch, jhp)
        tp, m = step(tp, _t(batch), hp)
        np.testing.assert_array_equal(m["active"].numpy(), np.asarray(jm["active"]))
    np.testing.assert_array_equal(tp["diverged"].numpy(), np.asarray(jp["diverged"]))
    assert tp["diverged"].tolist() == [False, False, False, True]
    np.testing.assert_array_equal(tp["inner"]["opt"]["step"].numpy(),
                                  np.asarray(jp["inner"]["opt"]["step"]))
    assert tp["inner"]["opt"]["step"].tolist() == [3, 2, 0, 0]
    np.testing.assert_allclose(tp["last_loss"].numpy(), np.asarray(jp["last_loss"]),
                               atol=1e-4, rtol=1e-4)
    _assert_tree_close(tp["inner"]["params"], jp["inner"]["params"], 1e-4)
    scores = P.population_scores(tp).numpy()
    np.testing.assert_allclose(scores, np.asarray(JP.population_scores(jp)), atol=1e-4)
    now = interop.to_numpy(tp["inner"])
    for a, b in zip(interop.tree_leaves(init["inner"]), interop.tree_leaves(now)):
        np.testing.assert_array_equal(a[2:], b[2:])  # frozen lanes: bit for bit


def test_population_step_with_a_shared_batch_matches_jax():
    """The default population step (``per_trial_batch=False``, as in JAX):
    one (B, S) batch broadcast to K=4 lanes with per-lane hyperparameters, a
    0-budget lane and a NaN lane, against ``JP.make_population_train_step``
    with its default: last_loss, latches, step counters and parameters
    within 1e-4."""
    jtc, tc = _configs()
    budgets = [STEPS, 2, 0, STEPS]
    jp, tp, jhp, hp = _population(jtc, tc, budgets)
    data = SyntheticLM(tc.model.vocab_size, S, B, seed=0)
    jstep = jax.jit(JP.make_population_train_step(jtc))
    step = P.make_population_train_step(tc)
    for t in range(STEPS):
        batch = data.make_batch(t)
        jp, jm = jstep(jp, batch, jhp)
        tp, m = step(tp, _t(batch), hp)
        np.testing.assert_array_equal(m["active"].numpy(), np.asarray(jm["active"]))
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tp["diverged"].numpy(), np.asarray(jp["diverged"]))
    np.testing.assert_array_equal(tp["inner"]["opt"]["step"].numpy(),
                                  np.asarray(jp["inner"]["opt"]["step"]))
    np.testing.assert_allclose(tp["last_loss"].numpy(), np.asarray(jp["last_loss"]),
                               atol=1e-4, rtol=1e-4)
    _assert_tree_close(tp["inner"]["params"], jp["inner"]["params"], 1e-4)


def test_k1_step_matches_k_lane_step():
    """Inside the port: each lane of a K=3 population step equals the K=1
    step on that lane alone, within 1e-6."""
    _, tc = _configs()
    data = SyntheticLM(tc.model.vocab_size, S, B, seed=0)
    gens = [torch.Generator().manual_seed(i) for i in range(3)]
    pstate = P.init_population_state_from_keys(gens, tc, "cpu")
    lanes = [interop.tree_map(lambda t, i=i: t[i:i + 1].clone(), pstate) for i in range(3)]
    cfgs = [dict(c, total_steps=STEPS) for c in LANES]
    hp = stack_hparams([hparams_from_dict(c, tc) for c in cfgs])
    step = P.make_population_train_step(tc, per_trial_batch=True)
    for t in range(STEPS):
        batch = _t(data.make_population_batch(t, [0, 1, 2]))
        pstate, _ = step(pstate, batch, hp)
        for i in range(3):
            hp1 = dataclasses.replace(hp, **{f: getattr(hp, f)[i:i + 1] for f in (
                "learning_rate", "weight_decay", "b2", "grad_clip", "warmup_steps",
                "total_steps")})
            lanes[i], _ = step(lanes[i], {k: v[i:i + 1] for k, v in batch.items()}, hp1)
    for i in range(3):
        for a, b in zip(interop.tree_leaves(pstate), interop.tree_leaves(lanes[i])):
            torch.testing.assert_close(a[i:i + 1], b, atol=1e-6, rtol=1e-6)
