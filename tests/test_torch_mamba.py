"""falcon-mamba in the PyTorch port against the JAX package.

The Mamba mixer, the model (mixer ``mamba``, no FFN), the train step and the
population step, on the falcon-mamba smoke config in fp32 on the CPU (the
plain selective scan).  Parameters come from JAX through
``repro_torch.interop`` (the two RNGs differ); batches from the shared numpy
host synthesis.  1e-4 on activations, logits, losses and parameters.
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
from repro.models import mamba as JM
from repro.models import transformer as JT
from repro.optim.hparams import hparams_from_dict as jax_hparams_from_dict
from repro.optim.hparams import stack_hparams as jax_stack_hparams
from repro.train import population as JP
from repro.train.loss import cross_entropy as jax_cross_entropy
from repro.train.train_step import init_train_state as jax_init_train_state
from repro.train.train_step import make_hparam_train_step as jax_make_step
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
from repro_torch.train import population as P
from repro_torch.train.loss import cross_entropy
from repro_torch.train.train_step import make_hparam_train_step

torch.set_num_threads(2)

ARCH = "falcon-mamba-7b"
B, S, STEPS = 2, 16, 3
LANES = [
    dict(learning_rate=3e-3, warmup_frac=0.34, weight_decay=0.1, b2=0.95, grad_clip=1.0),
    dict(learning_rate=1e-2, warmup_frac=0.2, weight_decay=0.0, b2=0.99, grad_clip=0.0),
    dict(learning_rate=5e-3, warmup_frac=0.5, weight_decay=0.3, b2=0.9, grad_clip=0.5),
]


def _configs():
    jtc = JaxTrainConfig(model=jax_smoke_config(ARCH), parallel=JaxParallelConfig(remat="none"))
    tc = TrainConfig(model=get_smoke_config(ARCH), parallel=ParallelConfig(remat="none"))
    return jtc, tc


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _stack(trees):
    return interop.tree_map(lambda *xs: torch.stack(xs),
                            *[interop.to_torch(jax.device_get(t)) for t in trees])


def _assert_tree_close(got, want, tol):
    for g, w in zip(interop.tree_leaves(interop.to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=tol)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_jax_layout(param_dtype):
    """The port's own init builds the JAX package's tree (no ``norm2``, no
    ``ffn`` in a mamba layer), with ``A_log`` and ``D`` in fp32 whatever the
    parameter dtype, and the JAX package's starting values."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype=param_dtype)
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), param_dtype=param_dtype)
    want = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    got = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert jax.tree.structure(want) == jax.tree.structure(interop.tree_map(lambda t: 0, got))
    for g, w in zip(interop.tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    layer = got["blocks"]["l0"]
    assert sorted(layer) == ["mixer", "norm1"]
    mix = layer["mixer"]
    N = cfg.ssm_state
    assert mix["A_log"].dtype == mix["D"].dtype == torch.float32
    torch.testing.assert_close(mix["A_log"][0, 0], torch.log(torch.arange(1.0, N + 1)))
    assert float((mix["D"] - 1).abs().max()) == 0.0
    assert float(mix["conv_b"].abs().max()) == 0.0
    sp = torch.nn.functional.softplus(mix["dt_bias"].float())
    torch.testing.assert_close(sp, torch.full_like(sp, 0.01), atol=1e-4, rtol=1e-2)


def test_mamba_apply_matches_jax():
    """Two lanes with different mixer weights (and so different A and D):
    each lane's output equals ``repro.models.mamba.mamba_apply`` on that
    lane's weights and input, at 1e-4."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    K = 2
    jparams = [JM.mamba_init(jax.random.PRNGKey(i), jcfg) for i in range(K)]
    jparams[1]["A_log"] = jparams[1]["A_log"] * 0.7
    jparams[1]["D"] = jparams[1]["D"] * -0.5
    x = np.random.default_rng(0).standard_normal((K, B, S, cfg.d_model)).astype(np.float32)
    got = M.mamba_apply(_stack(jparams), torch.from_numpy(x), cfg)
    assert got.shape == x.shape
    for i in range(K):
        want = JM.mamba_apply(jparams[i], jnp.asarray(x[i]), jcfg)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_forward_and_loss_match_jax():
    """falcon-mamba smoke, two lanes with different weights: logits and loss
    of each lane equal the JAX forward on that lane, at 1e-4."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    K = 2
    jparams = [JT.init_params(jax.random.PRNGKey(i), jcfg) for i in range(K)]
    data = SyntheticLM(cfg.vocab_size, S, B, seed=0)
    batches = [data.make_batch(0, stream=i) for i in range(K)]
    tb = {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}
    logits, _ = T.forward(_stack(jparams), tb["tokens"], cfg)
    loss, _ = cross_entropy(logits, tb["targets"], tb["mask"])
    assert logits.shape == (K, B, S, cfg.vocab_size)
    for i in range(K):
        jlogits, _ = JT.forward(jparams[i], jnp.asarray(batches[i]["tokens"]), jcfg)
        jloss, _ = jax_cross_entropy(jlogits, jnp.asarray(batches[i]["targets"]),
                                     jnp.asarray(batches[i]["mask"]))
        np.testing.assert_allclose(logits[i].detach().numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(loss[i]), float(jloss), atol=1e-4, rtol=1e-4)


def test_interop_round_trip_mamba_population_state():
    """A bf16 falcon-mamba population state, whose ``A_log`` and ``D``
    leaves (and their Adam moments) are fp32, survives numpy -> port tensors
    -> numpy bit for bit, each leaf in its own dtype."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    pstate = jax.device_get(JP.init_population_state(
        jax.random.PRNGKey(0), JaxTrainConfig(model=jcfg), 3))
    tstate = interop.to_torch(pstate)
    mix = tstate["inner"]["params"]["blocks"]["l0"]["mixer"]
    n_sb, di, N = jcfg.n_superblocks, jcfg.d_inner, jcfg.ssm_state
    assert mix["A_log"].shape == (3, n_sb, di, N) and mix["A_log"].dtype == torch.float32
    assert mix["D"].dtype == torch.float32 and mix["in_proj"].dtype == torch.bfloat16
    back = interop.to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(pstate), interop.tree_leaves(back)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32) if a.dtype.name == "bfloat16"
                                      else a, b)
    # the port updates its state in place: no leaf may alias the JAX arrays
    before = np.asarray(pstate["inner"]["params"]["blocks"]["l0"]["mixer"]["in_proj"],
                        np.float32).copy()
    for leaf in interop.tree_leaves(tstate["inner"]["params"]):
        leaf.add_(1)
    np.testing.assert_array_equal(
        np.asarray(pstate["inner"]["params"]["blocks"]["l0"]["mixer"]["in_proj"], np.float32),
        before)


def test_train_step_three_steps_match_jax():
    """Three steps of ``make_hparam_train_step`` (K=1, weight decay 0.1):
    losses, gradient norms and parameters within 1e-4 of JAX.  The decay
    moves ``A_log`` (per trial ``(n_superblocks, d_inner, N)``) and ``D`` by
    more than the tolerance, so the reference's decay rule (per-trial
    ``ndim >= 2``) is held here too."""
    jtc, tc = _configs()
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


def test_population_step_matches_jax():
    """A K=4 falcon-mamba population step: per-lane init and hyperparameters,
    a 0-budget lane and a lane whose loss is NaN.  last_loss, the divergence
    latch, step counters and parameters match JAX at 1e-4; the frozen lanes
    keep their state bit for bit."""
    jtc, tc = _configs()
    budgets = [STEPS, 2, 0, STEPS]
    keys = jax.random.split(jax.random.PRNGKey(0), len(budgets))
    jp = JP.init_population_state_from_keys(keys, jtc)
    gains = jp["inner"]["params"]["final_norm"]
    jp["inner"]["params"]["final_norm"] = gains.at[3, 0].set(jnp.nan)
    cfgs = [dict(LANES[i % len(LANES)], total_steps=b) for i, b in enumerate(budgets)]
    jhp = jax_stack_hparams([jax_hparams_from_dict(c, jtc) for c in cfgs])
    hp = stack_hparams([hparams_from_dict(c, tc) for c in cfgs])
    tp = interop.to_torch(jax.device_get(jp))
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
    assert tp["diverged"].tolist() == np.asarray(jp["diverged"]).tolist() == [
        False, False, False, True]
    assert tp["inner"]["opt"]["step"].tolist() == [3, 2, 0, 0]
    np.testing.assert_allclose(tp["last_loss"].numpy(), np.asarray(jp["last_loss"]),
                               atol=1e-4, rtol=1e-4)
    _assert_tree_close(tp["inner"]["params"], jp["inner"]["params"], 1e-4)
    now = interop.to_numpy(tp["inner"])
    for a, b in zip(interop.tree_leaves(init["inner"]), interop.tree_leaves(now)):
        np.testing.assert_array_equal(a[2:], b[2:])  # frozen lanes: bit for bit
