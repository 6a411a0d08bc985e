"""The models with a frontend, hubert-xlarge (audio frames, encoder-only) and
pixtral-12b (image patches), in the port against the JAX package.

``repro_torch.models.frontend`` is a copy of the JAX package's numpy stub:
the same synthetic frames and patches bit for bit.  ``forward(...,
inputs_embeds=...)`` on those embeddings, and the train step on a batch of
``embeds``, against JAX at 1e-4; then each smoke config on tokens, as the
HPO CLIs train them: three train steps and a K=4 population step within
1e-4.  Parameters come from JAX through ``repro_torch.interop``; fp32 on the
CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import SyntheticLM
from repro.models import frontend as JF
from repro.models import transformer as JT
from repro.optim.hparams import hparams_from_dict as jax_hparams_from_dict
from repro.optim.hparams import stack_hparams as jax_stack_hparams
from repro.train import population as JP
from repro.train.train_step import init_train_state as jax_init_train_state
from repro.train.train_step import make_hparam_train_step as jax_make_step
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.models import frontend as F
from repro_torch.models import transformer as T
from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
from repro_torch.train import population as P
from repro_torch.train.train_step import make_hparam_train_step

torch.set_num_threads(2)

ARCHS = ["hubert-xlarge", "pixtral-12b"]
SYNTH = {"hubert-xlarge": "synthetic_audio_frames", "pixtral-12b": "synthetic_image_patches"}
B, S, STEPS = 2, 16, 3
LANES = [
    dict(learning_rate=3e-3, warmup_frac=0.34, weight_decay=0.1, b2=0.95, grad_clip=1.0),
    dict(learning_rate=1e-2, warmup_frac=0.2, weight_decay=0.0, b2=0.99, grad_clip=0.0),
    dict(learning_rate=5e-3, warmup_frac=0.5, weight_decay=0.3, b2=0.9, grad_clip=0.5),
]


def _configs(arch):
    jtc = JaxTrainConfig(model=jax_smoke_config(arch), parallel=JaxParallelConfig(remat="none"))
    tc = TrainConfig(model=get_smoke_config(arch), parallel=ParallelConfig(remat="none"))
    return jtc, tc


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _stack(trees):
    return interop.tree_map(lambda *xs: torch.stack(xs),
                            *[interop.to_torch(jax.device_get(t)) for t in trees])


def _assert_tree_close(got, want, tol):
    for g, w in zip(interop.tree_leaves(interop.to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=tol)


def _embeds(arch, d, seed):
    return getattr(F, SYNTH[arch])(B, S, d, seed=seed)


@pytest.mark.parametrize("name,n", [("synthetic_audio_frames", 16),
                                    ("synthetic_image_patches", 16),
                                    ("synthetic_image_patches", 20)])
def test_frontend_stub_equals_jax_bit_for_bit(name, n):
    """The port's numpy frontend stub gives the JAX package's frames and
    patches bit for bit (20 patches: a square of 16 padded with zeros)."""
    for seed in (0, 3):
        got = getattr(F, name)(2, n, 24, seed=seed)
        want = getattr(JF, name)(2, n, 24, seed=seed)
        assert got.dtype == want.dtype == np.float32 and got.shape == (2, n, 24)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_on_inputs_embeds_matches_jax(arch):
    """Two lanes with different weights, each on its own frontend embeddings
    (``forward(None, inputs_embeds=...)``): logits within 1e-4 of JAX's
    ``forward(..., inputs_embeds=...)`` on that lane; the embedding table is
    not read."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    K = 2
    jparams = [JT.init_params(jax.random.PRNGKey(i), jcfg) for i in range(K)]
    emb = np.stack([_embeds(arch, cfg.d_model, seed=i) for i in range(K)])
    tparams = _stack(jparams)
    tparams["embedding"]["embed"].fill_(float("nan"))
    logits, aux = T.forward(tparams, None, cfg, inputs_embeds=torch.from_numpy(emb))
    assert logits.shape == (K, B, S, cfg.vocab_size) and aux.shape == (K,)
    for i in range(K):
        want, _ = JT.forward(jparams[i], None, jcfg, inputs_embeds=jnp.asarray(emb[i]))
        np.testing.assert_allclose(logits[i].detach().numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_embeds_matches_jax(arch):
    """Three train steps on batches of ``embeds`` (the frontend's output),
    ``targets`` and ``mask``, no tokens: losses, gradient norms and
    parameters within 1e-4 of the JAX step on the same batches."""
    jtc, tc = _configs(arch)
    data = SyntheticLM(tc.model.vocab_size, S, B, seed=0)
    jstate = jax_init_train_state(jax.random.PRNGKey(0), jtc)
    state = interop.add_lane_axis(interop.to_torch(jax.device_get(jstate)))
    cfg = dict(LANES[0], total_steps=STEPS)
    jhp = jax_hparams_from_dict(cfg, jtc)
    hp = stack_hparams([hparams_from_dict(cfg, tc)])
    jstep = jax.jit(jax_make_step(jtc))
    step = make_hparam_train_step(tc)
    for t in range(STEPS):
        tok = data.make_batch(t, stream=0)
        batch = {"embeds": _embeds(arch, tc.model.d_model, seed=t),
                 "targets": tok["targets"], "mask": tok["mask"]}
        jstate, jm = jstep(jstate, batch, jhp)
        state, m = step(state, {k: v[None] for k, v in _t(batch).items()}, hp)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key][0]), float(jm[key]), atol=1e-4, rtol=1e-4,
                                       err_msg=key)
    _assert_tree_close(interop.tree_map(lambda t: t[0], state["params"]),
                       jstate["params"], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_three_steps_match_jax(arch):
    """Three token steps of ``make_hparam_train_step`` (K=1, weight decay
    0.1), as the CLIs train these models: losses, gradient norms and
    parameters within 1e-4 of JAX."""
    jtc, tc = _configs(arch)
    data = SyntheticLM(tc.model.vocab_size, S, B, seed=0)
    jstate = jax_init_train_state(jax.random.PRNGKey(0), jtc)
    state = interop.add_lane_axis(interop.to_torch(jax.device_get(jstate)))
    cfg = dict(LANES[1], total_steps=STEPS)
    jhp = jax_hparams_from_dict(cfg, jtc)
    hp = stack_hparams([hparams_from_dict(cfg, tc)])
    jstep = jax.jit(jax_make_step(jtc))
    step = make_hparam_train_step(tc)
    for t in range(STEPS):
        batch = data.make_batch(t, stream=0)
        jstate, jm = jstep(jstate, batch, jhp)
        state, m = step(state, {k: v[None] for k, v in _t(batch).items()}, hp)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key][0]), float(jm[key]), atol=1e-4, rtol=1e-4,
                                       err_msg=key)
    assert int(state["opt"]["step"][0]) == int(jstate["opt"]["step"]) == STEPS
    _assert_tree_close(interop.tree_map(lambda t: t[0], state["params"]),
                       jstate["params"], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_population_step_matches_jax(arch):
    """A K=4 population step: per-lane init and hyperparameters, a 0-budget
    lane and a lane whose loss is NaN.  last_loss, the divergence latch, step
    counters and parameters match JAX at 1e-4; the frozen lanes keep their
    state bit for bit."""
    jtc, tc = _configs(arch)
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
