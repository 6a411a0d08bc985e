"""The port's MLA (``repro_torch.models.attention.mla_*``) and deepseek-v2-lite
against the JAX package.

RoPE with and without a head axis against ``repro.models.rope.apply_rope``;
``mla_apply`` on one lane and on K=2 lanes with different weights, each lane
held against ``repro.models.attention.mla_apply`` on its slice: y at 3e-5,
the gradients of x and of every MLA leaf at 5e-5.  Then deepseek-v2-lite's
smoke config (a dense MLA prefix layer, MLA + MoE superblocks): three train
steps and a K=4 population step within 1e-4, the CLI chunked and with
``--fused-attention`` within 1e-4 of the JAX CLI (per step:
``tests/test_torch_hpo.py``), chunked equal to per step bit for bit.
Parameters come from JAX through ``repro_torch.interop``, inputs from a
numpy seed, fp32 on the CPU.  On an NVIDIA GPU (marker ``cuda``, without
JAX): the layer's forward and backward give the same bits run twice and in
either lane.
"""
import contextlib
import dataclasses
import io
import json
import time

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX; there only the card-only case runs
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import ParallelConfig as JaxParallelConfig
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.data.pipeline import SyntheticLM
    from repro.launch import hpo as jax_hpo
    from repro.models import attention as JA
    from repro.models import rope as JR
    from repro.optim.hparams import hparams_from_dict as jax_hparams_from_dict
    from repro.optim.hparams import stack_hparams as jax_stack_hparams
    from repro.train import population as JP
    from repro.train.train_step import init_train_state as jax_init_train_state
    from repro.train.train_step import make_hparam_train_step as jax_make_step
except ModuleNotFoundError:
    pass
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.experiment import Experiment
from repro_torch.launch import hpo
from repro_torch.models import attention as A
from repro_torch.models.rope import apply_rope
from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
from repro_torch.train import population as P
from repro_torch.train import train_step as ts
from repro_torch.train.train_step import make_hparam_train_step

torch.set_num_threads(2)

ARCH = "deepseek-v2-lite-16b"
B, S, STEPS = 2, 16, 3
LANES = [
    dict(learning_rate=3e-3, warmup_frac=0.34, weight_decay=0.1, b2=0.95, grad_clip=1.0),
    dict(learning_rate=1e-2, warmup_frac=0.2, weight_decay=0.0, b2=0.99, grad_clip=0.0),
    dict(learning_rate=5e-3, warmup_frac=0.5, weight_decay=0.3, b2=0.9, grad_clip=0.5),
]


def _stack(trees):
    return interop.tree_map(lambda *xs: torch.stack(xs),
                            *[interop.to_torch(jax.device_get(t)) for t in trees])


def _layer(K):
    """K lanes of JAX MLA weights (the kv_norm gain moved off zero, so the
    per-lane gain is held too) and an input (K, B, S, d)."""
    jcfg = jax_smoke_config(ARCH)
    jparams = [JA.mla_init(jax.random.PRNGKey(i), jcfg) for i in range(K)]
    rng = np.random.default_rng(0)
    for p in jparams:
        p["kv_norm"] = jnp.asarray(0.1 * rng.standard_normal(p["kv_norm"].shape), jnp.float32)
    x = rng.standard_normal((K, B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, get_smoke_config(ARCH), jparams, x


def _assert_tree_close(got, want, tol):
    for g, w in zip(interop.tree_leaves(interop.to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=tol)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# -------------------------------------------------------------------- the layer
@pytest.mark.parametrize("heads", [True, False], ids=["head-axis", "no-head-axis"])
def test_apply_rope_matches_jax(heads):
    """``apply_rope`` on (K, B, S, H, D) and, with ``heads=False``, on MLA's
    shared (K, B, S, rr) against JAX's on each lane at 1e-6."""
    shape = (2, B, S, 3, 16) if heads else (2, B, S, 16)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = apply_rope(torch.from_numpy(x), torch.arange(S), 10000.0, heads=heads).numpy()
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    for k in range(2):
        want = JR.apply_rope(jnp.asarray(x[k]), pos, 10000.0)
        np.testing.assert_allclose(got[k], np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_mla_init_tree_matches_jax(param_dtype):
    """The port's own init builds the JAX package's MLA tree: the same keys,
    shapes and dtypes, ``kv_norm`` at zero (stored as gamma - 1), the
    projections truncated at 2 std."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), param_dtype=param_dtype)
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype=param_dtype)
    want = jax.eval_shape(lambda: JA.mla_init(jax.random.PRNGKey(0), jcfg))
    got = A.mla_init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert jax.tree.structure(want) == jax.tree.structure(interop.tree_map(lambda t: 0, got))
    for g, w in zip(interop.tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert float(got["kv_norm"].abs().max()) == 0.0
    assert float(got["wk_b"].float().abs().max()) <= 2.0 / cfg.kv_lora_rank ** 0.5 + 1e-6


@pytest.mark.parametrize("K", [1, 2], ids=["one-lane", "two-lanes"])
def test_mla_apply_matches_jax(K):
    """Each lane's y within 3e-5 of ``repro.models.attention.mla_apply`` on
    that lane's weights and input."""
    jcfg, cfg, jparams, x = _layer(K)
    y = A.mla_apply(_stack(jparams), torch.from_numpy(x), cfg, torch.arange(S))
    assert y.shape == x.shape
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    for i in range(K):
        jy = JA.mla_apply(jparams[i], jnp.asarray(x[i]), jcfg, pos)
        np.testing.assert_allclose(y[i].numpy(), np.asarray(jy), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("K", [1, 2], ids=["one-lane", "two-lanes"])
def test_mla_gradients_match_jax(K):
    """Gradients of ``sum(y**2)`` in x and in every MLA leaf (``kv_norm``'s
    per-lane gain too), each lane against ``jax.grad`` on its slice, at
    5e-5: the plain flash backward at q/k width 32, v width 16."""
    jcfg, cfg, jparams, x = _layer(K)
    tparams = interop.tree_map(lambda t: t.requires_grad_(True), _stack(jparams))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = A.mla_apply(tparams, tx, cfg, torch.arange(S))
    leaves = interop.tree_leaves(tparams)
    grads = torch.autograd.grad((y ** 2).sum(), [tx] + leaves)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))

    def jloss(p, xi):
        return (JA.mla_apply(p, xi, jcfg, pos) ** 2).sum()

    for i in range(K):
        gp, gx = jax.grad(jloss, argnums=(0, 1))(jparams[i], jnp.asarray(x[i]))
        np.testing.assert_allclose(grads[0][i].numpy(), np.asarray(gx), atol=5e-5, rtol=5e-5)
        for g, w in zip(grads[1:], jax.tree.leaves(gp)):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), atol=5e-5, rtol=5e-5)


# -------------------------------------------------------------------- the model
def _train_configs(mb=0):
    jtc = JaxTrainConfig(model=jax_smoke_config(ARCH),
                         parallel=JaxParallelConfig(remat="none", microbatch=mb))
    tc = TrainConfig(model=get_smoke_config(ARCH),
                     parallel=ParallelConfig(remat="none", microbatch=mb))
    return jtc, tc


@pytest.mark.parametrize("mb", [0, 1], ids=["whole-batch", "microbatch"])
def test_train_step_three_steps_match_jax(mb):
    """Three steps of ``make_hparam_train_step`` (K=1, weight decay 0.1):
    losses (with the aux loss), ``aux_loss``, gradient norms and parameters
    within 1e-4 of JAX; with ``microbatch`` the metrics are microbatch
    means, as in JAX."""
    jtc, tc = _train_configs(mb)
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
        assert float(m["aux_loss"][0]) > 0
        for key in ("loss", "aux_loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key][0]), float(jm[key]), atol=1e-4, rtol=1e-4,
                                       err_msg=key)
    assert int(state["opt"]["step"][0]) == int(jstate["opt"]["step"]) == STEPS
    _assert_tree_close(interop.tree_map(lambda t: t[0], state["params"]),
                       jstate["params"], 1e-4)


def test_population_step_matches_jax():
    """A K=4 deepseek population step: per-lane init and hyperparameters, a
    0-budget lane and a lane whose first MLA ``kv_norm`` gain is NaN.
    last_loss, the divergence latch, step counters and parameters match JAX
    at 1e-4; the live lanes' aux_loss matches; the frozen lanes keep their
    state bit for bit."""
    jtc, tc = _train_configs()
    budgets = [STEPS, 2, 0, STEPS]
    keys = jax.random.split(jax.random.PRNGKey(0), len(budgets))
    jp = JP.init_population_state_from_keys(keys, jtc)
    mixer = jp["inner"]["params"]["prefix"][0]["mixer"]
    mixer["kv_norm"] = mixer["kv_norm"].at[3, 0].set(jnp.nan)
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
        np.testing.assert_allclose(m["aux_loss"][:3].numpy(), np.asarray(jm["aux_loss"])[:3],
                                   atol=1e-4, rtol=1e-4)
    assert tp["diverged"].tolist() == np.asarray(jp["diverged"]).tolist() == [
        False, False, False, True]
    assert tp["inner"]["opt"]["step"].tolist() == [3, 2, 0, 0]
    np.testing.assert_allclose(tp["last_loss"].numpy(), np.asarray(jp["last_loss"]),
                               atol=1e-4, rtol=1e-4)
    _assert_tree_close(tp["inner"]["params"], jp["inner"]["params"], 1e-4)
    now = interop.to_numpy(tp["inner"])
    for a, b in zip(interop.tree_leaves(init["inner"]), interop.tree_leaves(now)):
        np.testing.assert_array_equal(a[2:], b[2:])  # frozen lanes: bit for bit


# -------------------------------------------------------------------- the CLI
BASE = ["--n-samples", "4", "--steps", "3", "--batch", "2", "--seq", "16",
        "--arch", ARCH, "--vectorize", "2"]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue())


@pytest.fixture(scope="module")
def jax_cli():
    """The JAX CLI's result on deepseek smoke, and its init state (the
    port's trials start from it)."""
    jtc = JaxTrainConfig(model=jax_smoke_config(ARCH))
    state = jax.device_get(jax_init_train_state(jax.random.PRNGKey(0), jtc))
    return _run(jax_hpo.main, BASE), state


@pytest.mark.parametrize("extra", [["--chunk-steps", "4"], ["--fused-attention"]],
                         ids=["chunk-steps-4", "fused-attention"])
def test_cli_matches_jax_cli(monkeypatch, jax_cli, extra):
    """``--arch deepseek-v2-lite-16b --vectorize 2``, chunked and with
    ``--fused-attention`` (accepted: MLA is an attention mixer): the JAX
    CLI's best config (per step) and a best score within 1e-4."""
    want, state = jax_cli
    monkeypatch.setattr(ts, "init_train_state",
                        lambda gen, tc, device: interop.to_torch(state, device))
    got = _run(hpo.main, BASE + extra + ["--device", "cpu"])
    assert got["arch"] == want["arch"] == ARCH
    assert got["best_config"] == want["best_config"]
    np.testing.assert_allclose(got["best_score"], want["best_score"], atol=1e-4, rtol=1e-4)
    assert got.get("fused_attention") == ("--fused-attention" in extra or None)


# every sample of the run in one flight: the vectorized manager flushes a
# partial population when a slot comes back with jobs buffered, so with
# fewer lanes than samples the flights' fill follows the timing of the
# flight worker's reports (the JAX package's manager does the same)
ONE_FLIGHT = BASE[:3] + ["4"] + BASE[4:-1] + ["4", "--device", "cpu"]


def _chunked_against_per_step():
    per_step = _run(hpo.main, ONE_FLIGHT + ["--chunk-steps", "1"])
    chunked = _run(hpo.main, ONE_FLIGHT + ["--chunk-steps", "4"])
    assert chunked["engine"] == "vmapped+chunked"
    assert chunked["best_score"] == per_step["best_score"]
    assert chunked["best_config"] == per_step["best_config"]
    assert chunked["trained_steps"] == per_step["trained_steps"]
    assert chunked["device_dispatches"] < per_step["device_dispatches"]


def test_cli_chunked_equals_per_step_bitwise():
    """Inside the port ``--chunk-steps 4`` and ``1`` give the same best score
    bit for bit on deepseek, with fewer dispatches chunked (4 samples on 4
    lanes: one flight each, whatever the host's load)."""
    _chunked_against_per_step()


def test_cli_chunked_equals_per_step_when_jobs_report_late(monkeypatch):
    """The same comparison with every flight's odd jobs reported 0.3 s late,
    as a loaded host may order them: the one flight's fill does not move."""
    report = Experiment._on_job_done

    def late(self, job):
        if job.job_id % 2:
            time.sleep(0.3)
        report(self, job)

    monkeypatch.setattr(Experiment, "_on_job_done", late)
    _chunked_against_per_step()


# -------------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the layer's determinism is a property of the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _fwd_bwd_bits(params, x, cfg):
    """y and the gradients of ``sum(y**2)`` in x and every leaf, as raw bits."""
    leaves = [t.detach().requires_grad_(True) for t in interop.tree_leaves(params)]
    xx = x.detach().requires_grad_(True)
    y = A.mla_apply(interop.tree_unflatten(params, leaves), xx, cfg,
                    torch.arange(x.shape[2], device=x.device))
    grads = torch.autograd.grad((y.float() ** 2).sum(), [xx] + leaves)
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return [t.detach().view(bits[t.dtype]) for t in [y] + list(grads)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_layer_is_deterministic_and_lane_independent_on_the_card(cuda, dtype):
    """One MLA layer at smoke size: forward (the flash kernel of the dtype,
    q/k width 32, v width 16) and the dtype's flash backward kernel (bf16:
    the mma.sync instance these widths take; fp32: the CUDA-core kernel) run
    twice give raw-bit-equal y and gradients, and the same inputs in lane 0
    and lane 1 the same bits in each lane."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype=dtype, compute_dtype=dtype)
    one = A.mla_init(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    params = interop.tree_map(lambda t: t[None].expand((2,) + t.shape).contiguous(), one)
    x = np.random.default_rng(0).standard_normal((1, B, S, cfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x).to(cuda, getattr(torch, dtype)).expand(2, -1, -1, -1)
    tx = tx.contiguous()
    first = _fwd_bwd_bits(params, tx, cfg)
    again = _fwd_bwd_bits(params, tx, cfg)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(t[0], t[1]) for t in first)
