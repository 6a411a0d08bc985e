"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package.

``moe_apply`` on K=2 lanes with different parameters, each lane held against
``repro.models.moe.moe_apply`` on its own slice outside a sharding context:
y at 3e-5 and aux at 1e-5 (the JAX tests' tolerances), gradients at 5e-5;
ties in the router kept and dropped exactly as JAX keeps and drops them.
Then the models that use it, qwen3-moe-30b-a3b and jamba-1.5-large-398b
(Mamba, attention, dense and MoE layers), on their smoke configs: three
train steps and a K=4 population step within 1e-4, with the aux loss in the
metrics; the CLI within 1e-4 of the JAX CLI and chunked equal to per step
bit for bit.  Parameters come from JAX through ``repro_torch.interop``,
inputs from a numpy seed, fp32 on the CPU.  On an NVIDIA GPU (marker
``cuda``, without JAX): a layer's forward and backward give the same bits
run twice and in either lane.
"""
import dataclasses
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
    from repro.models import moe as JM
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
from repro_torch.models import moe as M
from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
from repro_torch.train import population as P
from repro_torch.train import train_step as ts
from repro_torch.train.train_step import make_hparam_train_step

torch.set_num_threads(2)

ARCH = "qwen3-moe-30b-a3b"
JAMBA = "jamba-1.5-large-398b"
K, B, S, STEPS = 2, 4, 8, 3
LANES = [
    dict(learning_rate=3e-3, warmup_frac=0.34, weight_decay=0.1, b2=0.95, grad_clip=1.0),
    dict(learning_rate=1e-2, warmup_frac=0.2, weight_decay=0.0, b2=0.99, grad_clip=0.0),
    dict(learning_rate=5e-3, warmup_frac=0.5, weight_decay=0.3, b2=0.9, grad_clip=0.5),
]
VARIANTS = {
    "capacity-1.25": (dict(), False),
    "capacity-0.25": (dict(capacity_factor=0.25), False),
    "dropless": (dict(), True),
    "groups-4": (dict(moe_groups=4), False),
    "shared-1": (dict(n_shared_experts=1), False),
    "gelu": (dict(activation="gelu"), False),
}


def _cfgs(**kw):
    return (dataclasses.replace(jax_smoke_config(ARCH), **kw),
            dataclasses.replace(get_smoke_config(ARCH), **kw))


def _stack(trees):
    return interop.tree_map(lambda *xs: torch.stack(xs),
                            *[interop.to_torch(jax.device_get(t)) for t in trees])


def _layer(jcfg, x_shape=(K, B, S)):
    jparams = [JM.moe_init(jax.random.PRNGKey(i), jcfg) for i in range(K)]
    x = np.random.default_rng(0).standard_normal(x_shape + (jcfg.d_model,)).astype(np.float32)
    return jparams, x


def _assert_tree_close(got, want, tol):
    for g, w in zip(interop.tree_leaves(interop.to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=tol)


def _dropped(tparams, x, cfg) -> int:
    """Assignments dropped at capacity, over every lane and group."""
    T = x.shape[1] * x.shape[2]
    G = M.dispatch_groups(T, cfg, False)
    xt = x.reshape(x.shape[0], G, T // G, -1)
    _, _, top_e = M.route(tparams["router"], xt, cfg.moe_top_k)
    C = M.capacity(cfg, T // G)
    return int((M.dispatch_slots(top_e, cfg.n_experts, C) == cfg.n_experts * C).sum())


# -------------------------------------------------------------------- the layer
@pytest.mark.parametrize("shared,param_dtype", [(0, "float32"), (1, "bfloat16")])
def test_moe_init_tree_matches_jax(shared, param_dtype):
    """The port's own init builds the JAX package's tree: the same keys,
    shapes and dtypes (the router fp32 in a bf16 model), with and without
    shared experts."""
    jcfg, cfg = _cfgs(n_shared_experts=shared, param_dtype=param_dtype)
    want = jax.eval_shape(lambda: JM.moe_init(jax.random.PRNGKey(0), jcfg))
    got = M.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert jax.tree.structure(want) == jax.tree.structure(interop.tree_map(lambda t: 0, got))
    for g, w in zip(interop.tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert got["router"].dtype == torch.float32
    assert ("shared" in got) == bool(shared)
    bound = 2.0 / cfg.d_model ** 0.5 + 1e-6   # truncated at 2 std, std 1/sqrt(d)
    assert float(got["router"].abs().max()) <= bound
    assert float(got["wi"].float().abs().max()) <= bound


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_apply_matches_jax(variant):
    """Two lanes with different parameters: each lane's y within 3e-5 and aux
    within 1e-5 of ``repro.models.moe.moe_apply`` on that lane's slice; at
    capacity 0.25 some assignments are dropped."""
    kw, dropless = VARIANTS[variant]
    jcfg, cfg = _cfgs(**kw)
    jparams, x = _layer(jcfg)
    tparams = _stack(jparams)
    y, aux = M.moe_apply(tparams, torch.from_numpy(x), cfg, dropless=dropless)
    assert y.shape == x.shape and aux.shape == (K,)
    for i in range(K):
        jy, ja = JM.moe_apply(jparams[i], jnp.asarray(x[i]), jcfg, dropless=dropless)
        np.testing.assert_allclose(y[i].numpy(), np.asarray(jy), atol=3e-5)
        np.testing.assert_allclose(float(aux[i]), float(ja), atol=1e-5)
    if variant == "capacity-0.25":
        assert _dropped(tparams, torch.from_numpy(x), cfg) > 0
        y_free, _ = M.moe_apply(tparams, torch.from_numpy(x), cfg, dropless=True)
        assert float((y - y_free).abs().max()) > 1e-4


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_ties_keep_and_drop_as_jax(top_k):
    """A router whose columns 1 and 2 are equal, every token routed to one
    of them (top 1: they lead; top 2: they follow column 0): the lower
    expert takes the tie, as ``jax.lax.top_k`` gives it, and the capacity
    binds.  Expert ids, slots and the kept/dropped split equal
    JAX's exactly, y within 3e-5."""
    jcfg, cfg = _cfgs(moe_top_k=top_k)
    d, E = cfg.d_model, cfg.n_experts
    router = np.full((d, E), -1.0 / d, np.float32)
    router[:, 1] = router[:, 2] = 1.0 / d
    if top_k == 2:
        router[:, 0] = 2.0 / d
    jp = JM.moe_init(jax.random.PRNGKey(0), jcfg)
    jp["router"] = jnp.asarray(router)
    x = (np.abs(np.random.default_rng(1).standard_normal((1, B, S, d))) + 0.5).astype(np.float32)
    tparams = _stack([jp])
    T = B * S
    C = M.capacity(cfg, T)
    probs, _, top_e = M.route(tparams["router"], torch.from_numpy(x).reshape(1, 1, T, d), top_k)
    assert torch.equal(probs[..., 1], probs[..., 2])   # the tie is real
    jprobs = jax.nn.softmax(jnp.asarray(x.reshape(T, d)) @ jp["router"], axis=-1)
    jtop_p, jtop_e = jax.lax.top_k(jprobs, top_k)
    np.testing.assert_array_equal(top_e[0, 0].numpy(), np.asarray(jtop_e))
    assert (top_e == 1).sum() == T and (top_e == 2).sum() == 0 and C < T
    slot, keep, _, _ = JM._dispatch_tables(jtop_e, jtop_p, T, top_k, E, C)
    order = np.argsort(np.asarray(jtop_e).reshape(-1), kind="stable")
    want = np.empty(T * top_k, np.int64)
    want[order] = np.asarray(slot)
    got = M.dispatch_slots(top_e, E, C)[0, 0].numpy()
    np.testing.assert_array_equal(got, want)
    # expert 1 (and at top 2 expert 0) takes every token and keeps C of them
    assert (got == E * C).sum() == (~np.asarray(keep)).sum() == top_k * (T - C)
    y, _ = M.moe_apply(tparams, torch.from_numpy(x), cfg)
    jy, _ = JM.moe_apply(jp, jnp.asarray(x[0]), jcfg)
    np.testing.assert_allclose(y[0].numpy(), np.asarray(jy), atol=3e-5)


@pytest.mark.parametrize("variant", ["capacity-1.25", "capacity-0.25", "shared-1"])
def test_moe_gradients_match_jax(variant):
    """Gradients of ``sum(y**2) + aux`` in x and in every leaf, each lane
    against ``jax.grad`` on its slice, at 5e-5."""
    kw, dropless = VARIANTS[variant]
    jcfg, cfg = _cfgs(**kw)
    jparams, x = _layer(jcfg)
    tparams = interop.tree_map(lambda t: t.requires_grad_(True), _stack(jparams))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = M.moe_apply(tparams, tx, cfg)
    leaves = interop.tree_leaves(tparams)
    grads = torch.autograd.grad((y ** 2).sum() + aux.sum(), [tx] + leaves)

    def jloss(p, xi):
        jy, ja = JM.moe_apply(p, xi, jcfg)
        return (jy ** 2).sum() + ja

    for i in range(K):
        gp, gx = jax.grad(jloss, argnums=(0, 1))(jparams[i], jnp.asarray(x[i]))
        np.testing.assert_allclose(grads[0][i].numpy(), np.asarray(gx), atol=5e-5, rtol=5e-5)
        for g, w in zip(grads[1:], jax.tree.leaves(gp)):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), atol=5e-5, rtol=5e-5)


def test_interop_round_trip_moe_population_state():
    """A bf16 qwen3-moe population state with shared experts: the fp32
    router (and its moments) and the bf16 experts survive numpy -> port
    tensors -> numpy bit for bit, each leaf in its own dtype."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), param_dtype="bfloat16",
                               compute_dtype="bfloat16", n_shared_experts=1)
    pstate = jax.device_get(JP.init_population_state(
        jax.random.PRNGKey(0), JaxTrainConfig(model=jcfg), 3))
    tstate = interop.to_torch(pstate)
    ffn = tstate["inner"]["params"]["blocks"]["l0"]["ffn"]
    E, d = jcfg.n_experts, jcfg.d_model
    assert ffn["router"].shape == (3, jcfg.n_superblocks, d, E)
    assert ffn["router"].dtype == torch.float32
    assert tstate["inner"]["opt"]["mu"]["blocks"]["l0"]["ffn"]["router"].dtype == torch.float32
    assert ffn["wi"].dtype == ffn["shared"]["wi"].dtype == torch.bfloat16
    back = interop.to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(pstate), interop.tree_leaves(back)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32) if a.dtype.name == "bfloat16"
                                      else a, b)


# -------------------------------------------------------------------- the models
MODELS = [(ARCH, 0), (JAMBA, 0), (ARCH, 2)]
MODEL_IDS = [ARCH, JAMBA, ARCH + "-microbatch"]


def _train_configs(arch, mb=0):
    jtc = JaxTrainConfig(model=jax_smoke_config(arch),
                         parallel=JaxParallelConfig(remat="none", microbatch=mb))
    tc = TrainConfig(model=get_smoke_config(arch),
                     parallel=ParallelConfig(remat="none", microbatch=mb))
    return jtc, tc


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch,mb", MODELS, ids=MODEL_IDS)
def test_train_step_three_steps_match_jax(arch, mb):
    """Three steps of ``make_hparam_train_step`` (K=1, weight decay 0.1):
    losses (which include the aux loss), ``aux_loss``, gradient norms and
    parameters within 1e-4 of JAX; with ``microbatch`` the metrics are
    microbatch means, as in JAX."""
    jtc, tc = _train_configs(arch, mb)
    data = SyntheticLM(tc.model.vocab_size, 16, 4, seed=0)
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
        assert m["aux_loss"].shape == (1,) and float(m["aux_loss"][0]) > 0
        for key in ("loss", "aux_loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key][0]), float(jm[key]), atol=1e-4, rtol=1e-4,
                                       err_msg=key)
    assert int(state["opt"]["step"][0]) == int(jstate["opt"]["step"]) == STEPS
    _assert_tree_close(interop.tree_map(lambda t: t[0], state["params"]),
                       jstate["params"], 1e-4)


@pytest.mark.parametrize("arch", [ARCH, JAMBA])
def test_population_step_matches_jax(arch):
    """A K=4 population step: per-lane init and hyperparameters, a 0-budget
    lane and a lane whose first router is NaN (every probability NaN, its
    experts still in range).  last_loss, the divergence latch, step counters
    and parameters match JAX at 1e-4; the frozen lanes keep their state bit
    for bit; the live lanes' aux_loss matches JAX's."""
    jtc, tc = _train_configs(arch)
    budgets = [STEPS, 2, 0, STEPS]
    keys = jax.random.split(jax.random.PRNGKey(0), len(budgets))
    jp = JP.init_population_state_from_keys(keys, jtc)
    blocks = jp["inner"]["params"]["blocks"]
    moe = next(n for n in sorted(blocks) if "router" in blocks[n].get("ffn", {}))
    blocks[moe]["ffn"]["router"] = blocks[moe]["ffn"]["router"].at[3].set(jnp.nan)
    cfgs = [dict(LANES[i % len(LANES)], total_steps=b) for i, b in enumerate(budgets)]
    jhp = jax_stack_hparams([jax_hparams_from_dict(c, jtc) for c in cfgs])
    hp = stack_hparams([hparams_from_dict(c, tc) for c in cfgs])
    tp = interop.to_torch(jax.device_get(jp))
    init = interop.to_numpy(tp)
    data = SyntheticLM(tc.model.vocab_size, 16, 2, seed=0)
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
        assert not bool(torch.isfinite(m["aux_loss"][3]))
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


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_cli_matches_jax_cli(monkeypatch, capsys):
    """``--arch qwen3-moe-30b-a3b --vectorize 2``: the same engine and best
    config as the JAX CLI and a best score within 1e-4; the port's trials
    start from the JAX init weights."""
    jtc = JaxTrainConfig(model=jax_smoke_config(ARCH))
    state = jax.device_get(jax_init_train_state(jax.random.PRNGKey(0), jtc))
    monkeypatch.setattr(ts, "init_train_state",
                        lambda gen, tc, device: interop.to_torch(state, device))
    want = _run(jax_hpo.main, BASE, capsys)
    got = _run(hpo.main, BASE + ["--device", "cpu"], capsys)
    assert got["arch"] == want["arch"] == ARCH
    assert got["engine"] == want["engine"] == "vmapped"
    assert got["best_config"] == want["best_config"]
    np.testing.assert_allclose(got["best_score"], want["best_score"], atol=1e-4, rtol=1e-4)


# every sample of the run in one flight: the vectorized manager flushes a
# partial population when a slot comes back with jobs buffered, so with
# fewer lanes than samples the flights' fill follows the timing of the
# flight worker's reports (the JAX package's manager does the same)
ONE_FLIGHT = BASE[:3] + ["4"] + BASE[4:-1] + ["4", "--device", "cpu"]


def _chunked_against_per_step(capsys):
    per_step = _run(hpo.main, ONE_FLIGHT + ["--chunk-steps", "1"], capsys)
    chunked = _run(hpo.main, ONE_FLIGHT + ["--chunk-steps", "4"], capsys)
    assert chunked["engine"] == "vmapped+chunked"
    assert chunked["best_score"] == per_step["best_score"]
    assert chunked["best_config"] == per_step["best_config"]
    assert chunked["trained_steps"] == per_step["trained_steps"]
    assert chunked["device_dispatches"] < per_step["device_dispatches"]


def test_cli_chunked_equals_per_step_bitwise(capsys):
    """Inside the port ``--chunk-steps 4`` and ``1`` give the same best score
    bit for bit on qwen3-moe, with fewer dispatches chunked (4 samples on 4
    lanes: one flight each, whatever the host's load)."""
    _chunked_against_per_step(capsys)


def test_cli_chunked_equals_per_step_when_jobs_report_late(monkeypatch, capsys):
    """The same comparison with every flight's odd jobs reported 0.3 s late,
    as a loaded host may order them: the one flight's fill does not move."""
    report = Experiment._on_job_done

    def late(self, job):
        if job.job_id % 2:
            time.sleep(0.3)
        report(self, job)

    monkeypatch.setattr(Experiment, "_on_job_done", late)
    _chunked_against_per_step(capsys)


# -------------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the layer's determinism is a property of the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _fwd_bwd_bits(params, x, cfg):
    """y, aux and the gradients of ``sum(y**2) + aux`` in x and every leaf,
    as raw integer bits."""
    leaves = [t.detach().requires_grad_(True) for t in interop.tree_leaves(params)]
    xx = x.detach().requires_grad_(True)
    y, aux = M.moe_apply(interop.tree_unflatten(params, leaves), xx, cfg)
    grads = torch.autograd.grad((y.float() ** 2).sum() + aux.sum(), [xx] + leaves)
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return [t.detach().view(bits[t.dtype]) for t in [y, aux] + list(grads)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_is_deterministic_and_lane_independent_on_the_card(cuda, dtype):
    """One MoE layer at smoke size with drops (capacity 0.25): forward and
    backward run twice give raw-bit-equal y, aux and gradients, and the same
    inputs in lane 0 and in lane 1 give the same bits in each lane."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), capacity_factor=0.25,
                              param_dtype=dtype, compute_dtype=dtype)
    one = M.moe_init(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    params = interop.tree_map(lambda t: t[None].expand((2,) + t.shape).contiguous(), one)
    x = np.random.default_rng(0).standard_normal((1, B, S, cfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x).to(cuda, getattr(torch, dtype)).expand(2, -1, -1, -1)
    tx = tx.contiguous()
    first = _fwd_bwd_bits(params, tx, cfg)
    again = _fwd_bwd_bits(params, tx, cfg)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(t[0], t[1]) for t in first)
    assert _dropped(params, tx, cfg) > 0
