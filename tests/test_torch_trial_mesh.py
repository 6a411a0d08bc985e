"""The trial mesh (``launch/train.py --devices N``) on the CPU, over gloo.

One trial over a ``(data, model)`` grid of spawned ranks (bodies in
``torch_mesh_ranks.py``, a ``file://`` store, a join deadline each).  Held
here:

* ``trial_mesh_shape(n)`` is the shape the JAX package's
  ``make_trial_mesh(n)`` asks of ``jax.make_mesh``, n = 1..16;
* ``make_rules`` and ``build_pspec`` equal JAX's on hypothesis shapes and
  logical tuples, and every rank's leaves are stored as JAX's
  ``build_sharding`` of ``train_state_specs`` places them;
* three steps of the sharded step against the port's ``--devices 1`` step
  (``make_train_step``), within 1e-4 (fp32, the loss, every metric, the
  gathered parameters and moments): shapes (1, 2), (2, 2), (1, 3) (where
  everything replicates) and (2, 1); smoke configs starcoder2-3b,
  granite-34b (kv 1: attention gathered), falcon-mamba-7b, qwen3-moe, jamba
  and deepseek-v2-lite (MLA, the expert-parallel MoE, shared experts);
  bf16 parameters under fp32 compute; a microbatch with a clipping
  ``grad_clip``; a batch that does not divide the data axis;
* with more than one data rank the MoE dispatches each data shard's rows
  with its own capacity (JAX's ``_moe_shard_map``), so there the oracle is
  ``--devices 1`` with ``moe_apply`` run on each shard's rows and the
  load-balancing loss averaged over the shards (JAX's ``pmean``);
* a data rank reads the global batch's rows, not ``make_batch(shard=)``'s;
* ZeRO-1 (``zero_stage="zero1"``: the parameters whole over the data axis,
  the gradients reduce-scattered and the parameters all-gathered once a
  step) against ``--devices 1`` within the same 1e-4; with microbatches it
  rounds the gradient once, after their sum, as ``--devices 1`` does for
  the whole batch as one microbatch, which is its oracle there;
* the gradient before its rounding against the unsharded one within 1e-6,
  and the rounded gradients equal on at least 99.9% of elements.
"""
import numpy as np
import pytest
import torch

import jax
import torch_mesh_ranks as R
from repro_torch.distributed import sharding as S
from repro_torch.interop import tree_leaves
from repro_torch.launch.mesh import trial_mesh_shape
from repro_torch.models import moe as moem
from repro_torch.train import train_step as ts
from test_torch_sharded import COLLECTIVE_S, _join, _start

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4


def _case(name, arch, shape, batch=4, **kw):
    return dict(name=name, arch=arch, shape=shape, batch=batch, **kw)


# (world, cases): one spawn of ranks a world
WORLDS = {
    2: [_case("sc2-12", "starcoder2-3b", (1, 2)),
        _case("granite-12", "granite-34b", (1, 2)),
        _case("mamba-12", "falcon-mamba-7b", (1, 2)),
        _case("qwen3-12", "qwen3-moe-30b-a3b", (1, 2)),
        _case("jamba-12", "jamba-1.5-large-398b", (1, 2)),
        _case("deepseek-12", "deepseek-v2-lite-16b", (1, 2)),
        _case("bf16-12", "starcoder2-3b", (1, 2), model={"param_dtype": "bfloat16"}),
        _case("sc2-21", "starcoder2-3b", (2, 1), rows=True, raw_grads=True),
        _case("mb-clip-21", "starcoder2-3b", (2, 1), parallel={"microbatch": 2},
              train={"grad_clip": 0.05}),
        _case("odd-batch-21", "starcoder2-3b", (2, 1), batch=3),
        _case("deepseek-21", "deepseek-v2-lite-16b", (2, 1)),
        _case("zero1-21", "starcoder2-3b", (2, 1), parallel={"zero_stage": "zero1"}),
        _case("zero1-mb-21", "starcoder2-3b", (2, 1),
              parallel={"zero_stage": "zero1", "microbatch": 2},
              oracle_parallel={"microbatch": 0})],
    3: [_case("sc2-13", "starcoder2-3b", (1, 3))],
    4: [_case("sc2-22", "starcoder2-3b", (2, 2)),
        _case("granite-22", "granite-34b", (2, 2)),
        _case("mamba-22", "falcon-mamba-7b", (2, 2)),
        _case("qwen3-22", "qwen3-moe-30b-a3b", (2, 2)),
        _case("jamba-22", "jamba-1.5-large-398b", (2, 2)),
        _case("deepseek-22", "deepseek-v2-lite-16b", (2, 2), raw_grads=True),
        _case("zero1-22", "starcoder2-3b", (2, 2), parallel={"zero_stage": "zero1"})],
}
CASES = {c["name"]: (w, c) for w, cs in WORLDS.items() for c in cs}
JOIN_S = 240.0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every world's ranks, started at once, then joined: name -> each
    rank's result of that case."""
    started = {}
    for world, cases in WORLDS.items():
        root = tmp_path_factory.mktemp(f"trial{world}")
        started[world] = (_start(world, str(root), R.trial_rank, cases, COLLECTIVE_S), root)
    out = {}
    for world, (procs, root) in started.items():
        got = _join(procs, str(root), JOIN_S)
        for c in WORLDS[world]:
            out[c["name"]] = [g[c["name"]] for g in got]
    return out


def _per_shard_moe(n_data):
    """``moe_apply`` on each of ``n_data`` shards of the rows, the
    load-balancing loss averaged over them: the JAX package's
    ``_moe_shard_map`` over a data axis, built from the plain layer."""
    plain = moem.moe_apply

    def apply(p, x, cfg, *, dropless=False):
        outs = [plain(p, xi, cfg, dropless=dropless) for xi in x.chunk(n_data, dim=1)]
        return torch.cat([y for y, _ in outs], 1), sum(a for _, a in outs) / n_data

    return apply


def _reference(case, monkeypatch):
    """``--devices 1`` on the case's trial: the state after three steps and
    each step's metrics (the MoE per data shard where the case splits rows
    over more than one data rank)."""
    tc = R.trial_tc(case["arch"], case.get("model"),
                    case.get("oracle_parallel", case.get("parallel")), **case.get("train", {}))
    n_data = case["shape"][0]
    rows = tc.parallel.microbatch or case["batch"]
    if tc.model.has_moe and n_data > 1 and rows % n_data == 0:
        monkeypatch.setattr(moem, "moe_apply", _per_shard_moe(n_data))
    state = ts.init_train_state(torch.Generator().manual_seed(0), tc, "cpu")
    batches = R.trial_batches(tc, case["batch"])
    return tc, batches, R.trial_run(ts.make_train_step(tc), state, batches)


def _assert_close(got, want, tol, what):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, what
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=tol, rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_one_device(name, ranks, monkeypatch):
    """Three steps on the mesh against ``--devices 1``: every metric and
    every leaf of the gathered state within 1e-4."""
    world, case = CASES[name]
    _, _, (state, metrics) = _reference(case, monkeypatch)
    got = ranks[name][0]
    for a, b in zip(got["metrics"], metrics):
        assert sorted(a) == sorted(b)
        for k in b:
            assert abs(a[k] - b[k]) <= TOL, (name, k, a[k], b[k])
    _assert_close(got["state"], state, TOL, name)
    for r in ranks[name][1:]:   # every rank's metrics are the all-reduced ones
        assert r["metrics"] == got["metrics"]


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith(("sc2", "deepseek"))])
def test_every_rank_stores_the_blocks_jax_places(name, ranks):
    """The placements are the JAX package's ``build_sharding`` of
    ``train_state_specs`` under ``make_rules(("data", "model"))``, and each
    rank's blocks are the whole leaves cut by them."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.distributed import sharding as JS
    from repro.train.train_step import init_train_state, train_state_specs

    world, case = CASES[name]
    d, m = case["shape"]
    mesh = _FakeMesh({"data": d, "model": m})
    jtc = JaxTrainConfig(model=jax_smoke_config(case["arch"]))
    shapes = jax.eval_shape(lambda k: init_train_state(k, jtc), jax.random.PRNGKey(0))
    rules = JS.make_rules(("data", "model"))
    want = JS.map_specs(shapes, train_state_specs(jtc), lambda leaf, logical: tuple(
        JS.build_pspec(leaf.shape, logical, rules, mesh)))
    got = ranks[name]
    assert _flat(got[0]["placements"]) == _flat(want)
    whole = [tuple(t.shape) for t in tree_leaves(got[0]["state"])]
    places = [p for _, p in sorted(_flat(got[0]["placements"]).items())]
    for r, g in enumerate(got):
        cut = [tuple(n // ({"data": d, "model": m}[p[i]] if p[i] else 1)
                     for i, n in enumerate(shape)) for shape, p in zip(whole, places)]
        assert g["blocks"] == cut, r


def test_data_ranks_read_the_global_batch_rows(ranks):
    """At (2, 1) data rank r's loss reads rows [2r, 2r + 2) of the global
    batch (JAX feeds the global batch and lets GSPMD split it); shard 1 of
    ``make_batch(shard=1, n_shards=2)`` is another batch."""
    from repro_torch.data.pipeline import SyntheticLM

    _, case = CASES["sc2-21"]
    tc = R.trial_tc(case["arch"])
    data = SyntheticLM(tc.model.vocab_size, R.TRIAL_SEQ, case["batch"], seed=0)
    for r, got in enumerate(ranks["sc2-21"]):
        assert len(got["rows"]) == R.TRIAL_STEPS
        for t, rows in enumerate(got["rows"]):
            glob = torch.as_tensor(data.make_batch(t)["tokens"])
            assert torch.equal(rows, glob[2 * r:2 * r + 2])
    shard = torch.as_tensor(data.make_batch(0, shard=1, n_shards=2)["tokens"])
    assert not torch.equal(ranks["sc2-21"][1]["rows"][0], shard)


@pytest.mark.parametrize("name", ["sc2-21", "deepseek-22"])
def test_gradient_before_rounding_matches_one_device(name, ranks, monkeypatch):
    """The first batch's gradient, summed over the data ranks and gathered,
    before its rounding to ``grad_allreduce_dtype``: within 1e-6 of the
    unsharded gradient; rounded to bf16, equal on >= 99.9% of elements."""
    world, case = CASES[name]
    tc, batches, _ = _reference(case, monkeypatch)
    state = ts.init_train_state(torch.Generator().manual_seed(0), tc, "cpu")
    lane = {k: torch.as_tensor(v)[None] for k, v in batches[0].items()}
    _, want = ts._value_and_grad(ts.add_lane_axis(state["params"]), lane, tc)
    got = ranks[name][0]["raw_grads"]
    n_equal = n = 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        b = b[0]
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0, err_msg=name)
        n_equal += int((a.to(torch.bfloat16) == b.to(torch.bfloat16)).sum())
        n += a.numel()
    assert n_equal >= 0.999 * n, (n_equal, n)


# -- the arithmetic, against the JAX functions -------------------------------------------


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, path + (i,)).items()}
    return {path: tuple(tree)}


def test_trial_mesh_shape_is_jax_make_trial_mesh(monkeypatch):
    """For n = 1..16 the shape ``make_trial_mesh(n)`` asks of
    ``jax.make_mesh`` (patched here to return it)."""
    from repro.launch import mesh as jax_mesh

    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes, devices=None: tuple(shape))
    for n in range(1, 17):
        assert trial_mesh_shape(n) == jax_mesh.make_trial_mesh(n, devices=[None] * n), n
    assert trial_mesh_shape(2) == (1, 2) and trial_mesh_shape(4) == (2, 2)
    assert trial_mesh_shape(3) == (1, 3) and trial_mesh_shape(8) == (2, 4)


LOGICAL = ["batch", "embed", "vocab", "heads", "kv_heads", "ff", "moe_ff", "expert", "inner",
           "head", "act_seq", "act_seq_attn", "act_embed", "cache_seq", None]


@settings(max_examples=200, deadline=None)
@given(dims=st.lists(st.tuples(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 24, 48, 64]),
                               st.sampled_from(LOGICAL)), min_size=1, max_size=4),
       mesh=st.sampled_from([(1, 1), (1, 2), (2, 1), (2, 2), (1, 3), (2, 4), (4, 4)]),
       pod=st.booleans(), cache=st.booleans())
def test_rules_and_pspec_match_jax(dims, mesh, pod, cache):
    from repro.distributed import sharding as JS

    axes = (("pod",) if pod else ()) + ("data", "model")
    shape = dict(zip(axes, ((2,) if pod else ()) + mesh))
    assert S.make_rules(axes, shard_cache_seq=cache) == JS.make_rules(
        axes, shard_cache_seq=cache)
    rules = S.make_rules(axes, shard_cache_seq=cache)
    sizes, logical = zip(*dims)
    fake = _FakeMesh(shape)
    assert S.build_pspec(sizes, logical, rules, fake) == tuple(
        JS.build_pspec(sizes, logical, rules, fake))


RULES = S.make_rules(("data", "model"))
MESH = _FakeMesh({"data": 16, "model": 16})


def test_heads_take_priority_over_seq():
    spec = S.build_pspec((32, 4096, 16, 128), ("batch", "act_seq_attn", "heads", None),
                         RULES, MESH)
    assert spec == ("data", None, "model", None)
    # non-divisible heads (starcoder2's 24): the Ulysses fallback takes the model axis
    spec = S.build_pspec((32, 4096, 24, 128), ("batch", "act_seq_attn", "heads", None),
                         RULES, MESH)
    assert spec == ("data", "model", None, None)


def test_fsdp_weight_spec():
    assert S.build_pspec((3072, 24, 128), ("embed", "heads", "head"), RULES, MESH) == (
        "data", None, None)
    assert S.build_pspec((3072, 12288), ("embed", "ff"), RULES, MESH) == ("data", "model")


def test_multipod_rules_fold_pod_axis():
    rules = S.make_rules(("pod", "data", "model"))
    mesh = _FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert S.build_pspec((256, 4096), ("batch", None), rules, mesh) == (("pod", "data"), None)
    assert S.build_pspec((8192, 24576), ("embed", "ff"), rules, mesh) == (
        ("pod", "data"), "model")
