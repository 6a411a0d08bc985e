"""The port's dry run (``launch/dryrun.py``, ``op_cost.py``, ``op_stats.py``,
``roofline.py``, ``mesh.py::make_production_mesh``) against the JAX
package's, on the CPU.

JAX's own ``lower_cell`` raises on this JAX (``make_production_mesh`` gives
``Explicit`` axes, and ``sharding_context``'s constraints may name only
``Auto`` ones), so the oracle is JAX's pieces on an ``Auto``-axes mesh that
the test builds itself: ``make_train_step`` under ``sharding_context``,
lowered and compiled over the 8 virtual CPU devices, read by
``memory_analysis()`` and ``hlo_cost.analyse_hlo``.  Held here:

* the wire factors are JAX's ``_wire_factor`` for every op and n in 1..512,
  and ``roofline.analyse`` at JAX's constants is JAX's, field by field;
* on the production meshes (a fake process group of 256 and 512 ranks),
  every leaf of every arch's full-width train state (FSDP and ZeRO-1) and
  decode cache (``decode_32k``, ``long_500k``) is placed as JAX's
  ``build_pspec`` places it, so a rank's state bytes are JAX's exactly;
* at (2, 4) the port's per-rank state bytes equal JAX's per-device
  argument bytes less the batch shard (the port's step takes the whole
  batch); at (8, 1) the FLOPs equal JAX's within 2% once the two terms
  that differ by design are taken out by name: the flash forward kernel
  counts the causal half of the scores where JAX's reference attention
  computes them all, and the flash backward kernel (its causal half too)
  recomputes the scores from ``lse`` where JAX's autodiff keeps them (one
  product a layer and pass).
  At (2, 4) JAX's ``Auto`` partitioner also splits the tokens over the
  model axis, a layout the port does not take (its model ranks split the
  weights), so the FLOPs are compared at (8, 1), where the two agree;
* the fake-group walk of a (2, 2) step counts the collectives, by axis, op
  and bytes, that four gloo ranks make running it; a model axis of one
  rank makes no model-axis collective;
* the CLI writes a full-width record and a skipped cell's record;
* the new modules import neither JAX nor the JAX package.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_mesh_ranks as R
from jax.sharding import AxisType, NamedSharding, PartitionSpec
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import memory_policy as jax_memory_policy
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.distributed import sharding as JS
from repro.launch import hlo_cost, hlo_stats
from repro.launch import roofline as jax_roofline
from repro.models import transformer as JT
from repro.train import train_step as jts
from repro_torch.configs import ARCH_IDS, cells, get_config, get_smoke_config, memory_policy
from repro_torch.configs.base import SHAPES, ShapeConfig, TrainConfig
from repro_torch.launch import dryrun, op_stats, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train.serve_step import ServeLayout
from repro_torch.train.train_step import TrialLayout
from test_torch_hpo import _imports
from test_torch_sharded import COLLECTIVE_S, _join, _start

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMOKE = "starcoder2-3b"
SMOKE_SHAPE = ShapeConfig("smoke_train", 32, 8, "train")


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, path + (i,)).items()}
    return {path: tuple(tree)}


# ------------------------------------------------------------- the formulas
def test_wire_factors_are_jax_s():
    for op in hlo_stats.COLLECTIVES:
        for n in range(1, 513):
            assert op_stats._wire_factor(op, n) == hlo_stats._wire_factor(op, n), (op, n)
    assert op_stats.COLLECTIVES == hlo_stats.COLLECTIVES


def test_roofline_at_jax_constants_is_jax_s():
    rng = np.random.default_rng(7)
    for kind in ("train", "prefill", "decode"):
        for _ in range(4):
            kw = dict(flops_dev=float(rng.uniform(1e9, 1e15)),
                      bytes_bf16eq_dev=float(rng.uniform(1e8, 1e13)),
                      kernel_bytes_bf16eq_dev=float(rng.uniform(0, 1e11)),
                      bytes_raw_dev=float(rng.uniform(1e8, 1e13)),
                      wire_bytes_dev=float(rng.uniform(0, 1e12)),
                      n_params_active=float(rng.uniform(1e8, 1e11)),
                      tokens_global=float(rng.integers(1, 1 << 20)), kind=kind,
                      n_chips=int(rng.choice([1, 256, 512])))
            want = jax_roofline.analyse(**kw).to_json()
            got = roofline.analyse(**kw, peak_flops=jax_roofline.PEAK_FLOPS,
                                   hbm_bw=jax_roofline.HBM_BW,
                                   ici_bw=jax_roofline.ICI_BW).to_json()
            assert got == want


def test_link_rate_is_the_slowest_link_a_group_crosses():
    assert roofline.link_bw([range(8)]) == roofline.NVLINK_BW
    assert roofline.link_bw([range(8), range(0, 256, 16)]) == roofline.IB_BW
    assert roofline.link_bw([range(16)]) == roofline.IB_BW
    assert roofline.IB_BW == 50e9 and roofline.NVLINK_BW == 450e9


# ------------------------------------------------------------- production meshes
def _jax_state_placements(arch, multi_pod, zero1):
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = _FakeMesh(dict(zip(axes, (2, 16, 16) if multi_pod else (16, 16))))
    jtc = JaxTrainConfig(model=jax_config(arch), parallel=jax_memory_policy(
        arch, JAX_SHAPES["train_4k"], multi_pod=multi_pod))
    shapes = jax.eval_shape(lambda k: jts.init_train_state(k, jtc), jax.random.PRNGKey(0))
    rules = JS.make_rules(axes)
    specs = jts.train_state_specs(jtc)

    def place(tree, spec, r):
        return JS.map_specs(tree, spec, lambda leaf, logical: tuple(
            JS.build_pspec(leaf.shape, logical, r, mesh)))

    out = {"params": place(shapes["params"], specs["params"],
                           dict(rules, embed=()) if zero1 else rules),
           "opt": place(shapes["opt"], specs["opt"], rules)}
    return out, shapes, mesh


def _rank_bytes(shapes, placements, mesh):
    """A rank's bytes of a tree of leaves with ``.shape`` and ``.dtype``."""
    total = 0
    flat_p = _flat(placements)
    for path, leaf in _flat_leaves(shapes).items():
        n = int(np.prod(leaf.shape))
        for a in flat_p[path]:
            if a is not None:
                for x in (a,) if isinstance(a, str) else a:
                    n //= mesh.shape[x]
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def _flat_leaves(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat_leaves(tree[key], path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat_leaves(x, path + (i,)).items()}
    return {path: tree}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
def test_production_mesh_places_every_leaf_as_jax(multi_pod):
    """Every arch's full-width train state, FSDP and ZeRO-1, and its decode
    caches: the port's placements on rank 0 of the production mesh equal
    JAX's ``build_pspec`` on a mesh of the same shape, leaf by leaf, and a
    rank's state bytes are JAX's exactly."""
    n = 512 if multi_pod else 256
    with dryrun.fake_group(n):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.shape == dict(zip(mesh.axis_names, (2, 16, 16) if multi_pod else (16, 16)))
        for arch in ARCH_IDS:
            for zero1 in (False, True):
                pc = dataclasses.replace(memory_policy(arch, SHAPES["train_4k"], multi_pod),
                                         zero_stage="zero1" if zero1 else "fsdp")
                layout = TrialLayout(TrainConfig(model=get_config(arch), parallel=pc), mesh)
                want, shapes, jmesh = _jax_state_placements(arch, multi_pod, zero1)
                assert _flat(layout.placements) == _flat(want), (arch, zero1)
                ours = _rank_bytes(_meta_state(layout), layout.placements, jmesh)
                assert ours == _rank_bytes(shapes, want, jmesh), (arch, zero1)
            cfg = jax_config(arch)
            for shape, skip in cells(arch):
                if shape.kind != "decode" or skip:
                    continue
                layout = ServeLayout(get_config(arch), mesh,
                                     shard_cache_seq=shape.name == "long_500k")
                rules = JS.make_rules(mesh.axis_names,
                                      shard_cache_seq=shape.name == "long_500k")
                cache = jax.eval_shape(lambda: JT.init_cache(cfg, shape.global_batch,
                                                             shape.seq_len, jnp.bfloat16))
                jmesh = _FakeMesh(mesh.shape)
                want = JS.map_specs(cache, JT.cache_specs(cfg), lambda leaf, logical: tuple(
                    JS.build_pspec(leaf.shape, logical, rules, jmesh)))
                got = layout.cache_placements(shape.global_batch, shape.seq_len)
                assert _flat(got) == _flat(want), (arch, shape.name)


def _meta_state(layout):
    """The whole train state's leaves as shapes and numpy dtypes (what the
    placements cut)."""
    from repro_torch.interop import tree_map
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import init_opt_state

    params = T.init_params(torch.Generator(), layout.tc.model, "meta")
    state = {"params": params, "opt": init_opt_state(params, layout.tc)}
    dt = {torch.float32: np.float32, torch.bfloat16: jnp.bfloat16, torch.int32: np.int32}
    return tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), dt[t.dtype]), state)


# ------------------------------------------------------------- against JAX's compile
def _jax_compiled(shape):
    cfg = jax_smoke_config(SMOKE)
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    tc = JaxTrainConfig(model=cfg, parallel=JaxParallelConfig(remat="full", mesh_shape=shape))
    rules = JS.make_rules(("data", "model"))
    state = jax.eval_shape(functools.partial(jts.init_train_state, tc=tc),
                           jax.ShapeDtypeStruct((2,), jnp.uint32))
    state_sh = JS.build_sharding(state, jts.train_state_specs(tc), rules, mesh)
    B, S = SMOKE_SHAPE.global_batch, SMOKE_SHAPE.seq_len
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "targets": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "mask": jax.ShapeDtypeStruct((B, S), jnp.float32)}
    batch_sh = jax.tree.map(lambda s: NamedSharding(mesh, JS.build_pspec(
        s.shape, ["batch", None], rules, mesh)), batch)
    step = jts.make_train_step(tc)

    def fn(st, b):
        with JS.sharding_context(mesh, rules):
            return step(st, b)

    compiled = jax.jit(fn, in_shardings=(state_sh, batch_sh),
                       out_shardings=(state_sh, NamedSharding(mesh, PartitionSpec())),
                       donate_argnums=(0,)).lower(state, batch).compile()
    shard_rows = B // shape[0]
    return (compiled.memory_analysis().argument_size_in_bytes,
            hlo_cost.analyse_hlo(compiled.as_text(), default_group=8).flops,
            shard_rows * S * (4 + 4 + 4))


def _port_cell(mesh_shape):
    return dryrun.lower_cell(SMOKE, shape=SMOKE_SHAPE, mesh_shape=mesh_shape,
                             model=get_smoke_config(SMOKE))


@pytest.mark.parametrize("shape", [(2, 4), (8, 1)])
def test_state_bytes_match_jax_s_arguments(shape):
    jax_args, _, jax_batch = _jax_compiled(shape)
    got = _port_cell(shape)
    B, S = SMOKE_SHAPE.global_batch, SMOKE_SHAPE.seq_len
    state = got["memory_analysis"]["argument_size_in_bytes"] - B * S * 12
    assert state == jax_args - jax_batch
    assert got["memory_analysis"]["alias_size_in_bytes"] == state   # updated in place


def test_flops_match_jax_s_less_the_terms_that_differ_by_design():
    """At (8, 1): the port's dot FLOPs plus its flash kernels' (forward and
    backward), with the scores' causal half restored in both and the
    backward's recompute of the scores taken out, within 2% of JAX's
    ``analyse_hlo`` FLOPs (the RMSNorm kernels' elementwise operations are
    not counted, as JAX counts no elementwise FLOPs)."""
    _, jax_flops, _ = _jax_compiled((8, 1))
    got = _port_cell((8, 1))
    oc = got["op_cost"]
    cfg = get_smoke_config(SMOKE)
    rows, S = SMOKE_SHAPE.global_batch // 8, SMOKE_SHAPE.seq_len
    H, D = cfg.n_heads, cfg.resolved_head_dim
    layers = cfg.n_layers
    flash = oc["kernels"]["flash_attention"]
    bwd = oc["kernels"]["flash_attention_bwd"]
    assert flash["launches"] == 2 * layers     # forward and remat recompute
    assert bwd["launches"] == layers
    full = 2 * rows * H * S * S * (D + D)       # one forward's scores and mix, every pair
    full_bwd = 2 * rows * H * S * S * (3 * D + 2 * D)   # the backward's five products
    recompute = 2 * rows * H * S * S * D        # the backward's scores from lse
    port = oc["dot_flops"] + flash["flops"] + (flash["launches"] * full - flash["flops"]) \
        + bwd["flops"] + (bwd["launches"] * full_bwd - bwd["flops"]) - layers * recompute
    assert abs(port - jax_flops) <= 0.02 * jax_flops, (port, jax_flops)


# ------------------------------------------------------------- collectives
@pytest.fixture(scope="module")
def gloo_collectives(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun_coll")
    procs = _start(4, str(root), R.collective_rank, SMOKE, (2, 2), SMOKE_SHAPE.seq_len,
                   SMOKE_SHAPE.global_batch, COLLECTIVE_S)
    return _join(procs, str(root), 240.0)


def test_fake_group_walk_counts_the_collectives_of_gloo_ranks(gloo_collectives):
    got = _port_cell((2, 2))["op_cost"]["collectives_by_axis"]
    want = gloo_collectives[0]
    assert set(got) == set(want) and got
    for k in want:
        assert got[k]["count"] == want[k]["count"], k
        assert got[k]["operand_bytes"] == want[k]["operand_bytes"], k
        assert got[k]["wire_bytes"] == pytest.approx(want[k]["wire_bytes"], rel=1e-12), k
    assert all(g == want for g in gloo_collectives)   # every rank makes the same ones


def test_a_model_axis_of_one_rank_makes_no_model_collective():
    one = _port_cell((4, 1))["op_cost"]["collectives_by_axis"]
    two = _port_cell((1, 2))["op_cost"]["collectives_by_axis"]
    assert not any(k.startswith("model/") for k in one) and one
    assert sum(v["count"] for k, v in two.items() if k.startswith("model/")) > 0


# ------------------------------------------------------------- the CLI
def test_cli_writes_a_full_width_record_and_a_skipped_one(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch, shape in (("starcoder2-3b", "decode_32k"), ("hubert-xlarge", "decode_32k")):
        subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", shape, "--out", str(tmp_path)], check=True, env=env,
                       cwd=ROOT, timeout=120, capture_output=True)
    rec = json.loads((tmp_path / "pod_16x16" / "starcoder2-3b__decode_32k.json").read_text())
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    assert rec["mesh"] == {"shape": [16, 16], "axes": ["data", "model"]}
    for key in ("memory_analysis", "op_cost", "roofline", "param_counts", "trace_s", "fits"):
        assert key in rec
    rl = rec["roofline"]
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert rl["memory_s"] == rl["memory_unadjusted_s"] and rl["kernel_bytes_dev"] == 0
    assert rec["link_bytes_per_s"] == roofline.IB_BW
    assert rec["op_cost"]["kernels"]["rmsnorm"]["launches"] == 2 * 30 + 1
    assert rec["memory_analysis"]["alias_size_in_bytes"] > 0   # the cache, in place
    skip = json.loads((tmp_path / "pod_16x16" / "hubert-xlarge__decode_32k.json").read_text())
    assert skip["status"] == "skipped" and "encoder-only" in skip["reason"]
    assert {s.name for s in JAX_SHAPES.values()} == {s.name for s, _ in cells("starcoder2-3b")}


def test_the_new_modules_import_neither_jax_nor_the_jax_package():
    files = [ROOT / "src" / "repro_torch" / p for p in (
        "launch/dryrun.py", "launch/op_cost.py", "launch/op_stats.py", "launch/roofline.py",
        "launch/mesh.py", "kernels/walk.py", "train/serve_step.py")]
    for f in files:
        assert f.exists()
        assert not [m for m in _imports(f)
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "repro")], f
