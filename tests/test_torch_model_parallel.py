"""The two-level ``(pop, model)`` population mesh (``--shard-population
--model-parallel W``) on the CPU, over gloo.

Ranks are spawned as in ``tests/test_torch_sharded.py`` (bodies in
``torch_mesh_ranks.py``, a ``file://`` store, a join deadline each).  Held
here, against the JAX package and the port's vmapped engine:

* ``tp_width_rules``, ``tp_module_flags`` and ``tp_gnorm_mask`` equal JAX's
  for every arch under ``configs/`` (published and smoke) at widths 1, 2
  and 4; ``param_specs``, ``cache_specs`` and ``train_state_specs`` give
  JAX's logical-name trees;
* the seams on 2 ranks: a column- then row-parallel MLP, and one GQA, MLA
  and Mamba layer, at width 2 against width 1 on the same weights (built by
  JAX, carried through numpy): the output and every gradient within 1e-6
  of the tensor's largest magnitude (fp32);
* the JAX engine matrix's ``TP_CELLS`` (``tp2-perstep-host``,
  ``tp2-chunked-host``, ``tp2-chunked-device`` on 2 rows of 2 ranks,
  ``tp4-perstep-host`` on 1 row of 4) in the batch and streaming protocols
  against the vmapped cells: scores within 1e-6, the same truncations,
  reclaims, steps and divergences; width 2 against width 4 within 1e-6;
  two cells against JAX's two-level engine on its virtual mesh within 1e-4;
* the same width-2 cells for deepseek-v2-lite (MLA heads shard, experts
  replicated) and falcon-mamba (inner channels shard);
* after every flight, each replicated leaf of each lane bit-equal across
  the ranks of its row; the RMSNorm backward planned for the rows;
  ``model_axis_collectives`` equal to the count reckoned from the seams;
* the lane ops on a width-2 state across rows, each rank's shards against
  the vmapped lane ops' bit for bit, and a snapshot gathered to the whole
  host layout.
"""
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.distributed import sharding as S
from repro_torch.models import transformer as T
from repro_torch.train import population as P
from repro_torch.train import train_step as ts
from test_torch_sharded import (
    COLLECTIVE_S,
    LANE_OPS,
    _bits_equal,
    _jax,
    _jax_init_state,
    _jax_population,
    _join,
    _start,
    _tc,
    _vmapped_sequence,
)

torch.set_num_threads(2)

WIDTHS = (1, 2, 4)
TP_NAMES = [c[0] for c in R.TP_CELLS]
TP2_NAMES = [c[0] for c in R.TP_CELLS if c[3] == 2]
ARCHS = ("deepseek-v2-lite-16b", "falcon-mamba-7b")


def _jax_modules():
    _jax()
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.distributed import sharding as JS
    from repro.models import transformer as JT

    return jax_config, jax_smoke_config, JS, JT


# -- the width rules and the specs ------------------------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tp_rules_flags_and_gnorm_mask_match_jax(arch, width):
    """The module flags, the width rules and the gradient-norm mask of the
    published and the smoke config equal JAX's."""
    jax_config, jax_smoke_config, JS, JT = _jax_modules()
    for cfg, jcfg in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert S.tp_module_flags(cfg, width) == JS.tp_module_flags(jcfg, width)
        rules, jrules = S.tp_width_rules(cfg, width), JS.tp_width_rules(jcfg, width)
        assert rules == dict(jrules)
        assert S.tp_gnorm_mask(T.param_specs(cfg), rules) == \
            JS.tp_gnorm_mask(JT.param_specs(jcfg), jrules)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_cache_and_train_state_specs_match_jax(arch):
    """``param_specs``, ``cache_specs`` and ``train_state_specs`` (with and
    without the master copy) are JAX's trees of logical names, and each
    spec names every axis of the port's leaf (the lane axis aside)."""
    _, jax_smoke_config, _, JT = _jax_modules()
    from repro.configs.base import ParallelConfig as JaxParallelConfig
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.train import train_step as jts

    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    assert T.param_specs(cfg) == JT.param_specs(jcfg)
    assert T.cache_specs(cfg) == JT.cache_specs(jcfg)
    for master in (None, "float32"):
        tc = TrainConfig(model=cfg, parallel=ParallelConfig(master_dtype=master))
        jtc = JaxTrainConfig(model=jcfg, parallel=JaxParallelConfig(master_dtype=master))
        assert ts.train_state_specs(tc) == jts.train_state_specs(jtc)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert all(interop.tree_leaves(S.map_specs(
        params, T.param_specs(cfg), lambda p, s: p.dim() == len(s))))
    cache = T.init_cache(cfg, 1, 2, 8, torch.float32, "cpu")
    assert all(interop.tree_leaves(S.map_specs(
        cache, T.cache_specs(cfg), lambda c, s: c.dim() == len(s) + 1)))


# -- the seams: one layer at width 2 against width 1 ------------------------------------


def _layer_case(jax, jnp, kind, arch, seed):
    """A layer's parameters (two lanes, JAX inits of two keys), input,
    positions and upstream gradient, fp32."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import attention as JA
    from repro.models import mamba as JM
    from repro.models import mlp as JMLP

    jcfg = jax_smoke_config(arch)
    init = {"mlp": JMLP.mlp_init, "gqa": JA.gqa_init, "mla": JA.mla_init,
            "mamba": JM.mamba_init}[kind]
    lanes = [interop.to_torch(jax.device_get(init(jax.random.PRNGKey(seed + i), jcfg)))
             for i in range(2)]
    params = interop.tree_map(lambda *xs: torch.stack(xs), *lanes)
    rng = np.random.default_rng(seed)
    shape = (2, 2, 8, jcfg.d_model)
    return {"params": params,
            "x": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            "dy": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            "positions": torch.arange(8)}


@pytest.fixture(scope="module")
def seams(tmp_path_factory):
    """Every layer of ``R.SEAM_LAYERS`` on 2 spawned ranks at width 2, and
    its width-1 reference here."""
    jax, jnp = _jax()
    root = tmp_path_factory.mktemp("seams")
    cases = {kind: _layer_case(jax, jnp, kind, arch, 3 + i)
             for i, (kind, arch) in enumerate(R.SEAM_LAYERS)}
    path = str(root / "layers.pt")
    torch.save(cases, path)
    procs = _start(2, str(root), R.seam_rank, path, COLLECTIVE_S)
    ref = {}
    for kind, arch in R.SEAM_LAYERS:
        case = cases[kind]
        params = interop.tree_map(lambda t: t.clone().requires_grad_(True), case["params"])
        x = case["x"].clone().requires_grad_(True)
        y = R.seam_layer(kind, get_smoke_config(arch), params, x, case["positions"])
        (y * case["dy"]).sum().backward()
        ref[kind] = {"y": y.detach(), "dx": x.grad,
                     "grads": interop.tree_map(lambda t: t.grad, params)}
    return {"ref": ref, "ranks": _join(procs, str(root))}


def _close(got, want):
    """Within 1e-6 of the tensor's largest magnitude: the seams add the
    shards' partial sums of a contraction that width 1 sums whole, so the
    two round apart by a few ulps of its terms."""
    scale = max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6 * scale)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("kind,arch", R.SEAM_LAYERS)
def test_seams_give_width_1_output_and_gradients(seams, kind, arch):
    """A layer at width 2 (the rank's shards of the weights, the seams
    armed) against width 1: on both ranks the output and the input's
    gradient, and every parameter's gradient (the shards joined, a
    replicated parameter's whole on each rank), within 1e-6."""
    ref, ranks = seams["ref"][kind], [r[kind] for r in seams["ranks"]]
    dims = R.shard_dims(kind, get_smoke_config(arch), 2)
    for got in ranks:
        _close(got["y"], ref["y"])
        _close(got["dx"], ref["dx"])
    n_sharded = 0
    for name_path, d in _flat(dims):
        want = _at(ref["grads"], name_path)
        shards = [_at(r["grads"], name_path) for r in ranks]
        if d is None:
            for s in shards:
                _close(s, want)
        else:
            n_sharded += 1
            _close(torch.cat(shards, d), want)
    assert n_sharded > 0


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# -- the engine matrix's tensor-parallel cells ------------------------------------------


def _vmapped_tp(arch):
    """The vmapped cells that ``TP_CELLS`` are held against (width 1, one
    device)."""
    cfgs = R.ladder(6)
    out = {"batch": {}, "streaming": {}}
    for name, chunk, device, _ in R.TP_CELLS:
        out["batch"][name] = R.batch_cell(cfgs, chunk, device, False, None, arch)
        out["streaming"][name] = R.streaming_cell(cfgs, chunk, device, False, None, arch)
    return out


@pytest.fixture(scope="module")
def tp_worlds(tmp_path_factory):
    """starcoder2's ``TP_CELLS`` on 4 spawned ranks (widths 2 and 4, every
    trial from JAX's init of the seed, and the lane ops at width 2), the
    MLA and Mamba archs' width-2 cells on 2 ranks (the port's init), and
    the vmapped cells here while the ranks run."""
    jax, jnp = _jax()
    init = _jax_init_state(jax)
    jp, tpop, fresh_keys, fresh = _jax_population(jax, jnp)
    root = tmp_path_factory.mktemp("tp")
    init_path, lane_path = str(root / "init.pt"), str(root / "lanes.pt")
    torch.save(init, init_path)
    torch.save({"state": tpop, "fresh": fresh, "ops": LANE_OPS}, lane_path)
    procs = {}
    d = root / "starcoder2"
    d.mkdir()
    procs[R.ARCH] = (_start(4, str(d), R.tp_rank, R.ARCH, (2, 4), init_path, lane_path,
                            COLLECTIVE_S), str(d))
    for arch in ARCHS:
        d = root / arch
        d.mkdir()
        procs[arch] = (_start(2, str(d), R.tp_rank, arch, (2,), None, None, COLLECTIVE_S),
                       str(d))
    saved = (ts.init_train_state, ts.init_params)
    R.patch_init(init)
    try:
        vmapped = {R.ARCH: _vmapped_tp(R.ARCH)}
    finally:
        ts.init_train_state, ts.init_params = saved
    for arch in ARCHS:
        vmapped[arch] = _vmapped_tp(arch)
    got = {arch: _join(p, d, deadline_s=400.0) for arch, (p, d) in procs.items()}
    return {"vmapped": vmapped, "tp": got, "tpop": tpop, "fresh": fresh}


def _same_decisions(got, ref, protocol):
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0, atol=1e-6)
    for key in ("n_truncated", "n_reclaimed", "train_steps") + (
            ("steps", "diverged") if protocol == "streaming" else ()):
        assert got[key] == ref[key], key


@pytest.mark.timeout(900)
@pytest.mark.parametrize("name", TP_NAMES)
@pytest.mark.parametrize("protocol", ["batch", "streaming"])
def test_tp_cells_match_vmapped(tp_worlds, protocol, name):
    """Each tensor-parallel cell (2 rows of width 2, or 1 row of width 4)
    against the vmapped cell: scores within 1e-6, the same rung cuts,
    reclaims and trained steps (streaming: per-trial steps and
    divergences); every rank's batch flight returns the same list."""
    ranks = tp_worlds["tp"][R.ARCH]
    _same_decisions(ranks[0][protocol][name], tp_worlds["vmapped"][R.ARCH][protocol][name],
                    protocol)
    if protocol == "batch":
        for r, rank in enumerate(ranks[1:], 1):
            assert rank["batch"][name]["scores"] == ranks[0]["batch"][name]["scores"], r


@pytest.mark.timeout(900)
def test_tp_widths_agree_with_each_other(tp_worlds):
    """Width 2 and width 4 of the per-step cell within 1e-6 of each other."""
    got = tp_worlds["tp"][R.ARCH][0]
    for protocol in ("batch", "streaming"):
        np.testing.assert_allclose(got[protocol]["tp2-perstep-host"]["scores"],
                                   got[protocol]["tp4-perstep-host"]["scores"],
                                   rtol=0, atol=1e-6)


@pytest.mark.timeout(900)
@pytest.mark.parametrize("name", TP2_NAMES)
@pytest.mark.parametrize("protocol", ["batch", "streaming"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_cells_match_vmapped_for_mla_and_mamba(tp_worlds, arch, protocol, name):
    """deepseek-v2-lite (MLA heads sharded, the experts and ``wkv_a`` /
    ``kv_norm`` replicated) and falcon-mamba (the inner channels sharded,
    ``x_proj`` row-parallel) at width 2 on one row of 2 ranks, against
    their vmapped cells: scores within 1e-6, the same decisions."""
    ranks = tp_worlds["tp"][arch]
    _same_decisions(ranks[0][protocol][name], tp_worlds["vmapped"][arch][protocol][name],
                    protocol)
    if protocol == "batch":
        assert ranks[1]["batch"][name]["scores"] == ranks[0]["batch"][name]["scores"]


@pytest.mark.timeout(900)
@pytest.mark.parametrize("name,chunk,device", [
    ("tp2-perstep-host", 1, False),
    ("tp2-chunked-device", 8, True),
])
def test_tp_cells_match_jax_two_level_engine(tp_worlds, name, chunk, device):
    """Two batch cells against the JAX package's two-level engine (its
    width-2 mesh over 8 virtual devices, the same workload and init
    weights): scores within 1e-4, the same cuts and reclaims."""
    jax, _ = _jax()
    from harness import run_batch_cell
    from repro.distributed.sharding import population_mesh as jax_population_mesh

    if jax.device_count() < 8:
        pytest.skip("needs the 8-virtual-device JAX mesh")
    want = run_batch_cell(R.ladder(6), chunk=chunk, device=device,
                          mesh=jax_population_mesh(width=2))
    got = tp_worlds["tp"][R.ARCH][0]["batch"][name]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-4)
    assert got["n_truncated"] == want["n_truncated"]
    assert got["n_reclaimed"] == want["n_reclaimed"]


@pytest.mark.timeout(900)
@pytest.mark.parametrize("arch", (R.ARCH,) + ARCHS)
def test_replicated_leaves_stay_bit_equal_across_a_row(tp_worlds, arch):
    """After every flight, every leaf that no width rule shards (embedding,
    norms, router, experts, ``wkv_a`` / ``kv_norm``, their moments, the
    latches and losses) holds the same bits on every rank of a row."""
    ranks = tp_worlds["tp"][arch]
    widths = (2, 4) if arch == R.ARCH else (2,)
    n_flights = sum(2 * sum(c[3] == w for c in R.TP_CELLS) for w in widths)
    logs = [r["replicated"] for r in ranks]
    assert all(len(log) == n_flights for log in logs)
    for i in range(n_flights):
        # the flights of width 2 come first: rows {0, 1} and {2, 3} of 4
        # ranks, or the one row of 2; then width 4, one row of 4
        width = 2 if i < 2 * len(TP2_NAMES) else 4
        for r in range(len(ranks)):
            lead = r - r % width
            assert logs[r][i] == logs[lead][i], (arch, i, r)


@pytest.mark.timeout(900)
def test_a_model_rank_plans_the_rmsnorm_backward_for_the_rows(tp_worlds):
    """On a two-level mesh the RMSNorm backward plans a rank's K/rows lanes
    as the whole population's K: ``plan_for_mesh(rows)``."""
    assert [r["rmsnorm_mesh_ranks"] for r in tp_worlds["tp"][R.ARCH]] == [{2: 2, 4: 1}] * 4
    assert [r["rmsnorm_mesh_ranks"] for r in tp_worlds["tp"][ARCHS[0]]] == [{2: 1}] * 2


def _reckoned(arch, width):
    """The model-group collectives a step issues: per layer GQA 2 (f's
    backward, g's forward) when attention shards, MLA 4 (f on x, c and
    k_rope, g), a dense MLP 2 when ``ff`` shards, Mamba 4 (f on x, g then f
    around ``x_proj``, g); one more for the gradient norm's sharded sum."""
    cfg = get_smoke_config(arch)
    flags = S.tp_module_flags(cfg, width)
    layers = list(cfg.prefix_pattern) + list(cfg.pattern) * cfg.n_superblocks
    n = 1
    for mixer, ffn in layers:
        if mixer == "mamba":
            n += 4 * flags["mamba"]
        elif mixer == "attn_mla":
            n += 4 * flags["attn"]
        else:
            n += 2 * flags["attn"]
        if ffn == "dense":
            n += 2 * flags["mlp"]
    return n


@pytest.mark.timeout(900)
@pytest.mark.parametrize("arch", (R.ARCH,) + ARCHS)
def test_model_axis_collectives_are_the_reckoned_count(tp_worlds, arch):
    """Every cell's count of model-group collectives a step equals the
    reckoning from the seams and the norm (9 for starcoder2 at width 2, 5
    at width 4, where its 2 kv heads stop attention sharding)."""
    got = tp_worlds["tp"][arch][0]["batch"]
    assert got
    for name, chunk, device, width in R.TP_CELLS:
        if name in got:
            assert got[name]["collectives"] == _reckoned(arch, width), name
    assert _reckoned(R.ARCH, 2) == 9 and _reckoned(R.ARCH, 4) == 5


@pytest.mark.timeout(900)
@pytest.mark.parametrize("step", range(len(LANE_OPS)))
def test_tp_lane_ops_match_vmapped_bitwise(tp_worlds, step):
    """The lane-op sequence on a width-2 state over 2 rows (a clone chain
    across rows, shard j to shard j; splice; a masked init; a snapshot
    harvested on one row and restored into another): each rank's shards of
    the gathered state equal the vmapped lane ops' state's, bit for bit,
    and the snapshot rank 0 received is the whole lane's host layout."""
    want, snap = _vmapped_sequence(tp_worlds["tpop"], tp_worlds["fresh"])
    for r, rank in enumerate(tp_worlds["tp"][R.ARCH]):
        layout = P.TPLayout(_tc(), 2, r % 2)
        assert _bits_equal(rank["lane_ops"]["states"][step],
                           layout.state(want[step])), (step, r)
    if LANE_OPS[step][0] == "snapshot_restore":
        assert _bits_equal(tp_worlds["tp"][R.ARCH][0]["lane_ops"]["snapshot"], snap)
