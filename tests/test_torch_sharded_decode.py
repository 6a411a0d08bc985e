"""Prefill and decode on a trial mesh (``train/serve_step.py::ServeLayout``)
against the port's unsharded step and the JAX package's, on the CPU over
gloo.

Spawned ranks (bodies in ``torch_mesh_ranks.py``) at (1, 2) and (2, 2) on
the smoke configs of starcoder2 (GQA: its cache split along the sequence
over the model axis, as the production rules place it), deepseek-v2-lite
(MLA and the expert-parallel dropless MoE), falcon-mamba (the Mamba mixer
split over its channels) and qwen3-moe (GQA and the MoE); and a
``long_500k``-style case (``shard_cache_seq``: the cache's positions over
``("data", "model")``) of starcoder2 and deepseek.  Each rank decodes its
rows of a batch of 4: the prompt fed a token a step, then greedy tokens.
Held, fp32:

* each step's logits of the rank's rows within 1e-5 of the unsharded
  ``decode_step``'s, and its greedy tokens equal;
* the prefill's last logits (``forward(last_only=True)`` on the rank's
  rows) within 1e-5 of the unsharded prefill's (with more than one data
  rank an MoE layer dispatches each data shard's tokens with its own
  capacity, as in training, so there the oracle runs the MoE per shard);
* each rank's blocks of the final cache within 1e-5 of the unsharded
  cache's: the row at ``pos`` is written by the rank that owns it;
* the logits within 3e-5 of JAX's ``decode_step`` at every step;
* the split caches join their partial softmaxes over the cache's axes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_mesh_ranks as R
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import axis_size, map_specs, sharded_dims
from repro_torch.interop import tree_leaves
from repro_torch.models import moe as moem
from repro_torch.models import transformer as T
from test_torch_sharded import COLLECTIVE_S, _join, _start

torch.set_num_threads(2)

TOL, JAX_TOL = 1e-5, 3e-5
B, P, NEW, MAX_SEQ = R.DECODE_BATCH, R.DECODE_PROMPT, R.DECODE_NEW, R.DECODE_MAX_SEQ
ARCHS = ("starcoder2-3b", "deepseek-v2-lite-16b", "falcon-mamba-7b", "qwen3-moe-30b-a3b")
SHORT = {"starcoder2-3b": "sc2", "deepseek-v2-lite-16b": "ds", "falcon-mamba-7b": "mamba",
         "qwen3-moe-30b-a3b": "qwen3"}


def _case(arch, shape, long=False):
    name = f"{SHORT[arch]}-{'long-' if long else ''}{shape[0]}{shape[1]}"
    return dict(name=name, arch=arch, shape=shape, long=long)


WORLDS = {
    2: [_case(a, (1, 2)) for a in ARCHS],
    4: [_case(a, (2, 2)) for a in ARCHS]
    + [_case("starcoder2-3b", (2, 2), long=True),
       _case("deepseek-v2-lite-16b", (2, 2), long=True)],
}
CASES = {c["name"]: (w, c) for w, cs in WORLDS.items() for c in cs}
JOIN_S = 240.0


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Each arch's whole smoke parameters (the JAX package's init) and a
    prompt, saved for the ranks; the JAX trees beside them."""
    out, jax_params = {}, {}
    rng = np.random.default_rng(11)
    for arch in ARCHS:
        cfg = jax_smoke_config(arch)
        jp = jax.device_get(JT.init_params(jax.random.PRNGKey(0), cfg))
        prompt = rng.integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)
        out[arch] = {"params": interop.to_torch(jp), "prompt": torch.from_numpy(prompt)}
        jax_params[arch] = jp
    path = tmp_path_factory.mktemp("decode_inputs") / "inputs.pt"
    torch.save(out, path)
    return str(path), out, jax_params


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every world's ranks, started at once, then joined: name -> each
    rank's result of that case."""
    started = {}
    for world, cases in WORLDS.items():
        root = tmp_path_factory.mktemp(f"decode{world}")
        started[world] = (_start(world, str(root), R.decode_rank, cases, inputs[0],
                                 COLLECTIVE_S), root)
    out = {}
    for world, (procs, root) in started.items():
        got = _join(procs, str(root), JOIN_S)
        for c in WORLDS[world]:
            out[c["name"]] = [g[c["name"]] for g in got]
    return out


def _unsharded(arch, whole):
    """The port's unsharded prefill and decode of the whole batch: the
    prefill's last logits, each step's logits and tokens, the final cache."""
    cfg = get_smoke_config(arch)
    params = interop.add_lane_axis(whole["params"])
    prompt = whole["prompt"]
    with torch.no_grad():
        prefill, _ = T.forward(params, prompt[None], cfg, remat="none", last_only=True)
    cache = T.init_cache(cfg, 1, B, MAX_SEQ, torch.float32, "cpu")
    tok, logits, tokens = prompt[:, :1], [], []
    for pos in range(P + NEW - 1):
        step, _ = T.decode_step(params, cache, tok[None], pos, cfg)
        logits.append(step[0])
        nxt = torch.argmax(step[0, :, -1], dim=-1)[:, None].to(prompt.dtype)
        tok = prompt[:, pos + 1:pos + 2] if pos + 1 < P else nxt
        tokens.append(tok)
    return {"prefill": prefill[0], "decode": logits, "tokens": tokens,
            "cache": interop.tree_map(lambda a: a[0], cache)}


_REF = {}


def _reference(arch, whole):
    if arch not in _REF:
        _REF[arch] = _unsharded(arch, whole)
    return _REF[arch]


def _per_shard_prefill(arch, whole, n_data, monkeypatch):
    """The unsharded prefill with ``moe_apply`` run on each of ``n_data``
    shards of the rows (the expert-parallel layer's dispatch)."""
    plain = moem.moe_apply

    def apply(p, x, cfg, *, dropless=False):
        outs = [plain(p, xi, cfg, dropless=dropless) for xi in x.chunk(n_data, dim=1)]
        return torch.cat([y for y, _ in outs], 1), sum(a for _, a in outs) / n_data

    monkeypatch.setattr(moem, "moe_apply", apply)
    cfg = get_smoke_config(arch)
    with torch.no_grad():
        logits, _ = T.forward(interop.add_lane_axis(whole["params"]), whole["prompt"][None],
                              cfg, remat="none", last_only=True)
    return logits[0]


def _block(whole, placement, shape, rank):
    """Rank ``rank``'s block of a whole leaf on a ``shape`` (data, model)
    trial mesh."""
    d, m = shape
    coords = {"data": rank // m, "model": rank % m}
    mesh = type("Mesh", (), {"shape": {"data": d, "model": m}})()
    for i, a in sharded_dims(placement, mesh):
        idx = 0
        for x in (a,) if isinstance(a, str) else a:
            idx = idx * mesh.shape[x] + coords[x]
        n = whole.shape[i] // axis_size(mesh, a)
        whole = whole.narrow(i, idx * n, n)
    return whole


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_the_unsharded_step(name, ranks, inputs):
    """Every step's logits of each rank's rows within 1e-5 of the
    unsharded ``decode_step``'s, the greedy tokens equal, and each rank's
    cache blocks within 1e-5 of the unsharded cache's."""
    world, case = CASES[name]
    ref = _reference(case["arch"], inputs[1][case["arch"]])
    for rank, got in enumerate(ranks[name]):
        rows = slice(*got["rows"])
        for pos, (a, b) in enumerate(zip(got["decode"], ref["decode"])):
            np.testing.assert_allclose(a.numpy(), b[rows].numpy(), atol=TOL, rtol=0,
                                       err_msg=f"{name} rank {rank} logits at {pos}")
        for a, b in zip(got["tokens"], ref["tokens"]):
            assert torch.equal(a, b[rows]), (name, rank)
        wholes, blocks = [], []
        map_specs(ref["cache"], got["cache_placements"], lambda w, p: wholes.append((w, p)))
        map_specs(got["cache"], got["cache_placements"], lambda a, _: blocks.append(a))
        assert len(blocks) == len(wholes) > 0
        for a, (w, p) in zip(blocks, wholes):
            want = _block(w, p, case["shape"], rank)
            assert a.shape == want.shape, (name, rank, p)
            np.testing.assert_allclose(a.numpy(), want.numpy(), atol=TOL, rtol=0,
                                       err_msg=f"{name} rank {rank} cache {p}")


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_the_unsharded_prefill(name, ranks, inputs, monkeypatch):
    """The last position's logits of each rank's rows within 1e-5 of the
    unsharded prefill's (the MoE per data shard where rows split over more
    than one data rank)."""
    world, case = CASES[name]
    arch = case["arch"]
    whole = inputs[1][arch]
    n_data = case["shape"][0]
    if get_smoke_config(arch).has_moe and n_data > 1:
        want = _per_shard_prefill(arch, whole, n_data, monkeypatch)
    else:
        want = _reference(arch, whole)["prefill"]
    for rank, got in enumerate(ranks[name]):
        rows = got["prefill_rows"]
        np.testing.assert_allclose(got["prefill"].numpy(), want[rows].numpy(), atol=TOL,
                                   rtol=0, err_msg=f"{name} rank {rank}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch, ranks, inputs):
    """Every sharded case of the arch against the JAX package's
    ``decode_step`` on the whole batch, fed the same tokens: each step's
    logits of each rank's rows within 3e-5."""
    cfg = jax_smoke_config(arch)
    jp = inputs[2][arch]
    ref = _reference(arch, inputs[1][arch])
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, c, t, pos, cfg))
    jc = JT.init_cache(cfg, B, MAX_SEQ, dtype=jnp.float32)
    prompt = inputs[1][arch]["prompt"]
    tok, want = prompt[:, :1].numpy(), []
    for pos in range(P + NEW - 1):
        jl, jc = step(jp, jc, jnp.asarray(tok), pos)
        want.append(np.asarray(jl))
        tok = ref["tokens"][pos].numpy()
    names = [n for n, (_, c) in CASES.items() if c["arch"] == arch]
    for name in names:
        for rank, got in enumerate(ranks[name]):
            rows = slice(*got["rows"])
            for pos, a in enumerate(got["decode"]):
                np.testing.assert_allclose(a.numpy(), want[pos][rows], atol=JAX_TOL,
                                           rtol=JAX_TOL, err_msg=f"{name} rank {rank} {pos}")


def test_split_caches_join_their_softmax_over_the_cache_axes(ranks):
    """Where the cache's positions are split, decode joins the partial
    softmaxes by all-reduces over their axes: the model axis at (1, 2), the
    pair ``data+model`` in the long cases (whose batch then replicates over
    the data axis: every rank decodes every row)."""
    for name in ("sc2-12", "ds-12"):
        assert ranks[name][0]["collectives"].get("model/all_reduce", 0) > 0
    for name in ("sc2-long-22", "ds-long-22"):
        got = ranks[name][0]
        assert got["collectives"].get("data+model/all_reduce", 0) > 0, got["collectives"]
        assert got["rows"] == (0, B)
        assert sum(t.numel() for t in tree_leaves(got["cache"])) > 0
