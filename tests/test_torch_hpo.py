"""The port's HPO driver against the JAX package's, and the port's import rule.

The same CLI arguments go to ``repro.launch.hpo.main`` and
``repro_torch.launch.hpo.main(..., "--device", "cpu")``.  The port's init is
swapped for the JAX init, copied through ``repro_torch.interop`` (the two
RNGs differ); the proposers, the data streams and the engines are the
port's own.  Both must pick the same best config, with best scores within
1e-4.
"""
import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.launch import hpo as jax_hpo
from repro.train.train_step import init_train_state as jax_init_train_state
from repro_torch import interop
from repro_torch.launch import hpo
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--n-samples", "4", "--steps", "3", "--batch", "2", "--seq", "16"]


def _use_jax_init(monkeypatch, arch):
    """Start the port's trials from the JAX package's init weights of
    ``arch`` (the CLI's default seed)."""
    jtc = JaxTrainConfig(model=jax_smoke_config(arch))
    state = jax.device_get(jax_init_train_state(jax.random.PRNGKey(0), jtc))

    def init_train_state(gen, tc, device):
        return interop.to_torch(state, device)  # a fresh copy per trial

    monkeypatch.setattr(ts, "init_train_state", init_train_state)


@pytest.fixture
def jax_init(monkeypatch):
    """The CLI's default arch, starcoder2-3b, from the JAX init weights."""
    _use_jax_init(monkeypatch, "starcoder2-3b")


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("extra", [
    ["--proposer", "random", "--vectorize", "4"],
    ["--proposer", "asha", "--vectorize", "4", "--inflight-stop"],
    ["--proposer", "random"],
    ["--proposer", "random", "--vectorize", "4", "--shared-stream"],
], ids=["random-vectorized", "asha-inflight-stop", "random-serial", "shared-stream"])
def test_cli_matches_jax_cli(jax_init, capsys, extra):
    want = _run(jax_hpo.main, BASE + extra, capsys)
    got = _run(hpo.main, BASE + extra + ["--device", "cpu"], capsys)
    assert got["engine"] == want["engine"]
    assert got["best_config"] == want["best_config"]
    np.testing.assert_allclose(got["best_score"], want["best_score"], atol=1e-4, rtol=1e-4)
    if "--inflight-stop" in extra:
        assert got["inflight_truncated_lanes"] == want["inflight_truncated_lanes"]
        assert got["trained_steps"] == want["trained_steps"]


@pytest.mark.parametrize("extra", [[], ["--fused-ssm"]], ids=["plain", "fused-ssm"])
def test_falcon_mamba_cli_matches_jax_cli(monkeypatch, capsys, extra):
    """``--arch falcon-mamba-7b --vectorize 2``: the same best config and a
    best score within 1e-4 of the JAX CLI (whose ``--fused-ssm`` runs the
    Pallas scan in interpret mode); the port accepts ``--fused-ssm`` and
    reports it."""
    _use_jax_init(monkeypatch, "falcon-mamba-7b")
    argv = BASE + ["--arch", "falcon-mamba-7b", "--vectorize", "2"] + extra
    want = _run(jax_hpo.main, argv, capsys)
    got = _run(hpo.main, argv + ["--device", "cpu"], capsys)
    assert got["arch"] == want["arch"] == "falcon-mamba-7b"
    assert got["best_config"] == want["best_config"]
    np.testing.assert_allclose(got["best_score"], want["best_score"], atol=1e-4, rtol=1e-4)
    assert got.get("fused_ssm") == want.get("fused_ssm") == (True if extra else None)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
                  "__import__", "import_module")):
            yield node.args[0].value


def test_port_imports_neither_jax_nor_the_jax_package():
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(examples) >= 3
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + examples)
    assert len(files) > 30
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "repro"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_population_trial_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        hpo.PopulationTrial("starcoder2-3b", 1, 1, 8, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hpo.main(BASE + ["--vectorize", "2"])
    assert hpo.PopulationTrial("starcoder2-3b", 1, 1, 8, 0, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("argv,item", [
    (["--chunk-steps", "4", "--data-ring", "--shared-stream"], "drop --shared-stream"),
    (["--lane-refill", "--shared-stream"], "per-trial data streams"),  # as the JAX CLI
    (["--pbt-streaming"], "needs --proposer pbt"),                     # as the JAX CLI
    (["--snapshot-every", "2"], "requires --lane-refill"),             # as the JAX CLI
    (["--data-ring"], "--chunk-steps T > 1"),                          # as the JAX CLI
    (["--fused-ssm"], "no SSM mixer"),   # ported: refused only on an arch without one
    (["--elastic-regrid", "--device-rules", "--inflight-stop", "--proposer", "asha"],
     "incompatible with --device-rules"),   # as the JAX CLI
    (["--model-parallel", "2"], "--shard-population"),   # as the JAX CLI
    (["--legacy-recompile", "--fused-rmsnorm"], "predates the kernel bank"),  # as the JAX CLI
])
def test_later_slice_flags_are_refused_with_their_roadmap_item(capsys, argv, item):
    """Flags of later slices exit naming their ROADMAP.md item; ``--fused-ssm``
    on the default arch (starcoder2-3b) exits naming the missing SSM mixer,
    and misuses of the streaming, crash-safety, ring, model-parallel,
    elastic-regrid and legacy-recompile flags exit with the JAX CLI's
    words."""
    with pytest.raises(SystemExit):
        hpo.main(BASE + ["--vectorize", "2", "--device", "cpu"] + argv)
    err = capsys.readouterr().err
    assert item in err
    if item.startswith("item"):
        assert "ROADMAP.md" in err


def test_cli_refuses_an_arch_the_port_cannot_build(capsys):
    """An unknown arch exits with code 2 at parse time, naming it (before
    the check every trial raised in the manager's workers and the CLI died
    with a ``TypeError`` on the missing best result)."""
    with pytest.raises(SystemExit) as exc:
        hpo.main(BASE + ["--arch", "no-such-arch", "--vectorize", "2", "--device", "cpu"])
    assert exc.value.code == 2
    assert "unknown arch" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "hubert-xlarge", "pixtral-12b"])
def test_cli_trains_the_mla_and_frontend_archs(monkeypatch, capsys, arch):
    """deepseek-v2-lite (MLA), hubert-xlarge and pixtral-12b (frontend stubs,
    trained on tokens as the JAX CLI trains them): ``--vectorize 2`` gives
    the JAX CLI's best config and a best score within 1e-4."""
    _use_jax_init(monkeypatch, arch)
    argv = BASE + ["--arch", arch, "--vectorize", "2"]
    want = _run(jax_hpo.main, argv, capsys)
    got = _run(hpo.main, argv + ["--device", "cpu"], capsys)
    assert got["arch"] == want["arch"] == arch
    assert got["best_config"] == want["best_config"]
    np.testing.assert_allclose(got["best_score"], want["best_score"], atol=1e-4, rtol=1e-4)


MLA_OVERRIDES = {"pattern": (("attn_mla", "moe"),), "kv_lora_rank": 16, "rope_head_dim": 16,
                 "n_experts": 4, "moe_top_k": 2, "moe_d_ff": 32}


def test_population_trial_trains_an_mla_model_override(monkeypatch):
    """A trial whose model overrides put MLA and MoE layers into starcoder2's
    smoke config trains: its two lanes' scores within 1e-4 of the JAX
    trial's with the same overrides and init weights."""
    import dataclasses

    jcfg = dataclasses.replace(jax_smoke_config("starcoder2-3b"), **MLA_OVERRIDES)
    state = jax.device_get(jax_init_train_state(jax.random.PRNGKey(0),
                                                JaxTrainConfig(model=jcfg)))
    monkeypatch.setattr(ts, "init_train_state",
                        lambda gen, tc, device: interop.to_torch(state, device))
    cfgs = [dict(learning_rate=1e-3, stream=0), dict(learning_rate=3e-3, stream=1)]
    kw = dict(population=2, model_overrides=MLA_OVERRIDES)
    got = hpo.PopulationTrial("starcoder2-3b", 3, 2, 16, 0, device="cpu",
                              **kw).run_population(cfgs)
    want = jax_hpo.PopulationTrial("starcoder2-3b", 3, 2, 16, 0, **kw).run_population(cfgs)
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
