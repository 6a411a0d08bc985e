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


@pytest.fixture
def jax_init(monkeypatch):
    """Start the port's trials from the JAX package's init weights (the CLI's
    default arch and seed)."""
    jtc = JaxTrainConfig(model=jax_smoke_config("starcoder2-3b"))
    state = jax.device_get(jax_init_train_state(jax.random.PRNGKey(0), jtc))

    def init_train_state(gen, tc, device):
        return interop.to_torch(state, device)  # a fresh copy per trial

    monkeypatch.setattr(ts, "init_train_state", init_train_state)


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("extra", [
    ["--proposer", "random", "--vectorize", "4"],
    ["--proposer", "asha", "--vectorize", "4", "--inflight-stop"],
    ["--proposer", "random"],
], ids=["random-vectorized", "asha-inflight-stop", "random-serial"])
def test_cli_matches_jax_cli(jax_init, capsys, extra):
    want = _run(jax_hpo.main, BASE + extra, capsys)
    got = _run(hpo.main, BASE + extra + ["--device", "cpu"], capsys)
    assert got["engine"] == want["engine"]
    assert got["best_config"] == want["best_config"]
    np.testing.assert_allclose(got["best_score"], want["best_score"], atol=1e-4, rtol=1e-4)
    if "--inflight-stop" in extra:
        assert got["inflight_truncated_lanes"] == want["inflight_truncated_lanes"]
        assert got["trained_steps"] == want["trained_steps"]


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
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
    (["--chunk-steps", "4"], "item 7"),
    (["--lane-refill"], "item 8"),
    (["--snapshot-every", "2"], "item 9"),
    (["--data-ring"], "item 10"),
    (["--fused-ssm"], "item 11"),
    (["--shard-population"], "item 12"),
    (["--model-parallel", "2"], "item 12"),
    (["--legacy-recompile"], "item 13"),
])
def test_later_slice_flags_are_refused_with_their_roadmap_item(capsys, argv, item):
    with pytest.raises(SystemExit):
        hpo.main(BASE + ["--vectorize", "2", "--device", "cpu"] + argv)
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and item in err
