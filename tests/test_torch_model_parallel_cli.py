"""The port's CLI with ``--shard-population --model-parallel W``, on gloo
CPU ranks under ``torchrun``: the twins of the JAX package's
``tests/test_model_parallel.py`` CLI cases, and its refusals.

* The same ASHA search at width 2 (one row of 2 ranks) and at width 1 (2
  rows of one rank): the same best config, best scores within 1e-6,
  ``model_axis_collectives`` 0 at width 1 and at width 2 the count
  reckoned from the seams and the norm, the engine ``sharded+tp2``, rung
  segments that cover the flight.
* A supervised width-2 streaming flight that dies (an injected raise) and
  restarts restores its lanes from width-2 snapshots: best score within
  1e-6 of the unbroken run, ``resumed_from_steps`` above 0.
* The refusals, exit code 2, after the JAX CLI's: ``--model-parallel``
  without ``--shard-population``, a width below 1, a width that shards
  nothing, ``--model-parallel`` with ``--elastic-regrid``.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import hpo

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _torchrun(argv, cwd, n=2):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(n), "-m", "repro_torch.launch.hpo"] + argv + ["--device", "cpu"],
        cwd=str(cwd), env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout)


@pytest.mark.timeout(900)
def test_cli_model_parallel_matches_width1_twin(tmp_path):
    """The twin of ``test_cli_model_parallel_matches_width1_twin``: the
    same search at width 2 and width 1 lands on the same best config
    within 1e-6.  The reckoning of ``model_axis_collectives`` for
    starcoder2-3b's smoke config (2 layers, 4 heads over 2 kv heads, ff
    128): each layer's attention 2 (``tp_enter``'s backward all-reduce,
    ``tp_reduce``'s forward one) and MLP 2, and 1 for the gradient norm's
    sharded sum: 2 * (2 + 2) + 1 = 9 a step."""
    base = ["--proposer", "asha", "--n-samples", "6", "--vectorize", "8",
            "--shard-population", "--inflight-stop", "--steps", "2", "--batch", "2",
            "--seq", "16"]
    w1 = _torchrun(base, tmp_path)
    w2 = _torchrun(base + ["--model-parallel", "2"], tmp_path)
    assert w1["engine"] == "sharded"
    assert w2["engine"] == "sharded+tp2"
    assert w1["model_parallel"] == 1 and w2["model_parallel"] == 2
    assert w1["model_axis_collectives"] == 0
    assert w2["model_axis_collectives"] == 2 * (2 + 2) + 1
    assert w2["mesh_ranks"] == 2 and w2["n_degraded_flights"] == 0
    assert w2["best_config"] == w1["best_config"]
    assert abs(w2["best_score"] - w1["best_score"]) <= 1e-6
    # the rung-segment telemetry covers the whole flight
    assert w2["per_rung_step_time_s"]
    assert sum(seg[1] for seg in w2["per_rung_step_time_s"]) == w2["trained_steps"]


@pytest.mark.timeout(900)
def test_width2_flight_death_restores_from_width2_snapshots(tmp_path):
    """The twin of JAX's death-and-restore case: a width-2 streaming flight
    dies at step 10 (inside the refilled second cohort) and restarts; its
    lanes restore from snapshots gathered off the width-sharded state (a
    lane's shards joined to the host layout, cut again onto the new
    flight's row), and every score matches the unbroken width-2 run."""
    base = ["--proposer", "random", "--vectorize", "4", "--lane-refill",
            "--shard-population", "--model-parallel", "2", "--n-samples", "6",
            "--steps", "6", "--batch", "2", "--seq", "16", "--snapshot-every", "1"]
    ok = _torchrun(base + ["--db", str(tmp_path / "a.sqlite")], tmp_path)
    crashed = _torchrun(base + ["--db", str(tmp_path / "b.sqlite"),
                                "--fault-spec", "raise@step=10,times=1"], tmp_path)
    assert ok["engine"] == "sharded+tp2+refill"
    assert crashed["flight_deaths"] == 1
    assert crashed["flight_restarts"] == 1
    assert crashed["resumed_lanes"] >= 1
    assert max(crashed["resumed_from_steps"]) > 0, \
        "restored lanes restarted from step 0 instead of their snapshots"
    assert abs(crashed["best_score"] - ok["best_score"]) <= 1e-6
    assert crashed["best_config"] == ok["best_config"]


BASE = ["--n-samples", "2", "--vectorize", "2", "--steps", "1", "--batch", "1", "--seq", "8",
        "--device", "cpu"]


@pytest.mark.parametrize("argv,said", [
    (["--model-parallel", "2"], "requires --vectorize K with --shard-population"),
    (["--shard-population", "--model-parallel", "0"], "must be >= 1"),
    (["--shard-population", "--model-parallel", "3"], "shards nothing"),
    (["--shard-population", "--model-parallel", "2", "--elastic-regrid"],
     "incompatible with --elastic-regrid"),
], ids=["without-shard-population", "below-1", "shards-nothing", "elastic-regrid"])
def test_model_parallel_refusals_exit_2(capsys, argv, said):
    """The JAX CLI's refusals of ``--model-parallel``, with exit code 2 and
    its words."""
    with pytest.raises(SystemExit) as exc:
        hpo.main(BASE + argv)
    assert exc.value.code == 2
    assert said in capsys.readouterr().err


def test_model_parallel_on_the_cpu_backend_needs_the_cpu_flag(monkeypatch):
    """Without ``--device cpu`` and without a card the two-level mesh
    raises rather than carry on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        hpo.main([a for a in BASE if a not in ("--device", "cpu")]
                 + ["--shard-population", "--model-parallel", "2"])


@pytest.mark.timeout(400)
def test_mesh_hpo_example_runs_its_model_parallel_part(tmp_path):
    """``examples/mesh_hpo_torch.py --device cpu --model-parallel 2``: part
    3 trains its population on one lane row of 2 gloo ranks to the
    unsharded engine's best loss (4 decimals) with 9 model-group
    collectives a step."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "mesh_hpo_torch.py"),
                           "--device", "cpu", "--model-parallel", "2"], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=350)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = proc.stdout.split("=== part 3")[1].splitlines()[1]
    got, ref = line.split("best final loss ")[1].split()[0], line.split("unsharded: ")[1][:6]
    assert got == ref and "9 model-group collectives a step" in line
