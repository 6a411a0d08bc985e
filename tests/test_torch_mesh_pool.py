"""The port's mesh-slice pool and the population mesh through the CLI.

``tile_pod`` and ``MeshSlice`` against the JAX package's on the cases of
``tests/test_mesh_pool.py`` (the same ids, shapes, origins and device
labels, and the same errors); the port's ``population_specs`` against
JAX's; and ``python -m torch.distributed.run --nproc-per-node 2 -m
repro_torch.launch.hpo --device cpu --vectorize 4 --shard-population`` (two
gloo ranks, from the JAX init weights of the seed) against the JAX CLI with
``--shard-population`` on its 8-virtual-device mesh: the same best config,
best scores within 1e-4.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.resource import mesh_pool as M
from repro_torch.distributed.sharding import PopulationMesh, population_specs

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _jax():
    return pytest.importorskip("jax")


def _jax_tile_pod():
    _jax()
    from repro.core.resource.mesh_pool import tile_pod

    return tile_pod


def _summary(slices):
    return [(s.slice_id, s.shape, s.origin, s.devices) for s in slices]


@pytest.mark.parametrize("pod,shape", [
    ((1, 6), (1, 3)),     # a non-power-of-two row
    ((2, 3), (1, 1)),     # 1-device slices, row-major
    ((4, 4), (2, 2)),     # 2-d blocks are contiguous rectangles
    ((16, 16), (1, 1)),   # the paper's Fig. 3 regime: 256 virtual slices
    ((1, 8), (1, 8)),     # one slice of the whole pod
], ids=["row-1x6-by-3", "single-device", "blocks-2x2", "virtual-256", "whole-pod"])
def test_tile_pod_matches_jax_on_virtual_pods(pod, shape):
    """Ids, shapes, origins and device labels equal JAX's; every slice is
    virtual and has no devices to hand out."""
    got = M.tile_pod(pod, shape, virtual=True)
    assert _summary(got) == _summary(_jax_tile_pod()(pod, shape, virtual=True))
    assert all(s.virtual for s in got)
    with pytest.raises(RuntimeError, match="virtual"):
        got[0].mesh()


@pytest.mark.parametrize("pod,shape", [((1, 8), (1, 3)), ((2, 2), (3, 1))])
def test_tile_pod_rejects_untileable_slice_as_jax(pod, shape):
    with pytest.raises(ValueError) as got:
        M.tile_pod(pod, shape, virtual=True)
    with pytest.raises(ValueError) as want:
        _jax_tile_pod()(pod, shape, virtual=True)
    assert str(got.value) == str(want.value) and "does not tile" in str(got.value)


def test_tile_pod_rejects_short_device_list_as_jax():
    jax = _jax()
    with pytest.raises(ValueError) as got:
        M.tile_pod((2, 2), (1, 1), devices=[torch.device("cpu")])
    with pytest.raises(ValueError) as want:
        _jax_tile_pod()((2, 2), (1, 1), devices=jax.devices()[:1])
    assert str(got.value) == str(want.value) == "need 4 devices for pod (2, 2), have 1"


def test_real_slice_hands_out_its_device_grid():
    """A slice of real devices is not virtual; ``mesh()`` is its device
    grid in the slice's shape, row-major."""
    devs = [torch.device("cpu")] * 4
    slices = M.tile_pod((2, 2), (2, 1), devices=devs)
    assert [s.slice_id for s in slices] == ["slice[0:2,0:1]", "slice[0:2,1:2]"]
    assert not slices[0].virtual
    grid = slices[1].mesh()
    assert grid.shape == (2, 1) and all(d == torch.device("cpu") for d in grid.flat)


def test_mesh_pool_manager_runs_trials_on_slices():
    """``MeshPoolResourceManager`` presents one resource a slice and calls
    the trial with its slice."""
    from repro_torch.core.job import Job

    rm = M.MeshPoolResourceManager(pod_shape=(1, 4), slice_shape=(1, 2), virtual=True)
    assert rm.n_total() == 2
    seen = []
    job = Job(0, {"x": 1}, None, lambda j: None)
    job.resource_id = rm.get_available()
    rm.run(job, lambda cfg, sl: seen.append((cfg["x"], sl.slice_id)) or 2.0)
    job.wait(5.0)
    assert job.result.score == 2.0 and seen == [(1, "slice[0:1,0:2]")]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_population_specs_match_jax(n):
    """Rank-0 leaves and leading dims that do not divide over the ranks are
    replicated, the rest blocked, as JAX's ``population_specs`` places
    them."""
    jax = _jax()
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from repro.distributed.sharding import population_mesh as jax_population_mesh
    from repro.distributed.sharding import population_specs as jax_population_specs

    if jax.device_count() < n:
        pytest.skip(f"needs {n} JAX devices")
    shapes = {"w": (n, 3), "s": (), "odd": (n + 1,), "two": (2 * n, 5)}
    want = jax_population_specs({k: jnp.zeros(v) for k, v in shapes.items()},
                                jax_population_mesh(jax.devices()[:n]))
    mesh = PopulationMesh(rank=0, world_size=n, device=torch.device("cpu"), backend="gloo")
    got = population_specs({k: torch.zeros(v) for k, v in shapes.items()}, mesh)
    for k in shapes:
        assert got[k] == ("pop" if want[k].spec == PartitionSpec("pop") else "rep"), k


# -- the CLI over two ranks against the JAX CLI on its virtual mesh ------------------

BASE = ["--n-samples", "4", "--steps", "3", "--batch", "2", "--seq", "16", "--vectorize", "4",
        "--shard-population"]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("extra", [
    [],
    ["--lane-refill", "--proposer", "asha", "--inflight-stop", "--chunk-steps", "4",
     "--device-rules"],
], ids=["batch", "refill-asha-devrules"])
def test_two_rank_cli_matches_jax_sharded_cli(tmp_path, capsys, extra):
    """``torchrun --nproc-per-node 2`` of the port's CLI (gloo, CPU) against
    the JAX CLI with ``--shard-population`` on its virtual mesh: the same
    best config, best scores within 1e-4, the sharded engine named, two
    ranks, no degraded flight."""
    jax = _jax()
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.launch import hpo as jax_hpo
    from repro.train.train_step import init_train_state as jax_init_train_state
    from repro_torch import interop

    if jax.device_count() < 2:
        pytest.skip("needs the multi-device (virtual CPU) JAX mesh")
    init = interop.to_torch(jax.device_get(jax_init_train_state(
        jax.random.PRNGKey(0), JaxTrainConfig(model=jax_smoke_config("starcoder2-3b")))))
    init_path = str(tmp_path / "init.pt")
    torch.save(init, init_path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), HERE]),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         os.path.join(HERE, "torch_mesh_ranks.py"), init_path] + BASE + extra
        + ["--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout)
    assert jax_hpo.main(BASE + extra) == 0
    want = json.loads(capsys.readouterr().out)
    assert got["engine"] == want["engine"] and got["engine"].startswith("sharded")
    assert got["best_config"] == want["best_config"]
    np.testing.assert_allclose(got["best_score"], want["best_score"], atol=1e-4, rtol=1e-4)
    assert got["mesh_ranks"] == 2 and got["mesh_backend"] == "gloo"
    assert got["n_degraded_flights"] == 0
    assert got["model_axis_collectives"] == want["model_axis_collectives"] == 0


@pytest.mark.timeout(300)
def test_mesh_hpo_example_runs_both_parts(tmp_path):
    """``examples/mesh_hpo_torch.py --device cpu``, as its JAX twin runs:
    the virtual pod finishes every trial through a slice failure and a
    scale-out, and the real-device slice trains the smoke LM to a finite
    loss."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "mesh_hpo_torch.py"),
                           "--device", "cpu"], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=250)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "pool: 16 slices of 16 chips" in out and "finished 32 trials" in out
    loss = float(out.split("best final loss ")[1].split()[0])
    assert np.isfinite(loss) and loss > 0
