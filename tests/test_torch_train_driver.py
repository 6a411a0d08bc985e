"""The port's one-trial training path against the JAX package: the train and
eval steps, the fp32 master copy, remat, the step cache, the training
driver (``repro_torch.launch.train``) and the ``--legacy-recompile`` trial.

Initial states come from JAX through ``repro_torch.interop``; batches from
the shared numpy host synthesis.  fp32 on the CPU: 1e-4 on losses and
parameters against JAX; remat against no remat, and a resumed run against
the run fed the same batches, bit for bit inside the port.

The JAX CLI ``python -m repro.launch.train`` does not run on the CPU
backend (its trial mesh fails in ``embed_tokens``), so the driver is held
against a JAX loop built as its ``build()`` builds it, without the mesh.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.launch import hpo as jax_hpo
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.launch import hpo
from repro_torch.launch import train as driver
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

ARCH = "starcoder2-3b"
B, S, STEPS = 2, 32, 3
TC_KW = dict(learning_rate=3e-3, warmup_steps=2, total_steps=6)


def _configs(remat="none", mb=0, **model):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **model)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **model)
    jtc = JaxTrainConfig(model=jcfg, parallel=JaxParallelConfig(remat=remat, microbatch=mb),
                         **TC_KW)
    tc = TrainConfig(model=cfg, parallel=ParallelConfig(remat=remat, microbatch=mb), **TC_KW)
    return jtc, tc


def _jax_state(jtc, seed=0):
    return jax.device_get(jts.init_train_state(jax.random.PRNGKey(seed), jtc))


def _port_train(tc, state, batches):
    step = ts.make_train_step(tc)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(m["loss"])
    return state, torch.stack(losses)


def _batches(n=STEPS, start=0):
    data = JaxSyntheticLM(jax_smoke_config(ARCH).vocab_size, S, B, seed=0)
    return [data.make_batch(t) for t in range(start, start + n)]


def _assert_tree_close(got, want, tol):
    got, want = interop.tree_leaves(interop.to_numpy(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=tol, rtol=tol)


def _bits(t):
    t = t.detach()
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return t


def _assert_tree_bits(a, b):
    la, lb = interop.tree_leaves(a), interop.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("mb", [0, 1], ids=["full-batch", "microbatch"])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_train_and_eval_steps_match_jax(remat, mb):
    """``make_train_step`` three steps and ``make_eval_step`` after them,
    within 1e-4 of JAX's (losses, lr, every state leaf, eval metrics)."""
    jtc, tc = _configs(remat, mb)
    jstate = _jax_state(jtc)
    state = interop.to_torch(jstate)
    jstep = jax.jit(jts.make_train_step(jtc))
    step = ts.make_train_step(tc)
    for b in _batches():
        jstate, jm = jstep(jstate, b)
        state, m = step(state, b)
        assert m["loss"].shape == ()
        for k in ("loss", "lr", "grad_norm", "accuracy"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-4, rtol=1e-4)
    _assert_tree_close(state, jax.device_get(jstate), 1e-4)
    assert int(state["opt"]["step"]) == STEPS
    b = _batches(1, start=STEPS)[0]
    jev = jts.make_eval_step(jtc)(jstate["params"], b)
    ev = ts.make_eval_step(tc)(state["params"], b)
    assert set(ev) == set(jev)
    for k in ev:
        np.testing.assert_allclose(float(ev[k]), float(jev[k]), atol=1e-4, rtol=1e-4)


def test_master_copy_matches_jax_and_params_are_its_cast():
    """bf16 parameters with an fp32 master: the master within 1e-4 of JAX's
    after three steps, and the parameters its cast to bf16, bit for bit."""
    model = dict(param_dtype="bfloat16")
    jtc, tc = _configs()
    jtc = dataclasses.replace(jtc, model=dataclasses.replace(jtc.model, **model),
                              parallel=JaxParallelConfig(remat="none", master_dtype="float32"))
    tc = dataclasses.replace(tc, model=dataclasses.replace(tc.model, **model),
                             parallel=ParallelConfig(remat="none", master_dtype="float32"))
    jstate = _jax_state(jtc)
    state = interop.to_torch(jstate)
    assert state["opt"]["master"]["final_norm"].dtype == torch.float32
    jstep = jax.jit(jts.make_train_step(jtc))
    for b in _batches():
        jstate, _ = jstep(jstate, b)
    state, _ = _port_train(tc, state, _batches())
    jstate = jax.device_get(jstate)
    _assert_tree_close(state["opt"]["master"], jstate["opt"]["master"], 1e-4)
    for p, m in zip(interop.tree_leaves(state["params"]),
                    interop.tree_leaves(state["opt"]["master"])):
        assert p.dtype == torch.bfloat16
        assert torch.equal(_bits(p), _bits(m.to(torch.bfloat16)))
    # and the port builds the master itself from its own init
    own = ts.init_train_state(torch.Generator().manual_seed(0), tc, "cpu")
    assert interop.tree_leaves(own["opt"]["master"])[0].dtype == torch.float32


MIXED_ARCHS = ["deepseek-v2-lite-16b", "falcon-mamba-7b", "qwen3-moe-30b-a3b",
               "jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch", MIXED_ARCHS)
def test_master_copy_matches_jax_and_params_are_its_cast_on_mla_mamba_moe(arch):
    """The same check on the MLA, Mamba and MoE paths, whose products take
    bf16 parameters under the fp32 compute dtype as JAX's promoting einsums
    do: after each of three steps (the first at the warm-up's zero rate)
    the loss and, at the end, the master within 1e-4 of JAX's, the
    parameters its bf16 cast bit for bit."""
    model = dict(param_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_smoke_config(arch), **model)
    cfg = dataclasses.replace(get_smoke_config(arch), **model)
    jtc = JaxTrainConfig(model=jcfg, parallel=JaxParallelConfig(remat="none",
                                                                 master_dtype="float32"),
                         **TC_KW)
    tc = TrainConfig(model=cfg, parallel=ParallelConfig(remat="none", master_dtype="float32"),
                     **TC_KW)
    jstate = _jax_state(jtc)
    state = interop.to_torch(jstate)
    data = JaxSyntheticLM(jcfg.vocab_size, S, B, seed=0)
    jstep, step = jax.jit(jts.make_train_step(jtc)), ts.make_train_step(tc)
    for t in range(STEPS):
        batch = data.make_batch(t)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-4, rtol=1e-4)
    _assert_tree_close(state["opt"]["master"], jax.device_get(jstate)["opt"]["master"], 1e-4)
    for p, mst in zip(interop.tree_leaves(state["params"]),
                      interop.tree_leaves(state["opt"]["master"])):
        assert p.dtype == mst.to(p.dtype).dtype
        assert torch.equal(_bits(p), _bits(mst.to(p.dtype)))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_is_bit_equal_to_no_remat(remat):
    """Three steps with ``remat`` give the losses and every state leaf of
    three steps without it, bit for bit."""
    base_tc = _configs("none")[1]
    tc = _configs(remat)[1]
    init = ts.init_train_state(torch.Generator().manual_seed(0), base_tc, "cpu")
    copy = interop.tree_map(lambda t: t.clone(), init)
    a, la = _port_train(base_tc, init, _batches())
    b, lb = _port_train(tc, copy, _batches())
    assert torch.equal(_bits(la), _bits(lb))
    _assert_tree_bits(a, b)


def test_step_cache_gives_one_object_per_static_config():
    """Two trials of one arch (other learning rates) get the same step
    object; ``clear_step_cache`` empties the cache; the cached step trains."""
    ts.clear_step_cache()
    tc = _configs()[1]
    f1 = ts.get_compiled_train_step(tc)
    f2 = ts.get_compiled_train_step(dataclasses.replace(tc, learning_rate=1e-2))
    assert f1 is f2
    assert ts.get_compiled_train_step(_configs("full")[1]) is not f1
    assert len(ts._STEP_CACHE) == 2
    ts.clear_step_cache()
    assert not ts._STEP_CACHE and ts.get_compiled_train_step(tc) is not f1
    # the cached (state, batch, hp) form is make_train_step's numerics
    from repro_torch.optim.hparams import hparams_from_config

    init = ts.init_train_state(torch.Generator().manual_seed(0), tc, "cpu")
    copy = interop.tree_map(lambda t: t.clone(), init)
    a, la = _port_train(tc, init, _batches())
    for b in _batches():
        copy, m = ts.get_compiled_train_step(tc)(copy, b, hparams_from_config(tc))
    assert torch.equal(_bits(la[-1]), _bits(m["loss"]))
    _assert_tree_bits(a, copy)
    ts.clear_step_cache()


def _use_jax_init(monkeypatch, steps=STEPS):
    """The driver starts from the JAX init of the smoke config (seed 0)."""
    jtc = JaxTrainConfig(model=jax_smoke_config(ARCH))
    jstate = _jax_state(jtc)
    monkeypatch.setattr(ts, "init_train_state",
                        lambda gen, tc, device: interop.to_torch(jstate, device))
    return jstate


def _driver_lines(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    return ([float(ln.split()[3]) for ln in lines], [float(ln.split()[5]) for ln in lines],
            json.loads(out.strip().splitlines()[-1]))


def test_driver_losses_match_a_jax_loop_built_as_its_build(monkeypatch, capsys):
    """``python -m repro_torch.launch.train --smoke`` (microbatch 1, remat
    dots) prints a loss and an lr a step within 1e-4 of a JAX loop with the
    TrainConfig ``repro.launch.train.build`` makes (printed to 4 places, so
    against the JAX values rounded the same way); its JSON's first and last
    losses within 1e-4."""
    steps = 4
    jstate = _use_jax_init(monkeypatch)
    argv = ["--smoke", "--steps", str(steps), "--batch", str(B), "--seq", str(S),
            "--microbatch", "1", "--remat", "dots", "--log-every", "1", "--device", "cpu"]
    assert driver.main(argv) == 0
    losses, lrs, final = _driver_lines(capsys.readouterr().out)
    jtc = JaxTrainConfig(model=jax_smoke_config(ARCH),
                         parallel=JaxParallelConfig(microbatch=1, remat="dots"),
                         learning_rate=3e-3, warmup_steps=max(steps // 10, 1),
                         total_steps=steps, seed=0)
    jstep = jax.jit(jts.make_train_step(jtc))
    data = JaxSyntheticLM(jtc.model.vocab_size, S, B, seed=0)
    jl, jlr = [], []
    for t in range(steps):
        jstate, m = jstep(jstate, {k: np.asarray(v) for k, v in data.make_batch(t).items()})
        jl.append(float(m["loss"]))
        jlr.append(float(m["lr"]))
    assert len(losses) == steps
    np.testing.assert_allclose(losses, np.round(jl, 4), atol=1e-4 + 1e-9, rtol=0)
    np.testing.assert_allclose(lrs, [float(f"{x:.2e}") for x in jlr], rtol=1e-6)
    np.testing.assert_allclose([final["first_loss"], final["final_loss"]], [jl[0], jl[-1]],
                               atol=1e-4, rtol=1e-4)
    assert final["steps"] == steps


def test_killed_and_resumed_run_follows_the_reference_resume(tmp_path, capsys):
    """``--fail-at 6 --ckpt-every 4`` over 8 steps exits 17; the rerun prints
    ``resumed from checkpoint at step 4`` and ends in the state and the last
    loss of the port's step fed batches 0..4 and then 4..7 (the checkpoint
    after step 4 is stored as step 4 and the loop resumes there, as in the
    JAX driver), bit for bit."""
    ck = str(tmp_path / "ck")
    argv = ["--smoke", "--steps", "8", "--batch", str(B), "--seq", "16", "--log-every", "1",
            "--ckpt-dir", ck, "--ckpt-every", "4", "--device", "cpu"]
    assert driver.main(argv + ["--fail-at", "6"]) == 17
    first = capsys.readouterr()
    assert "simulated failure at step 6" in first.err
    assert Checkpointer(ck).all_steps() == [4]
    assert driver.main(argv) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 4" in out
    final = json.loads(out.strip().splitlines()[-1])
    got, manifest = Checkpointer(ck).restore()
    assert manifest["step"] == 8

    args = driver.parser().parse_args(argv)
    tc, data, step, dev = driver.build(args)
    state = ts.init_train_state(torch.Generator(device=dev).manual_seed(0), tc, dev)
    for t in list(range(5)) + list(range(4, 8)):
        state, m = step(state, data.make_batch(t))
    assert int(state["opt"]["step"]) == 9
    _assert_tree_bits(got, state)
    assert final["final_loss"] == float(m["loss"])


def test_driver_refuses_more_devices_and_a_missing_gpu(monkeypatch, capsys):
    """``--devices 2`` with ``--device cpu`` and no process group takes
    JAX's clamp (``min(--devices, devices)``): the run goes on one rank,
    says so, and trains as ``--devices 1``; without a GPU and without
    ``--device cpu`` the driver raises."""
    argv = ["--smoke", "--steps", "2", "--batch", str(B), "--seq", "16", "--log-every", "1",
            "--device", "cpu"]
    assert driver.main(argv + ["--devices", "2"]) == 0
    clamped = capsys.readouterr()
    assert "--devices 2: 1 cpu device(s) visible; the trial trains on 1" in clamped.err
    assert driver.main(argv) == 0
    assert _driver_lines(clamped.out)[0] == _driver_lines(capsys.readouterr().out)[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(["--smoke", "--steps", "1"])


def test_devices_above_the_ranks_there_are_train_on_those_ranks(monkeypatch, capfd):
    """JAX's clamp on a host with 2 of 4 devices: ``--devices 4`` starts two
    ranks, says so, and they train ``main``'s ``model`` as ``--devices 2``:
    the losses within 1e-4 of ``--devices 1``."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=1)
    argv = ["--smoke", "--steps", "3", "--batch", "4", "--seq", "16", "--log-every", "1",
            "--device", "cpu"]
    monkeypatch.setattr(hpo, "_ranks_to_spawn", lambda device: 2)
    assert driver.main(argv + ["--devices", "4"], model=cfg) == 0
    clamped = capfd.readouterr()
    assert "--devices 4: 2 cpu device(s) visible; the trial trains on 2" in clamped.err
    assert driver.main(argv, model=cfg) == 0
    want = _driver_lines(capfd.readouterr().out)
    got = _driver_lines(clamped.out)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4 + 1e-9, rtol=0)
    assert got[1] == want[1]


# -- --devices N: the trial mesh, on two gloo ranks ---------------------------------------

MESH_ARGV = ["--smoke", "--steps", "8", "--batch", "4", "--seq", "16", "--log-every", "1",
             "--device", "cpu"]
CKPT = ["--ckpt-every", "4"]


@pytest.fixture(scope="module")
def mesh_cli(tmp_path_factory):
    """The CLI at ``--devices 2`` on two spawned gloo ranks: an
    uninterrupted run; a run killed by ``--fail-at 6`` (resumed here at
    ``--devices 1``); the resume of a ``--devices 1`` run killed here
    first; a ``--devices`` that differs from the world.  Each rank's
    runs."""
    import torch_mesh_ranks as R
    from test_torch_sharded import COLLECTIVE_S, _join, _start

    root = tmp_path_factory.mktemp("mesh_cli")
    one_first = str(root / "one_first")
    assert driver.main(MESH_ARGV + CKPT + ["--ckpt-dir", one_first, "--fail-at", "6"]) == 17
    two_first = str(root / "two_first")
    argvs = [MESH_ARGV + ["--devices", "2"],
             MESH_ARGV + CKPT + ["--devices", "2", "--ckpt-dir", two_first, "--fail-at", "6"],
             MESH_ARGV + CKPT + ["--devices", "2", "--ckpt-dir", one_first],
             MESH_ARGV + ["--devices", "3"]]
    runs = _join(_start(2, str(root), R.trial_cli_rank, argvs, COLLECTIVE_S), str(root), 180.0)
    return {"runs": runs, "one_first": one_first, "two_first": two_first, "root": root}


def test_devices_2_prints_the_driver_lines_of_devices_1(mesh_cli, capsys):
    """``--devices 2`` over two gloo ranks: rank 0 prints the JAX driver's
    lines, rank 1 nothing; the losses within 1e-4 of ``--devices 1``."""
    capsys.readouterr()
    assert driver.main(MESH_ARGV) == 0
    want = _driver_lines(capsys.readouterr().out)
    r0, r1 = (r[0] for r in mesh_cli["runs"])
    assert r0["code"] == r1["code"] == 0 and r1["out"] == ""
    got = _driver_lines(r0["out"])
    np.testing.assert_allclose(got[0], want[0], atol=1e-4 + 1e-9, rtol=0)
    assert got[1] == want[1]
    np.testing.assert_allclose([got[2]["first_loss"], got[2]["final_loss"]],
                               [want[2]["first_loss"], want[2]["final_loss"]], atol=1e-4)
    assert got[2]["steps"] == 8


def _resumed_reference(root, capsys):
    """A ``--devices 1`` run killed at step 6 and resumed: its lines and its
    final checkpoint."""
    ck = str(root / "reference")
    assert driver.main(MESH_ARGV + CKPT + ["--ckpt-dir", ck, "--fail-at", "6"]) == 17
    capsys.readouterr()
    assert driver.main(MESH_ARGV + CKPT + ["--ckpt-dir", ck]) == 0
    return _driver_lines(capsys.readouterr().out), Checkpointer(ck).restore()[0]


def _assert_follows(lines, ck, want_lines, want_state):
    assert "resumed from checkpoint at step 4" in lines
    got = _driver_lines(lines)
    np.testing.assert_allclose(got[0], want_lines[0], atol=1e-4 + 1e-9, rtol=0)
    np.testing.assert_allclose(got[2]["final_loss"], want_lines[2]["final_loss"], atol=1e-4)
    state, manifest = Checkpointer(ck).restore()
    assert manifest["step"] == 8
    for a, b in zip(interop.tree_leaves(state), interop.tree_leaves(want_state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=1e-4, rtol=0)


def test_a_crash_under_devices_2_resumes_at_devices_1_and_back(mesh_cli, capsys):
    """``--fail-at 6`` exits 17 on both ranks after the step-4 checkpoint
    (the whole state, in ``--devices 1``'s format); resumed at ``--devices
    1`` it follows a ``--devices 1`` run killed and resumed the same way
    (the reference's resume: batch 4 twice), within 1e-4; so does a
    ``--devices 1`` run killed and resumed at ``--devices 2``."""
    want_lines, want_state = _resumed_reference(mesh_cli["root"], capsys)
    killed = [r[1] for r in mesh_cli["runs"]]
    assert [k["code"] for k in killed] == [17, 17]
    assert "simulated failure at step 6" in killed[0]["err"]
    assert Checkpointer(mesh_cli["two_first"]).all_steps() == [4]
    assert driver.main(MESH_ARGV + CKPT + ["--ckpt-dir", mesh_cli["two_first"]]) == 0
    _assert_follows(capsys.readouterr().out, mesh_cli["two_first"], want_lines, want_state)
    resumed = [r[2] for r in mesh_cli["runs"]]
    assert [r["code"] for r in resumed] == [0, 0] and resumed[1]["out"] == ""
    _assert_follows(resumed[0]["out"], mesh_cli["one_first"], want_lines, want_state)


def test_devices_that_differ_from_the_world_are_refused(mesh_cli):
    refused = [r[3] for r in mesh_cli["runs"]]
    assert [r["code"] for r in refused] == [2, 2]
    assert "--devices 3 differs from the process group's world of 2 ranks" in refused[0]["err"]


# -- --legacy-recompile (make_trial) ---------------------------------------------------

LEGACY = [dict(learning_rate=3e-3, warmup_frac=0.5, weight_decay=0.1, b2=0.95, grad_clip=1.0),
          dict(learning_rate=1e-2, warmup_frac=0.25, weight_decay=0.0, b2=0.99,
               grad_clip=0.0, n_iterations=2)]


def test_make_trial_equals_the_serial_driver_under_a_shared_stream(monkeypatch):
    """A fresh train step per trial gives the serial driver's score on the
    shared stream, bit for bit, and JAX's ``make_trial`` score within 1e-4
    (warmup_frac x steps is whole here: ``make_trial`` rounds it down)."""
    jstate = _use_jax_init(monkeypatch)
    monkeypatch.setattr("repro.train.train_step.init_train_state",
                        lambda key, tc: jax.tree.map(jax.numpy.asarray, jstate))
    legacy = hpo.make_trial(ARCH, 4, B, 16, 0, device="cpu")
    serial = hpo.PopulationTrial(ARCH, 4, B, 16, 0, per_trial_streams=False, device="cpu")
    want = jax_hpo.make_trial(ARCH, 4, B, 16, 0)
    for cfg in LEGACY:
        got = legacy(dict(cfg))
        assert np.isfinite(got)
        assert got == serial(dict(cfg))
        np.testing.assert_allclose(got, want(dict(cfg)), atol=1e-4, rtol=1e-4)


def test_legacy_recompile_cli_matches_the_jax_cli(monkeypatch, capsys):
    """``--legacy-recompile``: the JAX CLI's engine name, best config and a
    best score within 1e-4."""
    jstate = _use_jax_init(monkeypatch)
    monkeypatch.setattr("repro.train.train_step.init_train_state",
                        lambda key, tc: jax.tree.map(jax.numpy.asarray, jstate))
    argv = ["--n-samples", "2", "--steps", "3", "--batch", "2", "--seq", "16",
            "--legacy-recompile"]
    assert jax_hpo.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert hpo.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["engine"] == want["engine"] == "legacy-recompile"
    assert got["best_config"] == want["best_config"]
    np.testing.assert_allclose(got["best_score"], want["best_score"], atol=1e-4, rtol=1e-4)
