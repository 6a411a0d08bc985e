#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   for sm_90a and load them;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main path's shapes in bf16 and fp32 and on small window / softcap /
   ragged cases (TF32 off);
4. main_path — the HPO population trainer: the port's Experiment with the
   random proposer and the vectorized resource manager, training K=4 trials
   of starcoder2-3b at its published widths (depth cut to 4 layers) as one
   lane-batched program; the kernels' launch counters must show every
   population step went through both kernels;
5. card_vs_cpu — the same population step on the starcoder2 smoke config in
   fp32, once on the card (kernels) and once on the CPU (plain versions):
   losses and parameters agree within 1e-4;
6. timing — each kernel, its plain version and the PyTorch library call
   that computes the same function, timed with CUDA events at the main
   path's shapes, beside the least time the card could take.

The line before last repeats the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero.
Without a GPU, or outside a checkout of the repository, the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

EPS = 1e-6
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core bf16
            "float32": 67e12}      # fp32 outside the tensor cores
TOL = {"rmsnorm": {"float32": 1e-5, "bfloat16": 3e-2},
       "flash_attention": {"float32": 3e-5, "bfloat16": 3e-2}}

# the main path: starcoder2-3b at its published widths, depth cut 30 -> 4
MAIN = dict(arch="starcoder2-3b", n_layers=4, population=4, batch=4, seq=1024, steps=4)
RMS_SHAPE = (4, 4096, 3072)                        # (K, B*S, d), gain (K, d)
FLASH_Q, FLASH_KV = (16, 1024, 24, 128), (16, 1024, 2, 128)   # (K*B, S, heads, D)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def die(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------- phase 3
def check_kernels(torch, dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=dev).manual_seed(0)
    cases, errs = [], {}

    def rms(shape, dtype):
        K, _, d = shape
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        g = (0.1 * torch.randn((K, d), generator=gen, device=dev)).to(dtype)
        return rn.rmsnorm_cuda(x, g, EPS), rn.rmsnorm_plain(x, g, EPS)

    def flash(qs, kvs, dtype, **kw):
        q = torch.randn(qs, generator=gen, device=dev).to(dtype)
        k = torch.randn(kvs, generator=gen, device=dev).to(dtype)
        v = torch.randn(kvs, generator=gen, device=dev).to(dtype)
        kw = dict(dict(causal=True, window=None, softcap=None), **kw, scale=qs[-1] ** -0.5)
        (o, l), (po, pl) = fa.flash_fwd_cuda(q, k, v, **kw), fa.flash_fwd_plain(q, k, v, **kw)
        return torch.cat([o.float().flatten(), l.flatten()]), \
            torch.cat([po.float().flatten(), pl.flatten()])

    runs = [
        ("rmsnorm", "main", "bfloat16", lambda: rms(RMS_SHAPE, torch.bfloat16)),
        ("rmsnorm", "main", "float32", lambda: rms(RMS_SHAPE, torch.float32)),
        ("rmsnorm", "d=100", "float32", lambda: rms((2, 33, 100), torch.float32)),
        ("flash_attention", "main", "bfloat16",
         lambda: flash(FLASH_Q, FLASH_KV, torch.bfloat16)),
        ("flash_attention", "main", "float32",
         lambda: flash(FLASH_Q, FLASH_KV, torch.float32)),
        ("flash_attention", "window", "float32",
         lambda: flash((2, 256, 4, 64), (2, 256, 2, 64), torch.float32, window=48)),
        ("flash_attention", "softcap", "float32",
         lambda: flash((2, 192, 4, 32), (2, 192, 1, 32), torch.float32, softcap=30.0)),
        ("flash_attention", "ragged-200", "float32",
         lambda: flash((2, 200, 4, 16), (2, 200, 2, 16), torch.float32, window=64,
                       softcap=50.0)),
        ("flash_attention", "ragged-200", "bfloat16",
         lambda: flash((2, 200, 4, 16), (2, 200, 2, 16), torch.bfloat16)),
    ]
    for name, case, dtype, run in runs:
        got, want = run()
        torch.cuda.synchronize()
        tol = TOL[name][dtype]
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
        cases.append(dict(kernel=name, case=case, dtype=dtype, max_abs_err=err, tol=tol,
                          ok=ok))
        if case == "main" and dtype == "bfloat16":
            errs[name] = err
        del got, want
    emit({"phase": "kernels", "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        die(f"kernels disagree with their plain versions: {bad}")
    return errs


# ------------------------------------------------------------------- phase 4
def main_path(torch, dev, arch, n_layers, population, batch, seq, steps, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.core.experiment import Experiment
    from repro_torch.core.job import JobStatus
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.hpo import SPACE, PopulationTrial

    full = get_config(arch)
    overrides = {f.name: getattr(full, f.name) for f in dataclasses.fields(full)
                 if f.name != "name"}
    overrides["n_layers"] = n_layers
    trial = PopulationTrial(arch, steps, batch, seq, seed, population=population,
                            model_overrides=overrides, device=dev)
    exp = Experiment({"proposer": "random", "parameter_config": SPACE,
                      "n_samples": population, "n_parallel": population,
                      "target": "max", "random_seed": seed, "resource": "vectorized"},
                     trial)
    jobs = []
    exp.add_result_callback(jobs.append)
    torch.cuda.synchronize()
    rn.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    best = exp.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rn.launches, "flash_attention": fa.launches}

    tc, _ = trial._setup()
    cfg = tc.model
    per_step = {"rmsnorm": 2 * cfg.n_layers + 1, "flash_attention": cfg.n_layers}
    scores = [None if j.result is None else j.result.score for j in jobs]
    out = {
        "phase": "main_path", "arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size, "param_dtype": cfg.param_dtype,
        "population": population, "batch": batch, "seq": seq, "steps_per_trial": steps,
        "population_steps": trial.n_train_steps, "flight_steps": trial.last_flight_steps,
        "jobs": len(jobs), "statuses": [j.status.name for j in jobs], "scores": scores,
        "best_score": best["score"], "launches": launches,
        "launches_per_step": per_step, "wall_s": wall,
        "flight_s_per_step": trial.per_rung_step_time_s[-1][2]
        if trial.per_rung_step_time_s else None,
    }
    del exp, trial
    gc.collect()
    torch.cuda.empty_cache()
    out.update(steady_state_step(torch, dev, tc, batch, seq, population))
    emit(out)
    problems = []
    if len(jobs) != population or any(j.status != JobStatus.FINISHED for j in jobs):
        problems.append("not every trial finished")
    if out["flight_steps"] != steps or out["population_steps"] != steps:
        problems.append("the flight did not train every lane's budget")
    if not any(s is not None and s == s and abs(s) < 1e8 for s in scores):
        problems.append("no finite score")
    for name, n in per_step.items():
        if launches[name] != n * steps:
            problems.append(f"{name}: {launches[name]} launches, want {n} x {steps}")
    if problems:
        die("main path: " + "; ".join(problems))
    return launches, out


def steady_state_step(torch, dev, tc, batch, seq, population, warmup=1, timed=3):
    """Time population steps of the main-path model after a warm-up step, on
    device-resident batches (host clock around synchronize)."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
    from repro_torch.train.population import (init_population_state,
                                              make_population_train_step)

    data = SyntheticLM(tc.model.vocab_size, seq, batch, seed=0)
    torch.cuda.reset_peak_memory_stats()
    pstate = init_population_state(torch.Generator(device=dev).manual_seed(0), tc,
                                   population, dev)
    n = warmup + timed
    hp = stack_hparams([hparams_from_dict(dict(learning_rate=1e-3, total_steps=n), tc)]
                       * population, dev)
    step = make_population_train_step(tc)
    streams = list(range(population))
    batches = [to_device(data.make_population_batch(t, streams), dev) for t in range(n)]
    for t in range(warmup):
        pstate, _ = step(pstate, batches[t], hp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(warmup, n):
        pstate, m = step(pstate, batches[t], hp)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / timed
    peak = torch.cuda.max_memory_allocated()
    tokens = population * batch * seq
    prof = profile_step(torch, lambda: step(pstate, batches[-1], hp))
    del pstate, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"steady_s_per_step": per_step, "steady_tokens_per_s": tokens / per_step,
            "peak_memory_gib": peak / 2 ** 30, "profile": prof}


KERNEL_GROUPS = (  # (group, substrings of the device kernel's name)
    ("flash_attention_fwd (ours)", ("flash_fwd_kernel",)),
    ("rmsnorm (ours)", ("rmsnorm_kernel",)),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy / fill", ("memcpy", "memset", "copy", "fill")),
)


def profile_step(torch, fn, top=12):
    """Device time of one steady population step by kernel, from
    ``torch.profiler``; the device's busy and idle share of the step's wall
    time.  Reports no split where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        kernels.append((e.key, us / 1e3, e.count))
    busy = sum(ms for _, ms, _ in kernels)
    if busy <= 0:
        return {"wall_ms": wall_ms, "device_ms": None, "note": "no device time in the trace"}
    groups = {}
    for name, ms, _ in kernels:
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        groups[g] = groups.get(g, 0.0) + ms
    kernels.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": max(0.0, 1 - busy / wall_ms),
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                            for n, ms, c in kernels[:top]]}


# ------------------------------------------------------------------- phase 5
def card_vs_cpu(torch, dev, steps=3, population=2, batch=2, seq=128):
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.interop import tree_leaves, tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
    from repro_torch.train.population import (init_population_state_from_keys,
                                              make_population_train_step)

    tc = TrainConfig(model=get_smoke_config("starcoder2-3b"),
                     parallel=ParallelConfig(remat="none"))
    data = SyntheticLM(tc.model.vocab_size, seq, batch, seed=0)
    cpu = init_population_state_from_keys(
        [torch.Generator().manual_seed(i) for i in range(population)], tc, "cpu")
    card = tree_map(lambda t: t.to(dev, copy=True), cpu)
    cfgs = [dict(learning_rate=3e-3 * (i + 1), warmup_frac=0.34, weight_decay=0.1,
                 b2=0.95, grad_clip=1.0 - 0.5 * i, total_steps=steps)
            for i in range(population)]
    hps = [hparams_from_dict(c, tc) for c in cfgs]
    step = make_population_train_step(tc)
    before = (rn.launches, fa.launches)
    loss_err = 0.0
    for t in range(steps):
        b = data.make_population_batch(t, list(range(population)))
        cpu, mc = step(cpu, to_device(b, "cpu"), stack_hparams(hps, "cpu"))
        card, mg = step(card, to_device(b, dev), stack_hparams(hps, dev))
        loss_err = max(loss_err, float((mg["loss"].cpu() - mc["loss"]).abs().max()))
    ok = loss_err <= 1e-4
    param_err = 0.0
    for a, b in zip(tree_leaves(card["inner"]["params"]), tree_leaves(cpu["inner"]["params"])):
        a = a.cpu()
        param_err = max(param_err, float((a - b).abs().max()))
        ok = ok and bool(torch.allclose(a, b, atol=1e-4, rtol=1e-4))
    through = (rn.launches - before[0], fa.launches - before[1])
    emit({"phase": "card_vs_cpu", "config": tc.model.name, "dtype": tc.model.param_dtype,
          "population": population, "seq": seq, "steps": steps, "loss_max_abs_err": loss_err,
          "param_max_abs_err": param_err, "tol": 1e-4,
          "card_launches": {"rmsnorm": through[0], "flash_attention": through[1]}})
    if not ok:
        die(f"card and CPU disagree: loss {loss_err}, params {param_err}")
    if min(through) <= 0:
        die("the card's population step did not go through both kernels")


# ------------------------------------------------------------------- phase 6
def event_ms(torch, fn, n=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_kernels(torch, dev, errs, launches):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=dev).manual_seed(1)
    dt, dts = torch.bfloat16, "bfloat16"
    rows = []

    K, R, d = RMS_SHAPE
    x = torch.randn(RMS_SHAPE, generator=gen, device=dev).to(dt)
    g = (0.1 * torch.randn((K, d), generator=gen, device=dev)).to(dt)
    w = (1.0 + g.float()).to(dt)
    nb = 2 * x.numel() * x.element_size() + g.numel() * g.element_size()
    b_ms, b_by = bound_ms(nb, 4 * x.numel(), "float32")
    rows.append({
        "name": "rmsnorm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:19", "launches": launches["rmsnorm"],
        "max_abs_err": errs["rmsnorm"],
        "ms": event_ms(torch, lambda: rn.rmsnorm_cuda(x, g, EPS)),
        "plain_ms": event_ms(torch, lambda: rn.rmsnorm_plain(x, g, EPS)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": event_ms(torch, lambda: [F.rms_norm(x[k], (d,), weight=w[k], eps=EPS)
                                               for k in range(K)]),
        "shape": {"x": list(RMS_SHAPE), "gamma": [K, d], "dtype": dts},
    })
    del x, g, w

    B, S, H, D = FLASH_Q
    Hkv = FLASH_KV[2]
    q = torch.randn(FLASH_Q, generator=gen, device=dev).to(dt)
    k = torch.randn(FLASH_KV, generator=gen, device=dev).to(dt)
    v = torch.randn(FLASH_KV, generator=gen, device=dev).to(dt)
    kw = dict(causal=True, window=None, softcap=None, scale=D ** -0.5)
    pairs = S * (S + 1) // 2                       # unmasked (q, k) pairs per head
    n_ops = 2 * B * H * pairs * (D + D)
    nb = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size() + B * H * S * 4
    b_ms, b_by = bound_ms(nb, n_ops, dts)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rows.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:39",
        "launches": launches["flash_attention"], "max_abs_err": errs["flash_attention"],
        "ms": event_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, **kw), n=10),
        "plain_ms": event_ms(torch, lambda: fa.flash_fwd_plain(q, k, v, **kw), n=5, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": event_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), n=10),
        "shape": {"q": list(FLASH_Q), "kv": list(FLASH_KV), "causal": True, "dtype": dts},
    })
    return rows


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        die(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib.name,
          "sources": [s.name for s in build.sources()], "flags": build.NVCC_FLAGS})

    errs = check_kernels(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    launches, _ = main_path(torch, dev, **MAIN)
    card_vs_cpu(torch, dev)
    emit({"kernels": time_kernels(torch, dev, errs, launches)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
