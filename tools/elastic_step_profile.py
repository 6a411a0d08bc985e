#!/usr/bin/env python3
"""Where a per-step population step's time goes at the lane counts an
elastic flight regrids through, on one GPU.

    python3 tools/elastic_step_profile.py

At ``chip_smoke.py``'s elastic phase (a) widths (starcoder2-3b published
widths, ``MAIN``'s 4 layers, batch 4, seq 1024), for K = 4, 2 and 1 lanes
it times steady population steps on device-resident batches and profiles one
(``chip_smoke.steady_state_step``: s a step, the device's busy ms and idle
share, device ms by kernel group).  K = 2 and 1 run twice: with the RMSNorm
backward planned for their own K (a fixed-width flight of K lanes) and
planned for 4 lanes (``rmsnorm.plan_lanes(4)``, an elastic flight's
survivors after a regrid from K = 4); K = 1 repeats both at the end, so a
drift of the card's clock shows.

Then the per-step batch flights of ``chip_smoke.py``'s elastic phase (a)
(``ELASTIC_BATCH``'s trials): the fixed-width flight of its four trials, the
elastic flight (K 4 -> 2 -> 1) and a fixed-width flight of its first trial
alone (K = 1), each timed per dispatch (``trial.dispatch_times``: the step
alone, synchronized before and after) and run again under
``torch.profiler``: the device's busy ms a step over the whole flight and
the host ops with the most self time.  Prints the card's name and power
limit, then one JSON line per run.  Compare runs only within one call.
"""
from __future__ import annotations

import contextlib
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import (ELASTIC, ELASTIC_BATCH, MAIN, _elastic_configs,  # noqa: E402
                        _elastic_trial, nvidia_smi, published_widths, steady_state_step)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.launch.hpo import PopulationTrial  # noqa: E402

RUNS = ((4, None), (2, None), (2, 4), (1, None), (1, 4), (1, 4), (1, None))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    build.library()
    print(nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    # the elastic flights' training config, as their trials make it
    tc, _ = PopulationTrial(ELASTIC["arch"], 16, ELASTIC["batch"], ELASTIC["seq"], 0,
                            population=ELASTIC["population"], device=dev,
                            model_overrides=published_widths(ELASTIC["arch"],
                                                             MAIN["n_layers"]))._setup()
    for k, plan in RUNS:
        with rn.plan_lanes(plan) if plan else contextlib.nullcontext():
            got = steady_state_step(torch, dev, tc, ELASTIC["batch"], ELASTIC["seq"], k)
        prof = got["profile"]
        print(json.dumps({"lanes": k, "rmsnorm_bwd_planned_for": plan or k,
                          "s_per_step": got["steady_s_per_step"],
                          "device_ms": prof.get("device_ms"),
                          "wall_ms": prof.get("wall_ms"),
                          "idle_share": prof.get("idle_share"),
                          "groups_ms": prof.get("groups_ms"),
                          "peak_memory_gib": got["peak_memory_gib"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    configs = _elastic_configs(ELASTIC_BATCH)
    for name, k, elastic in (("fixed", 4, False), ("elastic", 4, True),
                             ("fixed_one_trial", 1, False)):
        print(json.dumps(dict(flight(dev, k, elastic, configs[:k], False), flight=name)),
              flush=True)
        print(json.dumps(dict(flight(dev, k, elastic, configs[:k], True), flight=name)),
              flush=True)
    return 0


def flight(dev, k, elastic, configs, profiled):
    """One per-step batch flight of ``configs`` at ``MAIN``'s depth: s a
    dispatch by lanes (the median past each lane count's first); profiled,
    also the device's busy ms a step and the top host ops by self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trial = _elastic_trial(dev, ELASTIC["arch"], MAIN["n_layers"], k, ELASTIC["batch"],
                           ELASTIC["seq"], ELASTIC_BATCH, 1, elastic)
    trial.dispatch_times = []
    torch.cuda.synchronize()
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    with ctx as prof:
        trial.run_population(list(configs))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_k = {}
    for lanes, _, s in trial.dispatch_times:
        by_k.setdefault(lanes, []).append(s)
    out = {"lanes_seen": [list(x) for x in trial.lane_width_history], "profiled": profiled,
           "steps": trial.n_train_steps, "wall_s": wall,
           "s_per_dispatch": {str(n): statistics.median(v[1:] or v) for n, v in by_k.items()}}
    if profiled:
        events = prof.events()
        busy = sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == DeviceType.CUDA) / 1e3
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
        out.update(device_busy_ms_per_step=busy / trial.n_train_steps,
                   top_host_self_ms=[[e.key[:60], e.self_cpu_time_total / 1e3, e.count]
                                     for e in host])
    del trial
    gc.collect()
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
