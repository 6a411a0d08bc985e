#!/usr/bin/env python3
"""Summarise the port's dry-run sweep (``python -m repro_torch.launch.dryrun
--all``): per mesh, the cells ok, skipped and failed, the cells whose rank
fits the card's memory, the cells by binding roofline term, the five lowest
roofline fractions, and the bytes a rank moves because the port computes
whole what its rank stores split over the model axis:

* lever Q: the vocab-split embedding (and an untied unembedding) gathered
  whole at use, one all-gather a forward pass (a train cell's microbatch,
  a prefill, a decode step);
* lever R: the rest of the model axis's all-gathers, attention whose kv
  heads do not divide the model axis gathered whole at use.

Every number is a reckoning of ``launch/dryrun.py`` with the NVIDIA H100
80GB HBM3 (700 W) constants of ``launch/roofline.py``, not a measurement.

    python3 tools/dryrun_summary.py [--dir artifacts/dryrun_torch] [--json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

MESHES = {"pod_16x16": 16, "multipod_2x16x16": 16}   # model-axis ranks


def forward_passes(rec) -> int:
    """Forward passes of one rank's step: a train cell's microbatches (each
    forward gathers the embedding once; its remat recompute stays inside
    the superblocks), else one."""
    if rec["kind"] != "train":
        return 1
    micro = rec["parallel"]["microbatch"]
    from repro_torch.configs.base import SHAPES

    gb = SHAPES[rec["shape"]].global_batch
    return gb // micro if micro else 1


def levers(rec, model: int) -> dict:
    """The model-axis all-gather bytes of a rank's step split into lever Q
    (the embedding tables) and lever R (the rest): operand and wire bytes.
    A table is stored in blocks over the model axis (its vocab) and the
    data axes (its ``embed`` dim); the model axis's gather takes the stored
    block, before the data axes' gather."""
    from repro_torch.configs import get_config

    cfg = get_config(rec["arch"])
    item = 2 if cfg.param_dtype == "bfloat16" else 4
    tables = 1 if cfg.tie_embeddings else 2
    data = 1
    for axis, n in zip(rec["mesh"]["axes"], rec["mesh"]["shape"]):
        data *= n if axis != "model" else 1
    block = cfg.vocab_size * cfg.d_model * item // model
    if cfg.d_model % data == 0:
        block //= data
    q_operand = (tables * block * forward_passes(rec) if cfg.vocab_size % model == 0 else 0)
    gathered = rec["op_cost"]["collectives_by_axis"].get("model/all-gather",
                                                         {"operand_bytes": 0})
    operand = gathered["operand_bytes"]
    return {"q_operand_bytes": q_operand, "q_wire_bytes": q_operand * (model - 1),
            "r_operand_bytes": operand - q_operand,
            "r_wire_bytes": (operand - q_operand) * (model - 1)}


def summarise(out_dir: str) -> dict:
    out = {}
    for mesh, model in MESHES.items():
        recs = [json.load(open(p)) for p in sorted(glob.glob(os.path.join(out_dir, mesh,
                                                                       "*.json")))]
        ok = [r for r in recs if r["status"] == "ok"]
        by_term: dict = {}
        for r in ok:
            by_term[r["roofline"]["bottleneck"]] = by_term.get(r["roofline"]["bottleneck"], 0) + 1
        lowest = sorted(ok, key=lambda r: r["roofline"]["roofline_fraction"])[:5]
        out[mesh] = {
            "cells": len(recs), "ok": len(ok),
            "skipped": sum(r["status"] == "skipped" for r in recs),
            "failed": [f"{r['arch']}:{r['shape']}" for r in recs
                       if r["status"] not in ("ok", "skipped")],
            "fit": sum(bool(r["fits"]) for r in ok),
            "do_not_fit": [f"{r['arch']}:{r['shape']} {r['peak_bytes'] / 1e9:.1f} GB"
                           for r in ok if not r["fits"]],
            "by_binding_term": by_term,
            "lowest_roofline_fraction": [
                f"{r['arch']}:{r['shape']} {r['roofline']['roofline_fraction']:.4g} "
                f"({r['roofline']['bottleneck']})" for r in lowest],
            "levers_q_r": {f"{r['arch']}:{r['shape']}": levers(r, model) for r in ok},
            "cells_detail": {f"{r['arch']}:{r['shape']}": {
                "terms_s": [r["roofline"]["compute_s"], r["roofline"]["memory_s"],
                            r["roofline"]["collective_s"]],
                "bottleneck": r["roofline"]["bottleneck"],
                "roofline_fraction": r["roofline"]["roofline_fraction"],
                "argument_bytes": r["memory_analysis"]["argument_size_in_bytes"],
                "temp_bytes": r["memory_analysis"]["temp_size_in_bytes"],
                "fits": r["fits"], "trace_s": r["trace_s"]} for r in ok},
        }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dir", default=os.environ.get("REPRO_TORCH_DRYRUN_DIR",
                                                   "artifacts/dryrun_torch"))
    p.add_argument("--json", action="store_true", help="print the whole summary as JSON")
    args = p.parse_args(argv)
    got = summarise(args.dir)
    if args.json:
        print(json.dumps(got, indent=1))
        return 0
    for mesh, s in got.items():
        print(f"== {mesh}: {s['ok']} ok, {s['skipped']} skipped, failed {s['failed']}; "
              f"{s['fit']} fit the card; by term {s['by_binding_term']}")
        print("   lowest roofline fractions:", "; ".join(s["lowest_roofline_fraction"]))
        print("   do not fit:", "; ".join(s["do_not_fit"]) or "none")
        for cell, lv in s["levers_q_r"].items():
            if lv["q_operand_bytes"] or lv["r_operand_bytes"]:
                print(f"   {cell}: Q {lv['q_operand_bytes'] / 1e9:.3f} GB operand "
                      f"({lv['q_wire_bytes'] / 1e9:.2f} GB wire), R "
                      f"{lv['r_operand_bytes'] / 1e9:.3f} GB ({lv['r_wire_bytes'] / 1e9:.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
