"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) cell.

The twin of the JAX package's ``launch/dryrun.py``.  JAX lowers and compiles
each cell's production step for 256 or 512 placeholder host devices and
reads the compiled program.  The port compiles nothing, so it runs the step
of rank 0 once, on the meta device, over a fake process group of the
mesh's world, and walks the ops it dispatches:

* the mesh: ``launch/mesh.py::make_production_mesh`` over a ``fake``
  process group of 256 or 512 ranks at rank 0
  (``torch.testing._internal.distributed.fake_pg``: its collectives do
  nothing, and on meta tensors cost nothing);
* the state: rank 0's blocks, placed by ``build_sharding`` and made on the
  meta device: the train state of the sharded train step
  (``train_step.make_sharded_train_step``; ``--set zero_stage=zero1``
  places the parameters replicated over the data axes), or the parameters
  and the bf16 decode cache of ``train/serve_step.py::ServeLayout``;
* the step, once, under ``op_cost.OpCostWalk``: ``train_*`` cells the
  sharded train step (``memory_policy``'s microbatching, remat and
  optimizer dtypes), ``prefill_*`` cells ``forward(..., last_only=not
  encoder_only)`` on the rank's rows, ``decode_*`` and ``long_500k`` cells
  one ``decode_step`` at the last position of a ``seq_len``-deep cache;
* the record, under JAX's keys wherever the quantity is the same
  (``memory_analysis``, ``op_cost`` for ``hlo_cost``, ``roofline``,
  ``param_counts``, ``status``), ``trace_s`` for ``lower_s`` /
  ``compile_s``, and ``fits``: arguments plus temporaries at or below the
  card's memory (``roofline.CARD_MEMORY_BYTES``).

A train cell on a world of one (``lower_cell(..., mesh_shape=(1, 1))``)
runs the unsharded step, as ``launch/train.py --devices 1`` does.  Nothing
is allocated on any device.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
    python -m repro_torch.launch.dryrun --arch gemma2-9b --shape decode_32k --multi-pod
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--force]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional, Sequence

ARTIFACT_DIR = os.environ.get("REPRO_TORCH_DRYRUN_DIR", "artifacts/dryrun_torch")
DEVICE = "meta"


# --------------------------------------------------------------------------------------
def input_specs(arch: str, shape, model=None) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input of this cell (the whole
    batch; ``shape`` a ``ShapeConfig`` or its name; ``model`` replaces the
    arch's config)."""
    import torch

    from ..configs import get_config
    from ..configs.base import SHAPES

    cfg = model if model is not None else get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    gb, S = shape.global_batch, shape.seq_len

    def sds(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=DEVICE)

    if shape.kind in ("train", "prefill"):
        if cfg.frontend != "none":
            batch = {"embeds": sds((gb, S, cfg.d_model), torch.bfloat16)}
        else:
            batch = {"tokens": sds((gb, S), torch.int32)}
        if shape.kind == "train":
            batch["targets"] = sds((gb, S), torch.int32)
            batch["mask"] = sds((gb, S), torch.float32)
        return batch
    # decode: one new token against a seq_len-deep cache
    return {"tokens": sds((gb, 1), torch.int32), "pos": S - 1}


def _apply_overrides(cfg, pc, overrides):
    """--set key=value overrides: model fields go to ModelConfig, run-policy
    fields to ParallelConfig.  Values parse as int/float/str."""

    def parse(v):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                continue
        return v

    mfields = {f.name for f in dataclasses.fields(cfg)}
    pfields = {f.name for f in dataclasses.fields(pc)}
    for kv in overrides or []:
        k, _, v = kv.partition("=")
        v = parse(v)
        if k in mfields:
            cfg = dataclasses.replace(cfg, **{k: v})
        elif k in pfields:
            pc = dataclasses.replace(pc, **{k: v})
        else:
            raise KeyError(f"--set {k}: not a ModelConfig or ParallelConfig field")
    return cfg, pc


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks at rank 0 while the context
    lasts (a group already initialised is used as it is, if its world is
    ``world``)."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is "
                               f"initialised; the cell needs {world}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_axes(mesh_shape: Sequence[int]) -> tuple:
    return ("pod", "data", "model")[-len(mesh_shape):]


def _group_ranks(mesh, axis: str) -> list:
    """The global ranks of rank 0's group along ``axis`` (``a+b`` joins
    axes)."""
    import itertools

    names, sizes = list(mesh.shape), list(mesh.shape.values())
    axes = axis.split("+")
    ranks = []
    for coords in itertools.product(*(range(s) if n in axes else (0,)
                                      for n, s in zip(names, sizes))):
        r = 0
        for c, s in zip(coords, sizes):
            r = r * s + c
        ranks.append(r)
    return ranks


def lower_cell(
    arch: str,
    shape_name: Optional[str] = None,
    multi_pod: bool = False,
    save_ops: Optional[str] = None,
    overrides=None,
    shape=None,
    mesh_shape: Optional[Sequence[int]] = None,
    model=None,
) -> Dict[str, Any]:
    """One cell's record.  ``shape`` (a ``ShapeConfig``), ``mesh_shape`` and
    ``model`` (a ``ModelConfig``) replace the named shape, the production
    mesh and the arch's published config."""
    import torch

    from ..configs import get_config, memory_policy
    from ..configs.base import SHAPES, TrainConfig
    from ..distributed.sharding import grid_mesh
    from ..train import train_step as ts
    from ..train.serve_step import ServeLayout
    from . import roofline
    from .mesh import PRODUCTION, make_production_mesh
    from .op_cost import OpCostWalk

    cfg = model if model is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    pc = memory_policy(arch, shape, multi_pod=multi_pod)
    tp = None
    rest = []
    for kv in overrides or []:
        if kv.startswith("tp="):
            tp = int(kv.split("=")[1])
        else:
            rest.append(kv)
    cfg, pc = _apply_overrides(cfg, pc, rest)
    if mesh_shape is None and tp is not None:
        # the same rank count, another (data, model) split
        n = 512 if multi_pod else 256
        mesh_shape = (2, (n // 2) // tp, tp) if multi_pod else (n // tp, tp)
    axes, shp = ((_mesh_axes(mesh_shape), tuple(mesh_shape)) if mesh_shape is not None
                 else PRODUCTION[bool(multi_pod)])
    pc = dataclasses.replace(pc, mesh_shape=shp, mesh_axes=axes)
    n_chips = 1
    for s in shp:
        n_chips *= s
    tc = TrainConfig(model=cfg, parallel=pc)

    record: Dict[str, Any] = {
        "arch": arch,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": {"shape": list(shp), "axes": list(axes)},
        "overrides": list(overrides or []),
        "parallel": {
            "zero_stage": pc.zero_stage,
            "microbatch": pc.microbatch,
            "remat": pc.remat,
            "mu_dtype": pc.mu_dtype,
            "nu_dtype": pc.nu_dtype,
            "grad_allreduce_dtype": pc.grad_allreduce_dtype,
            "shard_cache_seq": pc.shard_cache_seq,
        },
    }
    gen = torch.Generator()
    batch = input_specs(arch, shape, cfg)
    t0 = time.time()
    # one rank's train step is the unsharded one (``--devices 1``) and needs
    # no process group; every other cell runs on the grid
    one = shape.kind == "train" and n_chips == 1
    production = shp == PRODUCTION[bool(multi_pod)][1]
    with contextlib.nullcontext() if one else fake_group(n_chips):
        mesh = (None if one else make_production_mesh(multi_pod=multi_pod, device=DEVICE)
                if production else grid_mesh(axes, shp, DEVICE))
        if shape.kind == "train":
            if one:
                state = ts.init_train_state(gen, tc, DEVICE)
                step = ts.make_train_step(tc)
            else:
                step = ts.make_sharded_train_step(tc, mesh)
                state = step.layout.init_state(gen)
            args, fn = (state, batch), step
        else:
            layout = ServeLayout(cfg, mesh, shard_cache_seq=pc.shard_cache_seq)
            params = layout.init_params(gen)
            gb, S = shape.global_batch, shape.seq_len
            if shape.kind == "prefill":
                rows = layout.rows(gb)
                args = (params, {k: v[rows] for k, v in batch.items()})
                fn = lambda p, b: layout.prefill(p, b.get("tokens"), b.get("embeds"))  # noqa: E731
            else:
                cache = layout.init_cache(gb, S, torch.bfloat16)
                args = (params, cache, batch["tokens"][layout.rows(gb, S)])
                # the cache, written in place, is an output, as JAX's donated one
                fn = lambda p, c, t: (layout.decode(p, c, t, batch["pos"], gb, S), c)  # noqa: E731
        with OpCostWalk(args, ops_log=save_ops is not None) as w:
            out = fn(*args)
        totals, mem = w.totals, w.memory(out)
        link = roofline.link_bw(_group_ranks(mesh, k.split("/")[0])
                                for k in totals.coll_by_axis)
    record["trace_s"] = round(time.time() - t0, 2)
    if save_ops:
        with open(save_ops, "w") as f:
            for op in w.ops_log:
                f.write(json.dumps(op) + "\n")
    record["memory_analysis"] = mem.to_json()
    record["op_cost"] = {
        "flops": totals.flops,
        "bytes": totals.bytes,
        "bytes_bf16eq": totals.bytes_bf16eq,
        "kernel_flops": totals.kernel_flops,
        "kernel_bytes_bf16eq": totals.kernel_bytes_bf16eq,
        "coll_operand_bytes": totals.coll_operand,
        "coll_wire_bytes": totals.coll_wire,
        "coll_tpu_wire_bytes": totals.coll_tpu_wire,
        "per_collective": totals.per_op,
        "dot_flops": totals.dot_flops,
        "op_bytes": totals.op_bytes,
        "kernels": totals.kernels,
        "collectives_by_axis": totals.coll_by_axis,
        "n_ops": totals.n_ops,
    }
    counts = cfg.param_counts()
    tokens_global = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    # the kernels' bytes are their own HBM traffic: nothing to subtract
    rl = roofline.analyse(
        flops_dev=totals.flops,
        bytes_bf16eq_dev=totals.bytes_bf16eq,
        kernel_bytes_bf16eq_dev=0.0,
        bytes_raw_dev=totals.bytes,
        wire_bytes_dev=totals.coll_tpu_wire,
        n_params_active=counts["active"],
        tokens_global=tokens_global,
        kind=shape.kind,
        n_chips=n_chips,
        ici_bw=link,
    )
    record["roofline"] = rl.to_json()
    record["link_bytes_per_s"] = link
    record["param_counts"] = {k: float(v) for k, v in counts.items()}
    peak = mem.argument_size_in_bytes + mem.temp_size_in_bytes
    record["peak_bytes"] = peak
    record["card_memory_bytes"] = roofline.CARD_MEMORY_BYTES
    record["fits"] = peak <= roofline.CARD_MEMORY_BYTES
    record["status"] = "ok"
    return record


# --------------------------------------------------------------------------------------
def cell_path(arch: str, shape_name: str, multi_pod: bool, out_dir: str, tag: str = "") -> str:
    mesh_tag = "multipod_2x16x16" if multi_pod else "pod_16x16"
    suffix = f"__{tag}" if tag else ""
    return os.path.join(out_dir, mesh_tag, f"{arch}__{shape_name}{suffix}.json")


def run_one(args) -> int:
    from ..configs import cells

    skip = dict((s.name, r) for s, r in cells(args.arch))[args.shape]
    path = cell_path(args.arch, args.shape, args.multi_pod, args.out, args.tag)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if skip:
        record = {
            "arch": args.arch, "shape": args.shape, "status": "skipped", "reason": skip,
            "mesh": "multipod" if args.multi_pod else "pod",
        }
        print(f"SKIP {args.arch} x {args.shape}: {skip}")
    else:
        try:
            record = lower_cell(
                args.arch, args.shape, multi_pod=args.multi_pod,
                save_ops=args.save_ops, overrides=args.overrides,
            )
            rl = record["roofline"]
            mesh_str = "x".join(str(x) for x in record["mesh"]["shape"])
            print(
                f"OK {args.arch} x {args.shape} mesh={mesh_str} "
                f"trace={record['trace_s']}s bottleneck={rl['bottleneck']} "
                f"terms(c/m/coll)={rl['compute_s']:.3e}/{rl['memory_s']:.3e}/"
                f"{rl['collective_s']:.3e}s "
                f"useful={rl['useful_ratio']:.2f} frac={rl['roofline_fraction']:.2f} "
                f"fits={record['fits']}"
            )
        except Exception:
            record = {
                "arch": args.arch, "shape": args.shape, "status": "failed",
                "error": traceback.format_exc(),
            }
            print(f"FAIL {args.arch} x {args.shape}", file=sys.stderr)
            traceback.print_exc()
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    return 0 if record["status"] in ("ok", "skipped") else 1


def run_all(args) -> int:
    """Sweep driver: one fresh subprocess per cell (isolates each cell's
    process group and any single-cell failure), resumable via the per-cell
    JSON artifacts."""
    from ..configs import ARCH_IDS
    from ..configs.base import SHAPES

    meshes = [False, True] if args.mesh == "both" else [args.mesh == "multi"]
    failures, done, total = [], 0, 0
    for multi_pod in meshes:
        for arch in ARCH_IDS:
            for shape_name in SHAPES:
                total += 1
                path = cell_path(arch, shape_name, multi_pod, args.out)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        st = json.load(f).get("status")
                    if st in ("ok", "skipped"):
                        done += 1
                        continue
                cmd = [
                    sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape_name, "--out", args.out,
                ]
                if multi_pod:
                    cmd.append("--multi-pod")
                print(f"[{total}] {arch} x {shape_name} multi_pod={multi_pod}", flush=True)
                try:
                    r = subprocess.run(cmd, timeout=args.timeout)
                    rc = r.returncode
                except subprocess.TimeoutExpired:
                    rc = -9
                    with open(path, "w") as f:
                        json.dump(
                            {"arch": arch, "shape": shape_name, "status": "failed",
                             "error": f"timeout after {args.timeout}s"}, f)
                if rc == 0:
                    done += 1
                else:
                    failures.append((arch, shape_name, multi_pod))
    print(f"\ndry-run sweep: {done}/{total} cells ok/skipped, {len(failures)} failed")
    for f in failures:
        print("  FAILED:", f)
    return 1 if failures else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--mesh", choices=["single", "multi", "both"], default="both",
                   help="which mesh(es) --all sweeps")
    p.add_argument("--out", default=ARTIFACT_DIR)
    p.add_argument("--force", action="store_true", help="recompute existing artifacts")
    p.add_argument("--timeout", type=int, default=3000, help="per-cell seconds (--all)")
    p.add_argument("--save-ops", default=None,
                   help="write the rank's op list (one JSON line an op) to this file")
    p.add_argument("--tag", default="", help="artifact filename suffix (perf iterations)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE", help="override ModelConfig/ParallelConfig fields")
    args = p.parse_args(argv)
    if args.all:
        return run_all(args)
    if not args.arch or not args.shape:
        p.error("need --arch and --shape (or --all)")
    return run_one(args)


if __name__ == "__main__":
    sys.exit(main())
