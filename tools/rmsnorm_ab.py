#!/usr/bin/env python3
"""Time the RMSNorm kernels against variants of their source, on one GPU.

    python3 tools/rmsnorm_ab.py [--lanes 1,2,4] [VARIANT.cu ...]

Each VARIANT.cu is an edited copy of ``src/repro_torch/kernels/csrc/rmsnorm.cu``
(it exports ``rmsnorm_fwd`` and, unless it predates the backward kernel,
``rmsnorm_bwd_blocks`` and ``rmsnorm_bwd``); the copies are built in parallel
with the port's nvcc flags into ``build/ab/``, and each one's registers and
spills per kernel instance are printed.  The tree's own source is ``tree``.
At the four main paths' shapes in bf16 (x (4, 4096, 3072), (4, 2048, 4096),
(2, 2048, 2048) and MLA's kv_norm (2, 2048, 512), a gain row a lane), every
version's forward and backward is checked against the plain versions (max
abs error) and timed as ``chip_smoke.py`` times them (``device_ms``: launches
over rotating inputs larger than the L2, captured in a CUDA graph and
replayed under CUDA events), in the order A, B, ..., B, A, so that a drift of
the card's clock shows.  Prints the card's name and power limit, then one
JSON line per version's build and one per (version, direction, shape).
Compare versions only within one run.  ``--lanes 1,2,4`` times the
backward alone, at each shape's rows and width with K set to each count
(the one-trial driver's K=1, a population mesh's K/N lanes a rank).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import (EPS, L2_BYTES, RMS_KV_NORM_SHAPE, RMS_MAMBA_SHAPE,  # noqa: E402
                        RMS_MOE_SHAPE, RMS_SHAPE, bound_ms, graph_device_ms, nvidia_smi,
                        ptxas_summary)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

SHAPES = (RMS_SHAPE, RMS_MAMBA_SHAPE, RMS_MOE_SHAPE, RMS_KV_NORM_SHAPE)
FNS = ("rmsnorm_fwd", "rmsnorm_bwd_blocks", "rmsnorm_bwd")


def build_variants(srcs):
    """nvcc for every variant at once; returns {stem: (library, ptxas report)}
    with the C functions each one exports declared."""
    out_dir = build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in srcs:
        so = out_dir / f"{src.stem}.so"
        procs.append((src, so, subprocess.Popen(
            [build._nvcc(), "-Xptxas=-v", *build.NVCC_FLAGS, f"-I{build.CSRC}", "-shared",
             str(src), "-o", str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for src, so, proc in procs:
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{report}")
        lib = ctypes.CDLL(str(so))
        for name in FNS:
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = build.SIGNATURES[name], ctypes.c_int
        libs[src.stem] = (lib, report)
    return libs


def forward(lib):
    def run(x, g, _dy):
        out = torch.empty_like(x)
        K, R, d = x.shape
        build.check(lib.rmsnorm_fwd(x.data_ptr(), g.data_ptr(), out.data_ptr(), K, R, d, EPS,
                                    1, 1, torch.cuda.current_stream().cuda_stream),
                    "rmsnorm_fwd")
        return (out,)
    return run


def backward(lib):
    def run(x, g, dy):
        K, R, d = x.shape
        dx, dg = torch.empty_like(x), torch.empty_like(g)
        ptrs = (x.data_ptr(), g.data_ptr(), dy.data_ptr(), dx.data_ptr())
        n = ctypes.c_int()
        build.check(lib.rmsnorm_bwd_blocks(*ptrs, K, K, R, d, 1, 1, ctypes.byref(n)),
                    "rmsnorm_bwd_blocks")
        part = torch.empty((K, n.value, d), dtype=torch.float32, device=x.device)
        build.check(lib.rmsnorm_bwd(*ptrs, dg.data_ptr(), part.data_ptr(), K, K, R, d, EPS, 1, 1,
                                    n.value, torch.cuda.current_stream().cuda_stream),
                    "rmsnorm_bwd")
        return dx, dg
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("rmsnorm_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    lanes = None
    if args[:1] == ["--lanes"]:
        lanes, args = [int(k) for k in args[1].split(",")], args[2:]
    srcs = [build.CSRC / "rmsnorm.cu"] + [Path(p).resolve() for p in args]
    libs = build_variants(srcs)
    names = ["tree"] + [Path(p).stem for p in args]
    libs["tree"] = libs.pop("rmsnorm")
    print(nvidia_smi(), flush=True)
    for name in names:
        print(json.dumps({"version": name, "ptxas": ptxas_summary(libs[name][1], "rmsnorm.cu")}),
              flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    plain = {"fwd": lambda x, g, dy: (rn.rmsnorm_plain(x, g, EPS),),
             "bwd": lambda x, g, dy: rn.rmsnorm_bwd_plain(x, g, dy, EPS)}
    kinds = {"fwd": (forward, 1), "bwd": (backward, 2)}   # the wrapper, x-sized reads
    cases = ([(s, ("fwd", "bwd")) for s in SHAPES] if lanes is None else
             [((k, R, d), ("bwd",)) for _, R, d in SHAPES for k in lanes])
    for shape, directions in cases:
        K, R, d = shape
        x_bytes = K * R * d * 2
        for direction in directions:
            make, reads = kinds[direction]
            n_sets = max(2, -(-int(2 * L2_BYTES) // (reads * x_bytes)))
            sets = [tuple(t.bfloat16() for t in (
                torch.randn(shape, generator=gen, device=dev),
                0.1 * torch.randn((K, d), generator=gen, device=dev),
                torch.randn(shape, generator=gen, device=dev))) for _ in range(n_sets)]
            nb = (2 + (direction == "bwd")) * x_bytes + (1 + (direction == "bwd")) * K * d * 2
            b_ms, _ = bound_ms(nb, 0, "float32")
            want = plain[direction](*sets[0])
            order = names + names[::-1]
            for name in order:
                lib = libs[name][0]
                if direction == "bwd" and not hasattr(lib, "rmsnorm_bwd"):
                    continue
                fn = make(lib)
                got = fn(*sets[0])
                err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
                ms = graph_device_ms(torch, fn, sets)
                print(json.dumps({"version": name, "direction": direction, "shape": list(shape),
                                  "device_ms": ms, "bound_ms": b_ms, "share": b_ms / ms,
                                  "max_abs_err": err}), flush=True)
            del sets, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
