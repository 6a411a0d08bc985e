#!/usr/bin/env python3
"""Time the selective-scan forward against variants of its source, on one GPU.

    python3 tools/ssm_scan_ab.py [VARIANT.cu ...]

Each VARIANT.cu is an edited copy of
``src/repro_torch/kernels/csrc/ssm_scan.cu`` (it exports the same
``ssm_scan_fwd``); the copies are built in parallel with the port's nvcc
flags into ``build/ab/``, and each one's registers and spills per kernel
instance are printed.  The tree's own kernel is ``tree``.  At falcon-mamba's
shape (x, dt (8, 1024, 8192) bf16, B, C (8, 1024, 16), per-lane A (4, 8192,
16) and D (4, 8192) fp32), without and with the chunk states at chunk 128,
every version is checked against the plain version (max abs error of y, and
of h_last and the chunk states) and timed with CUDA events over 20 launches,
in the order A, B, ..., B, A, so that a drift of the card's clock shows.
Prints the card's name and power limit, then one JSON line per version's
build (registers and spills per instance, resident warps a scheduler) and
one per case.  Compare versions only within one run.
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
import torch.nn.functional as F  # noqa: E402

from chip_smoke import ptxas_summary  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402

SHAPE, N, K, CHUNK = (8, 1024, 8192), 16, 4, 128   # x, dt (K*B, L, d_inner)


def build_variants(srcs):
    """nvcc for every variant at once; returns {stem: (library, ptxas report)}
    with the scan's C functions declared."""
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
        for name in ("ssm_scan_fwd", "ssm_scan_occupancy"):
            if hasattr(lib, name):   # an older source exports no occupancy query
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = build.SIGNATURES[name], ctypes.c_int
        libs[src.stem] = (lib, report)
    return libs


def launcher(fn, x, dt, A, Bc, Cc, D, chunk_states):
    R, L, Dm = x.shape
    y = torch.empty_like(x)
    h_last = torch.empty((R, Dm, N), dtype=torch.float32, device=x.device)
    hs = (torch.empty((R, -(-L // CHUNK), Dm, N), dtype=torch.float32, device=x.device)
          if chunk_states else None)

    def run():
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                 D.data_ptr(), None, y.data_ptr(), h_last.data_ptr(),
                 None if hs is None else hs.data_ptr(), R, L, Dm, N, K, CHUNK,
                 int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        build.check(err, "ssm_scan_fwd")
        return (y, h_last) + ((hs,) if chunk_states else ())
    return run


def event_ms(fn, n=20, warmup=3) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("ssm_scan_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    build.build(verbose=True)
    versions = {"tree": (build.library(), build.ptxas_report.get("ssm_scan.cu", ""))}
    versions.update(build_variants([Path(a) for a in sys.argv[1:]]))
    for name, (lib, report) in versions.items():
        occupancy = (ss.kernel_occupancy(N, torch.bfloat16, lib)
                     if hasattr(lib, "ssm_scan_occupancy") else None)
        print(json.dumps({"version": name, "ptxas": ptxas_summary(report, "ssm_scan.cu"),
                          "occupancy_bf16": occupancy}), flush=True)
    fns = {name: lib.ssm_scan_fwd for name, (lib, _) in versions.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    R, L, Dm = SHAPE
    x = (0.5 * torch.randn(SHAPE, generator=gen, device=dev)).bfloat16()
    dt = F.softplus(torch.randn(SHAPE, generator=gen, device=dev) - 1.0).bfloat16()
    A = -torch.exp(0.3 * torch.randn((K, Dm, N), generator=gen, device=dev))
    Bc = (0.5 * torch.randn((R, L, N), generator=gen, device=dev)).bfloat16()
    Cc = (0.5 * torch.randn((R, L, N), generator=gen, device=dev)).bfloat16()
    D = 0.2 * torch.randn((K, Dm), generator=gen, device=dev)
    want = ss.ssm_scan_plain(x, dt, A, Bc, Cc, D, chunk=CHUNK, chunk_states=True)
    order = list(versions) + list(versions)[::-1]
    for chunk_states in (False, True):
        row = {"shape": {"x": list(SHAPE), "A": [K, Dm, N], "dtype": "bfloat16"},
               "chunk_states": chunk_states, "chunk": CHUNK, "ms": {}, "y_max_abs_err": {},
               "state_max_abs_err": {}}
        for ver in order:
            run = launcher(fns[ver], x, dt, A, Bc, Cc, D, chunk_states)
            got = run()
            torch.cuda.synchronize()
            row["y_max_abs_err"][ver] = float((got[0].float() - want[0].float()).abs().max())
            row["state_max_abs_err"][ver] = max(float((g - w).abs().max())
                                                for g, w in zip(got[1:], want[1:]))
            row["ms"].setdefault(ver, []).append(event_ms(run))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
