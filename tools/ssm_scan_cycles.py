#!/usr/bin/env python3
"""Where a selective-scan block spends its time loop, by clock64, on one GPU.

    python3 tools/ssm_scan_cycles.py [SOURCE.cu]

Builds an instrumented copy of ``src/repro_torch/kernels/csrc/ssm_scan.cu``
(or of SOURCE.cu, an edited copy with the same time loop) into
``build/ab/``: every thread reads ``clock64`` around the four parts of each
tile of its time loop (the ring's wait and first barrier; B and C converted
to fp32, the next tile's loads issued and the second barrier; the compute
of the tile's steps; the warp's y stores after it) and the first lane of
each warp writes its sums over the tiles, and the loop's total, into the
first five states of its channel's ``h_last``.  Runs the falcon-mamba shape
(x, dt (8, 1024, 8192) bf16, N 16, no chunk states) and prints the mean and
the largest cycles a warp over all warps, with the card's name and power
limit, and the 10th, 50th and 90th percentiles of a warp's loop total
(the slowest warps set the kernel's time).  The copy fails to build, with
the text it did not find, when the loop no longer has the shape it expects.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402

SHAPE, N, K = (8, 1024, 8192), 16, 4
PARTS = ("wait_barrier", "before_compute", "compute", "after_compute", "loop_total")

# (text of the source, text that replaces it)
EDITS = (
    ("  for (int k = 0; k < n_tiles; ++k) {\n    cp_async_wait<0>();\n",
     "  long long c0 = 0, c1 = 0, c2 = 0, c3 = 0, c_all = clock64();\n"
     "  for (int k = 0; k < n_tiles; ++k) {\n    const long long ta = clock64();\n"
     "    cp_async_wait<0>();\n"),
    ("    sc.convert_bc(k);\n", "    const long long tb = clock64();\n    sc.convert_bc(k);\n"),
    ("    if (per_step)\n", "    const long long tc = clock64();\n    if (per_step)\n"),
    ("    __syncwarp();\n    sc.store_y(k, p);\n  }\n",
     "    const long long td = clock64();\n    __syncwarp();\n    sc.store_y(k, p);\n"
     "    c0 += tb - ta, c1 += tc - tb, c2 += td - tc, c3 += clock64() - td;\n  }\n"
     "  c_all = clock64() - c_all;\n"),
    ("  if (d < Dm) write_states<G>(h_last + (p0.row * Dm + d) * N + n0, h, n0, N);\n}",
     "  if (d < Dm) write_states<G>(h_last + (p0.row * Dm + d) * N + n0, h, n0, N);\n"
     "  if ((threadIdx.x & 31) == 0) {\n    float* o = h_last + (p0.row * Dm + d) * N;\n"
     "    o[0] = c0, o[1] = c1, o[2] = c2, o[3] = c3, o[4] = c_all;\n  }\n}"),
)


def instrumented(src: Path) -> Path:
    text = src.read_text()
    for old, new in EDITS:
        if old not in text:
            raise RuntimeError(f"{src}: the time loop has changed; not found:\n{old}")
        text = text.replace(old, new)
    out_dir = build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "ssm_scan_cycles.cu", out_dir / "ssm_scan_cycles.so"
    cu.write_text(text)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-shared",
                          str(cu), "-o", str(so)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {cu}:\n{res.stdout}{res.stderr}")
    return so


def main() -> int:
    if not torch.cuda.is_available():
        print("ssm_scan_cycles: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    src = Path(sys.argv[1]) if len(sys.argv) > 1 else build.CSRC / "ssm_scan.cu"
    fn = ctypes.CDLL(str(instrumented(src))).ssm_scan_fwd
    fn.argtypes, fn.restype = build.SIGNATURES["ssm_scan_fwd"], ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    R, L, Dm = SHAPE
    x = (0.5 * torch.randn(SHAPE, generator=gen, device=dev)).bfloat16()
    dt = F.softplus(torch.randn(SHAPE, generator=gen, device=dev) - 1.0).bfloat16()
    A = -torch.exp(0.3 * torch.randn((K, Dm, N), generator=gen, device=dev))
    Bc = (0.5 * torch.randn((R, L, N), generator=gen, device=dev)).bfloat16()
    Cc = (0.5 * torch.randn((R, L, N), generator=gen, device=dev)).bfloat16()
    D = 0.2 * torch.randn((K, Dm), generator=gen, device=dev)
    y = torch.empty_like(x)
    h_last = torch.empty((R, Dm, N), dtype=torch.float32, device=dev)
    for _ in range(3):   # the last launch's counts are read
        build.check(fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                       D.data_ptr(), None, y.data_ptr(), h_last.data_ptr(), None, R, L, Dm, N,
                       K, 128, 1, torch.cuda.current_stream().cuda_stream), "ssm_scan_fwd")
    torch.cuda.synchronize()
    lanes = 32 // 2   # channels a warp at N = 16 (two threads a channel)
    counts = h_last[:, ::lanes, :len(PARTS)].reshape(-1, len(PARTS)).double()
    print(json.dumps({"source": str(src), "shape": {"x": list(SHAPE), "N": N},
                      "warps": counts.shape[0],
                      "mean_cycles": dict(zip(PARTS, counts.mean(0).tolist())),
                      "max_cycles": dict(zip(PARTS, counts.max(0).values.tolist())),
                      "loop_total_p10_p50_p90": torch.quantile(
                          counts[:, 4], torch.tensor([0.1, 0.5, 0.9], dtype=torch.float64,
                                                     device=dev)).tolist(),
                      "compute_cycles_per_step": float(counts[:, 2].mean() / L)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
