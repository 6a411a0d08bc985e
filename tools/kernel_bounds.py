#!/usr/bin/env python3
"""Each hand-written kernel's ``cost`` at the main shapes of ``PERF.md``'s
kernel table, and the bound it gives on the NVIDIA H100 80GB HBM3 (700 W)
rates of ``launch/roofline.py``: the larger of the bytes over the HBM rate
and the operations over the peak rate of their type, as ``chip_smoke.py``
reckons the ``bound_ms`` of its ``kernels`` line.  Needs no card.

    PYTHONPATH=src python3 tools/kernel_bounds.py
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.launch.roofline import HBM_BYTES_PER_S, PEAK_OPS  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
SFU_PER_FP32_FLOPS = 16   # chip_smoke.py's: 16 exponentials against 256 FP32 flop a clock


def bound(ops, nbytes, kind):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    rows = []
    for name, shape in (("rmsnorm starcoder2", (4, 4096, 3072)),
                        ("rmsnorm falcon-mamba", (4, 2048, 4096)),
                        ("rmsnorm d 2048", (2, 2048, 2048)),
                        ("rmsnorm kv_norm", (2, 2048, 512))):
        K, _, d = shape
        ops, nb = rn.cost((shape, (K, d)), (BF16, BF16))
        rows.append((name, "rmsnorm.cost", ops, nb, *bound(ops, nb, "float32")))
        ops, nb = rn.cost((shape, (K, d)), (BF16, BF16), backward=True)
        rows.append((name + " backward", "rmsnorm.cost(backward=True)", ops, nb,
                     *bound(ops, nb, "float32")))
    for name, q, k, dv, causal in (("flash starcoder2", (16, 1024, 24, 128), (16, 1024, 2, 128),
                                    128, True),
                                   ("flash qwen3-moe", (4, 1024, 32, 128), (4, 1024, 4, 128),
                                    128, True),
                                   ("flash MLA", (4, 1024, 16, 192), (4, 1024, 16, 192), 128,
                                    True),
                                   ("flash hubert", (8, 1024, 16, 80), (8, 1024, 16, 80), 80,
                                    False)):
        ops, nb = fa.cost((q, k, k[:3] + (dv,)), (BF16,) * 3, causal=causal)
        rows.append((name, "flash_attention.cost", ops, nb, *bound(ops, nb, "bfloat16")))
        ops, nb = fa.cost((q, k, k[:3] + (dv,)), (BF16,) * 3, causal=causal, backward=True)
        rows.append((name + " backward", "flash_attention.cost(backward=True)", ops, nb,
                     *bound(ops, nb, "bfloat16")))
    ops, nb = fa.cost(((16, 1024, 24, 128), (16, 1024, 2, 128), (16, 1024, 2, 128)),
                      (BF16,) * 3)
    rows.append(("flash starcoder2 fp32 (2 x the bf16 bytes)", "flash_attention.cost", ops,
                 2 * nb, *bound(ops, 2 * nb, "float32")))
    shapes = ((4, 512, 24, 128), (4, 512, 2, 128), (4, 512, 2, 128))
    ops, nb = fa.cost(shapes, (F32,) * 3, backward=True)
    rows.append(("flash backward fp32 (4, 512, 24, 128)", "flash_attention.cost(backward=True)",
                 ops, nb, *bound(ops, nb, "float32")))
    x, n, k = (8, 1024, 8192), 16, 4
    ops, nb = ss.cost((x, x[:2] + (n,), (k, x[2], n), (k, x[2])), (BF16, BF16), chunk=128,
                      chunk_states=True)
    sfu_ms = ops / 6 / (PEAK_OPS["float32"] / SFU_PER_FP32_FLOPS) * 1e3
    b_ms, by = bound(ops, nb, "float32")
    rows.append(("ssm_scan falcon-mamba (the SFU binds: its ms)", "ssm_scan.cost", ops, nb,
                 max(b_ms, sfu_ms), "operations (SFU)" if sfu_ms > b_ms else by))
    for name, fn, ops, nb, ms, by in rows:
        print(f"{name:48s} {fn:36s} ops {ops:>16,d} bytes {nb:>14,d} bound {ms:.4f} ms ({by})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
