#!/usr/bin/env python3
"""Time the tensor-core flash forward against variants of its source, on one GPU.

    python3 tools/flash_sm90_ab.py [VARIANT.cu ...]

Each VARIANT.cu is an edited copy of
``src/repro_torch/kernels/csrc/flash_attention_sm90.cu`` (it exports the same
``flash_attn_fwd_sm90``); it is built with the port's nvcc flags into
``build/ab/``.  The tree's own kernel is ``tree``.  At three causal bf16
shapes (the starcoder2 main shape, a 256-wide and a 64-wide head), every
version is checked against the plain version (max abs error over out and
lse) and timed with CUDA events over 20 launches, in the order A, B, ..., B,
A, so that a drift of the card's clock shows; SDPA is timed beside them as
the library yardstick.  Prints the card's name and power limit, then one
JSON line per shape.  Compare versions only within one run.
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SHAPES = {  # name: (q (B, S, H, D), kv (B, S, Hkv, D)), causal
    "starcoder2-main": ((16, 1024, 24, 128), (16, 1024, 2, 128)),
    "d256": ((4, 2048, 16, 256), (4, 2048, 8, 256)),
    "d64": ((16, 1024, 24, 64), (16, 1024, 2, 64)),
}


def load_variant(src: Path):
    out_dir = build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"{src.stem}.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-shared",
                          str(src), "-o", str(so)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(so)).flash_attn_fwd_sm90
    fn.argtypes = build.SIGNATURES["flash_attn_fwd_sm90"]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, q, k, v):
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 B, Sq, Sk, H, Hkv, D, Dv, D ** -0.5, 1, 0, 0.0,
                 torch.cuda.current_stream().cuda_stream)
        build.check(err, "flash_attn_fwd_sm90")
        return out, lse
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
        print("flash_sm90_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    versions = {"tree": build.library().flash_attn_fwd_sm90}
    for arg in sys.argv[1:]:
        versions[Path(arg).stem] = load_variant(Path(arg))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    order = list(versions) + list(versions)[::-1]
    for name, (qs, kvs) in SHAPES.items():
        q, k, v = (torch.randn(s, generator=gen, device=dev).bfloat16() for s in (qs, kvs, kvs))
        want_out, want_lse = fa.flash_fwd_plain(q, k, v, causal=True, window=None,
                                                softcap=None, scale=qs[-1] ** -0.5)
        row = {"shape": name, "q": list(qs), "kv": list(kvs), "ms": {}, "max_abs_err": {}}
        for ver in order:
            run = launcher(versions[ver], q, k, v)
            out, lse = run()
            torch.cuda.synchronize()
            row["max_abs_err"][ver] = max(float((out.float() - want_out.float()).abs().max()),
                                          float((lse - want_lse).abs().max()))
            row["ms"].setdefault(ver, []).append(event_ms(run))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["sdpa_ms"] = event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        print(json.dumps(row), flush=True)
        del q, k, v, want_out, want_lse
    return 0


if __name__ == "__main__":
    sys.exit(main())
