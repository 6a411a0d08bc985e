#!/usr/bin/env python3
"""Time the bf16 flash-attention backward against other versions of its source, on one GPU.

    python3 tools/flash_bwd_ab.py [--legacy OLD.cu ...] [--split-blocks N ...]
                                  [VARIANT.cu ...] [--shapes a,b]

``tree`` is the tree's own backward (``flash_attention.flash_bwd_cuda``);
``tree@splitN`` the same with the plan's ``SPLIT_BLOCKS`` set to N.
Each VARIANT.cu is an edited copy of
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` that exports
``flash_attn_bwd_bf16`` with the tree's signature (scratch from the tree's
``bwd_plan``); each OLD.cu exports the signature from before the ``splits``
argument (each q head's fp32 partial dK / dV under grouped heads), e.g.
``git show <rev>:src/repro_torch/kernels/csrc/flash_attention_bwd.cu``.
Both are built with the port's nvcc flags into ``build/ab/``.

At each shape (the main paths' causal bf16 shapes, hubert's non-causal d 80,
one-trial training's rows) every version is checked against
``flash_bwd_plain`` fed the same (out, lse) from the forward kernel (max abs
error over dq, dk, dv), timed with CUDA events over 20 launches in the order
A, B, ..., B, A (so a drift of the card's clock shows), and profiled once
(``torch.profiler``, 10 launches) for the device ms of each of its CUDA
kernels (delta, dK/dV, the partials' sum, dQ).  SDPA's backward (autograd,
``enable_gqa``) is timed beside them as the library yardstick.  Prints the
card's name and power limit, one JSON line per shape, then ``{"ok": ...}``.
Compare versions only within one run.
"""
from __future__ import annotations

import argparse
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

SHAPES = {  # name: q (B, S, H, D), k (B, S, Hkv, D), v's width, causal
    "starcoder2-main": ((16, 1024, 24, 128), (16, 1024, 2, 128), 128, True),
    "one-trial": ((4, 1024, 24, 128), (4, 1024, 2, 128), 128, True),
    "qwen3-moe": ((4, 1024, 32, 128), (4, 1024, 4, 128), 128, True),
    "mla": ((4, 1024, 16, 192), (4, 1024, 16, 192), 128, True),
    "tp-12x1": ((16, 1024, 12, 128), (16, 1024, 1, 128), 128, True),
    "hubert-d80": ((8, 1024, 16, 80), (8, 1024, 16, 80), 80, False),
}
PARTS = (("delta", "fa_bwd_delta"), ("dkdv", "fa_bwd_dkdv"), ("sum", "fa_bwd_sum_heads"),
         ("dq", "fa_bwd_dq"))
# the launcher before the ``splits`` argument
LEGACY_SIGNATURE = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def load_variant(src: Path, legacy: bool):
    out_dir = build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"{src.stem}{'_legacy' if legacy else ''}.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-shared",
                          str(src), "-o", str(so)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(so)).flash_attn_bwd_bf16
    fn.argtypes = LEGACY_SIGNATURE if legacy else build.SIGNATURES["flash_attn_bwd_bf16"]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, legacy, ins, kw):
    """A call of a variant's launcher on ``ins`` with its own buffers."""
    q, k, v, out, lse, dout = ins
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), **f32)
    if legacy:
        parts = ((torch.empty((B, Sk, H, D), **f32), torch.empty((B, Sk, H, Dv), **f32))
                 if H != Hkv else (None, None))
        extra = ()
    else:
        plan = fa.bwd_plan(H, Hkv, Sq, Sk, D, Dv, kw["causal"], kw["window"], q.dtype)
        parts = tuple(torch.empty(s, **f32) for s in plan.scratch(B)[1:]) or (None, None)
        extra = (plan.splits,)
    ptrs = [0 if t is None else t.data_ptr()
            for t in (q, k, v, out, dout, lse, delta, *parts, dq, dk, dv)]

    def run():
        err = fn(*ptrs, B, Sq, Sk, H, Hkv, D, Dv, *extra, float(kw["scale"]),
                 int(kw["causal"]), 0, 0.0, torch.cuda.current_stream().cuda_stream)
        build.check(err, "flash_attn_bwd_bf16")
        return dq, dk, dv
    return run


def tree_with_split_blocks(n, ins, kw):
    """The tree's backward with ``flash_attention.SPLIT_BLOCKS`` at ``n``."""
    def run():
        keep, fa.SPLIT_BLOCKS = fa.SPLIT_BLOCKS, n
        try:
            return fa.flash_bwd_cuda(*ins, **kw)
        finally:
            fa.SPLIT_BLOCKS = keep
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


def kernel_split(fn, n=10) -> dict:
    """Device ms a call of each part (by kernel name) under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = {part: 0.0 for part, _ in PARTS}
    names = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for part, sub in PARTS:
            if sub in ev.key:
                split[part] += us / 1e3 / n
                names[ev.key[:60]] = us / 1e3 / n
    split["total"] = sum(split[p] for p, _ in PARTS)
    split["kernels"] = names
    return split


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", type=Path)
    ap.add_argument("--legacy", action="append", type=Path, default=[])
    ap.add_argument("--split-blocks", action="append", type=int, default=[])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    versions = {"tree": None}
    for n in args.split_blocks:
        versions[f"tree@split{n}"] = n
    for src in args.legacy:
        versions[f"{src.stem}@legacy"] = (load_variant(src, True), True)
    for src in args.variants:
        versions[src.stem] = (load_variant(src, False), False)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    order = list(versions) + list(versions)[::-1]
    ok = True
    for name in args.shapes.split(","):
        qs, kvs, dv, causal = SHAPES[name]
        q, k = (torch.randn(s, generator=gen, device=dev).bfloat16() for s in (qs, kvs))
        v = torch.randn(kvs[:3] + (dv,), generator=gen, device=dev).bfloat16()
        dout = torch.randn(qs[:3] + (dv,), generator=gen, device=dev).bfloat16()
        kw = dict(causal=causal, window=None, softcap=None, scale=qs[-1] ** -0.5)
        out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
        ins = (q, k, v, out, lse, dout)
        want = fa.flash_bwd_plain(*ins, **kw)
        n_ops, nb = fa.cost((q.shape, k.shape, v.shape), (q.dtype,) * 3, causal=causal,
                            backward=True)
        bound = max(n_ops / 989e12, nb / 3.35e12) * 1e3
        row = {"shape": name, "q": list(qs), "k": list(kvs), "dv": dv, "causal": causal,
               "bound_ms": bound, "ms": {}, "max_abs_err": {}, "split_ms": {}}
        runs = {}
        for ver, spec in versions.items():
            if spec is None:
                runs[ver] = lambda: fa.flash_bwd_cuda(*ins, **kw)
            elif isinstance(spec, int):
                runs[ver] = tree_with_split_blocks(spec, ins, kw)
            else:
                runs[ver] = launcher(spec[0], spec[1], ins, kw)
            got = runs[ver]()
            torch.cuda.synchronize()
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            row["max_abs_err"][ver] = err
            ok &= err <= 3e-2 * (1 + max(float(w.float().abs().max()) for w in want))
            row["split_ms"][ver] = kernel_split(runs[ver])
        for ver in order:
            row["ms"].setdefault(ver, []).append(event_ms(runs[ver]))
        leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
        g = dout.transpose(1, 2)
        row["sdpa_bwd_ms"] = event_ms(
            lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True), n=10)
        row["share_of_bound"] = {ver: bound / min(ms) for ver, ms in row["ms"].items()}
        print(json.dumps(row), flush=True)
        del q, k, v, dout, out, lse, ins, want, runs, leaves, lib_out, g
        torch.cuda.empty_cache()
    print(json.dumps({"ok": ok, "card": card,
                      "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
