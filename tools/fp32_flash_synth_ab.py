#!/usr/bin/env python3
"""Time the fp32 CUDA-core flash forward and the token synthesis kernel
against other versions of their sources, on one GPU.

    python3 tools/fp32_flash_synth_ab.py [--flash VARIANT.cu ...] [--synth VARIANT.cu ...]

A flash variant is an edited or older copy of
``src/repro_torch/kernels/csrc/flash_attention.cu`` (exporting
``flash_attn_fwd``); a synthesis variant one of ``csrc/synth_tokens.cu``
(exporting ``synth_tokens_fwd``; a source that takes no reciprocal of the
vocabulary, as the design before the chain split, is called without it).
Every copy is built by its own nvcc, all at once, with the port's flags
into ``build/ab/``, and its registers and spills are printed.  The tree's
own sources are ``tree``; a variant is named by its path under the repo.

Flash, fp32, TF32 off: starcoder2-3b's attention (q (16, 1024, 24, 128), kv
(16, 1024, 2, 128), causal), the MLA check case (q, k (2, 300, 4, 192), v
128 wide, causal) and hubert-xlarge's (8, 1024, 16, 80), non-causal;
synthesis: the starcoder2 path's batch (4, 4, 1025) and the MoE and MLA
paths' (2, 2, 1025).  Each version is checked against the plain version
(max abs error; the synthesis bit for bit) and timed with CUDA events over
repeated launches (``ms``) and as ``device_ms`` (launches captured in a
CUDA graph and replayed, host dispatch left out), in the order A, B, ...,
B, A, so that a drift of the card's clock shows.  SDPA in fp32 is timed
beside each flash shape, as a user calls it (``enable_gqa``) and with kv
expanded to every q head, with the device kernels each launches.  Each
shape's bound (``chip_smoke.bound_ms``; for the synthesis, the longest rule
chain at ``chip_smoke.RULE_STEP_CYCLES`` a step) is printed with each
time's share of it.  Prints the card's name and power limit, then one JSON
line per version's build, per SDPA shape and per (version, shape).
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
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (RULE_STEP_CYCLES, bound_ms, event_ms, graph_device_ms,  # noqa: E402
                        nvidia_smi, ptxas_summary, sm_clock_max_mhz)
from repro_torch.data.pipeline import SyntheticLM, split_streams  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import synth as sk  # noqa: E402

FLASH_SHAPES = {   # name: (q, kv, v width, causal)
    "starcoder2": ((16, 1024, 24, 128), (16, 1024, 2, 128), 128, True),
    "mla-ragged-300": ((2, 300, 4, 192), (2, 300, 4, 192), 128, True),
    "hubert": ((8, 1024, 16, 80), (8, 1024, 16, 80), 80, False),
}
SYNTH_SHAPES = {"starcoder2": (4, 4, 1024), "moe-mla": (2, 2, 1024)}   # K, batch, seq
OLD_SYNTH_ABI = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_longlong,
    ctypes.c_void_p]


def device_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` launches (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events() if e.device_type.name == "CUDA"})


def build_all(srcs):
    """nvcc for every source at once; {name: (library, ptxas report, source)}."""
    out_dir = build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, src in srcs:
        so = out_dir / (name.replace("/", "_") + ".so")
        procs.append((name, src, so, subprocess.Popen(
            [build._nvcc(), "-Xptxas=-v", *build.NVCC_FLAGS, f"-I{build.CSRC}", "-shared",
             str(src), "-o", str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, src, so, proc in procs:
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{report}")
        libs[name] = (ctypes.CDLL(str(so)), report, src)
    return libs


def flash_fn(lib):
    fn = lib.flash_attn_fwd
    fn.argtypes, fn.restype = build.SIGNATURES["flash_attn_fwd"], ctypes.c_int

    def run(q, k, v, causal):
        B, Sq, H, D = q.shape
        _, Sk, Hkv, Dv = v.shape
        out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                       lse.data_ptr(), B, Sq, Sk, H, Hkv, D, Dv, D ** -0.5, int(causal), 0,
                       0.0, torch.cuda.current_stream().cuda_stream), "flash_attn_fwd")
        return out, lse
    return run


def synth_fn(lib, src):
    fn = lib.synth_tokens_fwd
    with_recip = "recip" in Path(src).read_text()
    fn.argtypes = build.SIGNATURES["synth_tokens_fwd"] if with_recip else OLD_SYNTH_ABI
    fn.restype = ctypes.c_int

    def run(data, st, lo, hi):
        K, rows, n_pos = st.shape[0], data.global_batch, data.seq_len + 1
        out = torch.empty((K, rows, n_pos), dtype=torch.int32, device=st.device)
        vocab = int(data.vocab_size)
        extra = [sk.vocab_reciprocal(vocab)] if with_recip else []
        build.check(fn(st.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), K, rows,
                       n_pos, int(data.seed), 0, vocab, *extra, float(np.float32(data.order_mix)),
                       0, torch.cuda.current_stream().cuda_stream), "synth_tokens_fwd")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flash", nargs="*", default=[], help="variants of flash_attention.cu")
    ap.add_argument("--synth", nargs="*", default=[], help="variants of synth_tokens.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp32_flash_synth_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = lambda p: str(Path(p).resolve().relative_to(ROOT))  # noqa: E731
    flash_srcs = [("tree", build.CSRC / "flash_attention.cu")] + [(name(p), p) for p in args.flash]
    synth_srcs = [("tree", build.CSRC / "synth_tokens.cu")] + [(name(p), p) for p in args.synth]
    libs = build_all([("flash:" + n, s) for n, s in flash_srcs] +
                     [("synth:" + n, s) for n, s in synth_srcs])
    print(nvidia_smi(), flush=True)
    for key, (_, report, src) in libs.items():
        kind = "flash_attention.cu" if key.startswith("flash:") else "synth_tokens.cu"
        print(json.dumps({"version": key, "ptxas": ptxas_summary(report, kind)}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    import torch.nn.functional as F

    flash_names = [n for n, _ in flash_srcs]
    for shape, (qs, kvs, dv, causal) in FLASH_SHAPES.items():
        q = torch.randn(qs, generator=gen, device=dev)
        k = torch.randn(kvs, generator=gen, device=dev)
        v = torch.randn(kvs[:3] + (dv,), generator=gen, device=dev)
        B, S, H, D = qs
        pairs = S * (S + 1) // 2 if causal else S * S
        nb = (q.numel() + k.numel() + v.numel() + v.numel() * H // kvs[2]) * 4 + B * H * S * 4
        b_ms, b_by = bound_ms(nb, 2 * B * H * pairs * (D + dv), "float32")
        want = fa.flash_fwd_plain(q, k, v, causal=causal, window=None, softcap=None,
                                  scale=D ** -0.5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        lib_ms = event_ms(torch, sdpa, n=5, warmup=1)
        lib_dev_ms = graph_device_ms(torch, sdpa, [()], min_launches=10, replays=2)
        ke, ve = (t.repeat_interleave(H // kvs[2], dim=1) for t in (kt, vt))
        sdpa_expanded = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, ke, ve, is_causal=causal)
        print(json.dumps({"sdpa": shape, "ms": lib_ms, "device_ms": lib_dev_ms,
                          "kernels": device_kernels(sdpa),
                          "expanded_kv_ms": event_ms(torch, sdpa_expanded, n=5, warmup=1),
                          "expanded_kv_kernels": device_kernels(sdpa_expanded)}), flush=True)
        del ke, ve
        for ver in flash_names + flash_names[::-1]:
            run = flash_fn(libs["flash:" + ver][0])
            got = run(q, k, v, causal)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ms = event_ms(torch, lambda: run(q, k, v, causal), n=5, warmup=1)
            dev_ms = graph_device_ms(torch, run, [(q, k, v, causal)], min_launches=10, replays=2)
            print(json.dumps({"kernel": "flash_fp32", "version": ver, "shape": shape, "ms": ms,
                              "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "share": b_ms / ms, "device_share": b_ms / dev_ms,
                              "sdpa_ms": lib_ms, "sdpa_device_ms": lib_dev_ms,
                              "max_abs_err": err}), flush=True)
        del q, k, v, want, qt, kt, vt
        torch.cuda.empty_cache()

    clock = sm_clock_max_mhz()
    synth_names = [n for n, _ in synth_srcs]
    for shape, (K, rows, seq) in SYNTH_SHAPES.items():
        data = SyntheticLM(49152, seq, rows, seed=0)
        lo, hi = (torch.tensor(w.astype(np.int64), device=dev)
                  for w in split_streams(list(range(K))))
        st = torch.zeros(K, dtype=torch.int64, device=dev)
        rule = sk.rule_positions(data, np.zeros(K, dtype=np.int64), lo.cpu().numpy(),
                                 hi.cpu().numpy())
        longest = int(sk.chain_rule_steps(rule).max())
        b_ms = longest * RULE_STEP_CYCLES / (clock * 1e3)
        want = sk.synth_tokens_plain(data, st, lo, hi)
        for ver in synth_names + synth_names[::-1]:
            lib, _, src = libs["synth:" + ver]
            run = synth_fn(lib, src)
            equal = bool(torch.equal(run(data, st, lo, hi), want))
            ms = event_ms(torch, lambda: run(data, st, lo, hi))
            dev_ms = graph_device_ms(torch, run, [(data, st, lo, hi)])
            print(json.dumps({"kernel": "synth_tokens", "version": ver, "shape": [K, rows, seq + 1],
                              "ms": ms, "device_ms": dev_ms, "bound_ms": b_ms, "share": b_ms / ms,
                              "device_share": b_ms / dev_ms,
                              "longest_chain_rule_steps": longest,
                              "serial_bound_ms": int(rule.sum(-1).max()) * RULE_STEP_CYCLES
                              / (clock * 1e3), "bit_equal": equal}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
