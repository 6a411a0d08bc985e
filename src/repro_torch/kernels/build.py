"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface, loaded through ``ctypes``.  The
build happens at first use into ``build/kernels/`` at the repository root
(listed in ``.gitignore``), keyed by a hash of the sources and flags, so a
fresh checkout builds from its own sources and an unchanged tree reuses the
library.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"] + ARCH_FLAGS

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# source name -> the compiler's report (-Xptxas=-v: registers, spills, shared
# memory per kernel instance) from the last verbose build in this process
ptxas_report: Dict[str, str] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint

# C signatures, one entry per exported launcher; each returns cudaError_t
SIGNATURES = {
    # x, gamma, out, K, rows, d, eps, x_is_bf16, g_is_bf16, stream
    "rmsnorm_fwd": [_P, _P, _P, _I, _L, _I, _F, _I, _I, _P],
    # x, gamma, dy, dx, K, lanes (planned for), rows, d, x_is_bf16,
    # g_is_bf16, out: the blocks a lane that rmsnorm_bwd launches for these
    "rmsnorm_bwd_blocks": [_P] * 4 + [_I, _I, _L, _I, _I, _I, _P],
    # x, gamma, dy, dx, dgamma, partials, K, lanes, rows, d, eps, x_is_bf16,
    # g_is_bf16, partial_rows (the partials' blocks a lane), stream
    "rmsnorm_bwd": [_P] * 6 + [_I, _I, _L, _I, _F, _I, _I, _I, _P],
    # q, k, v, out, lse, B, Sq, Sk, H, Hkv, D, Dv, scale, causal, window,
    # softcap, stream: fp32 on the CUDA cores, bf16 on the tensor cores
    "flash_attn_fwd": [_P] * 5 + [_I] * 7 + [_F, _I, _I, _F, _P],
    "flash_attn_fwd_sm90": [_P] * 5 + [_I] * 7 + [_F, _I, _I, _F, _P],
    # x, dt, A, B, C, D, h0, y, h_last, hs, R, L, Dm, N, K, chunk, is_bf16, stream
    "ssm_scan_fwd": [_P] * 10 + [_I] * 7 + [_P],
    # N, is_bf16, out: resident blocks an SM, threads a block (the instance N picks)
    "ssm_scan_occupancy": [_I, _I, _P, _P],
    # steps, lo, hi, out, K, rows, n_pos, seed, shard, vocab, the vocab's
    # reciprocal (synth.vocab_reciprocal), order_mix, offset, stream
    "synth_tokens_fwd": [_P] * 4 + [_I] * 3 + [_L, _L, _I, _U, _F, _L, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link ``libkernels_<hash>.so``;
    returns its path (reused when it already exists).  ``verbose`` keeps
    each source's ``-Xptxas=-v`` report in ``ptxas_report``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libkernels_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    procs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, errors = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{out}")
        elif verbose:
            ptxas_report[src.name] = out
        objs.append(obj)
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernels_error_string.argtypes = [ctypes.c_int]
            lib.kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = library().kernels_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
