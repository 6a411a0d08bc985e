"""Mamba-1 selective scan: the CUDA kernel, its plain version and its
autograd function.

Replaces ``repro/kernels/ssm_scan.py::ssm_scan_pallas`` (body
``_ssm_kernel``).  Rows of ``x, dt (R, L, Dm)`` and ``Bc, Cc (R, L, N)``
scan with their lane's ``A (K, Dm, N)`` and ``D (K, Dm)`` (row ``r`` reads
lane ``r // (R // K)``), from an optional fp32 ``h0 (R, Dm, N)``; the result
is ``y`` in x's dtype and the fp32 ``h_last``.

A CPU tensor takes the plain version (``ref.ssm_scan``); a CUDA tensor
launches the kernel (``csrc/ssm_scan.cu``) or raises.  The backward pass is
plain PyTorch, as the JAX package's ``_fused_ssm_bwd`` replays the
reference scan's VJP, but chunk by chunk: the forward keeps the state
entering each chunk, and the backward walks the chunks in reverse,
rebuilding one chunk's graph at a time from its entering state and passing
the state's gradient to the chunk before.  Autograd through the whole
sequence would hold every chunk's ``(R, chunk, Dm, N)`` fp32 tensors at once.

A tensor on the meta device (the dry run) gets empty outputs of the
kernel's shapes, and the kernel's work (``cost``) goes to the op-cost walk
(``kernels/walk.py``), as a launch on the card reports it while a walk is
active; the backward runs its plain chunks there as on the card.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from . import build, ref, walk

_SUPPORTED = (torch.float32, torch.bfloat16)
MAX_STATE = 64
_count_lock = threading.Lock()
launches = 0  # kernel launches in this process (plain-version calls excluded)


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def cost(shapes, dtypes, chunk: int = 128, chunk_states: bool = False) -> tuple:
    """(operations, HBM bytes) of one launch at x ``shapes[0]`` (R, L, Dm),
    Bc ``shapes[1]`` (R, L, N), A ``shapes[2]`` (K, Dm, N), D ``shapes[3]``
    (K, Dm) and h0 ``shapes[4]`` (R, Dm, N, or None) in ``dtypes`` (x's and
    Bc's; A, D, h0 and the states are fp32): 6 operations a state update
    (the exponential's argument, the exponential, two FMAs, the skip); x,
    dt, Bc, Cc, A, D and h0 read once, y, h_last and the chunk states
    written once."""
    xs, bs, As, Ds = shapes[:4]
    h0 = shapes[4] if len(shapes) > 4 else None
    xd, bd = dtypes[:2]
    R, L, Dm = xs
    N = As[2]
    state = R * Dm * N * 4
    nbytes = (3 * math.prod(xs) * xd.itemsize + 2 * math.prod(bs) * bd.itemsize
              + math.prod(As) * 4 + math.prod(Ds) * 4 + state
              + (state if h0 is not None else 0)
              + (R * -(-L // chunk) * Dm * N * 4 if chunk_states else 0))
    return 6 * R * L * Dm * N, nbytes


def _record(x, Bc, A, D, h0, chunk, chunk_states) -> None:
    if walk.active():
        shapes = (x.shape, Bc.shape, A.shape, D.shape, None if h0 is None else h0.shape)
        walk.record("ssm_scan", *cost(shapes, (x.dtype, Bc.dtype), chunk, chunk_states))


def _check(x, dt, A, Bc, Cc, D, h0):
    if x.dim() != 3 or A.dim() != 3 or Bc.dim() != 3 or D.dim() != 2:
        raise ValueError("ssm_scan: want x, dt (R, L, Dm), A (K, Dm, N), "
                         "Bc, Cc (R, L, N), D (K, Dm)")
    R, L, Dm = x.shape
    K, N = A.shape[0], A.shape[2]
    if (dt.shape != x.shape or Bc.shape != (R, L, N) or Cc.shape != (R, L, N)
            or A.shape[1] != Dm or D.shape != (K, Dm) or R % K
            or (h0 is not None and h0.shape != (R, Dm, N))):
        raise ValueError(
            f"ssm_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, Bc {tuple(Bc.shape)}, Cc {tuple(Cc.shape)}, D "
            f"{tuple(D.shape)}, h0 {None if h0 is None else tuple(h0.shape)} do not agree")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssm_scan: state size {N} is not in 1..{MAX_STATE}")
    if x.dtype not in _SUPPORTED or not (x.dtype == dt.dtype == Bc.dtype == Cc.dtype):
        raise TypeError(f"ssm_scan: x, dt, Bc, Cc must all be fp32 or all bf16; got "
                        f"{x.dtype}, {dt.dtype}, {Bc.dtype}, {Cc.dtype}")
    if A.dtype != torch.float32 or D.dtype != torch.float32 or (
            h0 is not None and h0.dtype != torch.float32):
        raise TypeError("ssm_scan: A, D and h0 must be fp32")


def ssm_scan_plain(x, dt, A, Bc, Cc, D, h0=None, chunk: int = 128,
                   chunk_states: bool = False):
    """The plain version: ``ref.ssm_scan``."""
    return ref.ssm_scan(x, dt, A, Bc, Cc, D, h0=h0, chunk=chunk, chunk_states=chunk_states)


def ssm_scan_cuda(x, dt, A, Bc, Cc, D, h0=None, chunk: int = 128,
                  chunk_states: bool = False):
    """Launch the kernel on the current stream; raises on what it does not
    take.  Returns (y, h_last) and, with ``chunk_states``, the state
    entering each ``chunk`` timesteps, (R, ceil(L / chunk), Dm, N)."""
    global launches
    _check(x, dt, A, Bc, Cc, D, h0)
    ts = (x, dt, A, Bc, Cc, D) + (() if h0 is None else (h0,))
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("ssm_scan: every input must lie on one CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssm_scan: every input must be contiguous")
    if chunk < 1:
        raise ValueError(f"ssm_scan: chunk {chunk} must be positive")
    R, L, Dm = x.shape
    K, N = A.shape[0], A.shape[2]
    y = torch.empty_like(x)
    h_last = torch.empty((R, Dm, N), dtype=torch.float32, device=x.device)
    nc = -(-L // chunk)
    hs = (torch.empty((R, nc, Dm, N), dtype=torch.float32, device=x.device)
          if chunk_states else None)
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssm_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), None if hs is None else hs.data_ptr(), R, L, Dm, N, K,
        int(chunk), int(x.dtype == torch.bfloat16), stream)
    build.check(err, "ssm_scan_fwd")
    with _count_lock:
        launches += 1
    _record(x, Bc, A, D, h0, chunk, chunk_states)
    return (y, h_last) + ((hs,) if chunk_states else ())


def ssm_scan_meta(x, dt, A, Bc, Cc, D, h0=None, chunk: int = 128,
                  chunk_states: bool = False):
    """The scan on the meta device: the kernel's outputs, empty, and its
    cost recorded."""
    _check(x, dt, A, Bc, Cc, D, h0)
    ts = (x, dt, A, Bc, Cc, D) + (() if h0 is None else (h0,))
    if not all(t.is_meta for t in ts):
        raise ValueError("ssm_scan: every input must lie on the meta device")
    R, L, Dm = x.shape
    N = A.shape[2]
    y = torch.empty_like(x)
    h_last = torch.empty((R, Dm, N), dtype=torch.float32, device=x.device)
    hs = (torch.empty((R, -(-L // chunk), Dm, N), dtype=torch.float32, device=x.device)
          if chunk_states else None)
    _record(x, Bc, A, D, h0, chunk, chunk_states)
    return (y, h_last) + ((hs,) if chunk_states else ())


def kernel_occupancy(n_state: int, dtype: torch.dtype, lib=None) -> dict:
    """Resident blocks an SM and threads a block of the kernel instance that
    a state size ``n_state`` in ``dtype`` launches, and the resident warps a
    scheduler (an SM has four).  Needs the card: ``lib`` is a loaded kernel
    library with ``ssm_scan_occupancy`` declared, by default the tree's."""
    lib = lib or build.library()
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    build.check(lib.ssm_scan_occupancy(int(n_state), int(dtype == torch.bfloat16),
                                       ctypes.byref(blocks), ctypes.byref(threads)),
                "ssm_scan_occupancy")
    return {"blocks_per_sm": blocks.value, "threads_per_block": threads.value,
            "warps_per_scheduler": blocks.value * threads.value / 32 / 4}


def ssm_scan_fwd(x, dt, A, Bc, Cc, D, h0=None, chunk: int = 128,
                 chunk_states: bool = False):
    if x.device.type == "cpu":
        _check(x, dt, A, Bc, Cc, D, h0)
        return ssm_scan_plain(x, dt, A, Bc, Cc, D, h0, chunk, chunk_states)
    if x.is_cuda:
        return ssm_scan_cuda(x, dt, A, Bc, Cc, D, h0, chunk, chunk_states)
    if x.is_meta:
        return ssm_scan_meta(x, dt, A, Bc, Cc, D, h0, chunk, chunk_states)
    raise ValueError(f"ssm_scan: no kernel for device {x.device}")


class SSMScan(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU), keeping the state
    entering each chunk.  Backward: chunk by chunk in reverse, through the
    plain chunk recurrence ``ref.ssm_scan_chunk`` rebuilt from that state."""

    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, D, h0, chunk):
        y, h_last, hs = ssm_scan_fwd(x, dt, A, Bc, Cc, D, h0, chunk, chunk_states=True)
        ctx.save_for_backward(x, dt, A, Bc, Cc, D, hs)
        ctx.chunk = chunk
        ctx.has_h0 = h0 is not None
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, A, Bc, Cc, D, hs = ctx.saved_tensors
        chunk = ctx.chunk
        K = A.shape[0]
        R, L, Dm = x.shape
        lanes = lambda t: ref._lanes(t, K)  # noqa: E731
        xl, dtl, Bl, Cl, dyl = (lanes(t) for t in (x, dt, Bc, Cc, dy))
        hsl = lanes(hs)
        f32 = dict(dtype=torch.float32, device=x.device)
        gx, gdt = torch.empty(xl.shape, **f32), torch.empty(xl.shape, **f32)
        gB, gC = torch.empty(Bl.shape, **f32), torch.empty(Bl.shape, **f32)
        gA, gD = torch.zeros(A.shape, **f32), torch.zeros(D.shape, **f32)
        dh = lanes(dh_last).float()
        leaf = lambda t: t.detach().float().requires_grad_(True)  # noqa: E731
        with torch.enable_grad():
            for c in reversed(range(hs.shape[1])):
                s, e = c * chunk, min(L, (c + 1) * chunk)
                xc, dtc, Bcc, Ccc = (leaf(t[:, :, s:e]) for t in (xl, dtl, Bl, Cl))
                Ac, Dc, hc = leaf(A), leaf(D), leaf(hsl[:, :, c])
                yc, h_out = ref.ssm_scan_chunk(xc, dtc, Bcc, Ccc, Ac, hc)
                yc = yc + xc * Dc[:, None, None]
                g = torch.autograd.grad((yc, h_out), (xc, dtc, Bcc, Ccc, Ac, Dc, hc),
                                        (dyl[:, :, s:e].float(), dh))
                gx[:, :, s:e], gdt[:, :, s:e] = g[0], g[1]
                gB[:, :, s:e], gC[:, :, s:e] = g[2], g[3]
                gA += g[4]
                gD += g[5]
                dh = g[6]
                del g, yc, h_out
        rows = lambda t, like: t.reshape(like.shape).to(like.dtype)  # noqa: E731
        dh0 = dh.reshape(R, Dm, -1) if ctx.has_h0 else None
        return (rows(gx, x), rows(gdt, dt), gA.to(A.dtype), rows(gB, Bc), rows(gC, Cc),
                gD.to(D.dtype), dh0, None)


def ssm_scan(x, dt, A, Bc, Cc, D, h0: Optional[torch.Tensor] = None, chunk: int = 128):
    """Differentiable selective scan over rows (autograd function)."""
    return SSMScan.apply(x, dt, A, Bc, Cc, D, h0, int(chunk))
