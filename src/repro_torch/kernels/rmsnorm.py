"""RMSNorm: the CUDA kernels, their plain versions and the autograd function.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm_pallas`` (body
``_rmsnorm_kernel``).  The forward kernel (``csrc/rmsnorm.cu``) normalises
each row of a lane-batched ``x (K, rows, d)`` with that lane's gain
``gamma (K, d)``; the gain is stored as ``gamma - 1``.  The backward kernel
computes the VJP that the JAX package takes of the reference norm, in
closed form: dx and dgamma in one pass over x and dy, dgamma summed over a
lane's rows without atomics, so its bits repeat from run to run and from
lane to lane.  A CPU tensor takes the plain versions; a CUDA tensor
launches the kernels or raises.  A tensor on the meta device (the dry run,
``launch/dryrun.py``) gets empty outputs of the kernels' shapes and dtypes,
and the kernel's work (``cost``) goes to the op-cost walk
(``kernels/walk.py``), as a launch on the card reports it while a walk is
active.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import Optional

import torch

from . import build, ref, walk

_SUPPORTED = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()
launches = 0      # forward kernel launches in this process (plain-version calls excluded)
launches_bwd = 0  # backward kernel launches


# The ranks of the population mesh this process is a rank of (1: none).  A
# rank trains K of the population's K * mesh_ranks lanes, and the backward
# plans their rows as the unsharded launch of all of them does, so a lane's
# dgamma bits do not depend on the mesh (``distributed/sharding.py`` sets it
# for the mesh's life).
mesh_ranks = 1


def plan_for_mesh(n: int) -> None:
    global mesh_ranks
    mesh_ranks = max(int(n), 1)


# The lanes a launch's rows are planned for, whatever K and the mesh are
# (None: K * mesh_ranks).  An elastic flight that regrids K lanes to K' < K
# plans its survivors as the K-lane launch it started with, so their dgamma
# bits are the fixed-width flight's.
planned_lanes: Optional[int] = None


@contextlib.contextmanager
def plan_lanes(n: int):
    """Plan every backward launch's rows for ``n`` lanes while the context
    lasts (a flight's life), then restore the plan found."""
    global planned_lanes
    saved, planned_lanes = planned_lanes, max(int(n), 1)
    try:
        yield
    finally:
        planned_lanes = saved


def lanes_for(k: int) -> int:
    """The lanes a backward launch of ``k`` lanes plans its rows for:
    ``planned_lanes`` (never fewer than ``k``), else ``k * mesh_ranks``."""
    k = int(k)
    return k * mesh_ranks if planned_lanes is None else max(planned_lanes, k)


def reset_launches() -> None:
    global launches, launches_bwd
    with _count_lock:
        launches = 0
        launches_bwd = 0


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """x (K, rows, d), gamma (K, d) -> x's shape and dtype."""
    return ref.rmsnorm(x, gamma[:, None, :], eps)


def rmsnorm_bwd_plain(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                      eps: float) -> tuple:
    """The VJP of ``rmsnorm_plain`` in closed form, in fp32: with r =
    rsqrt(mean(x^2) + eps) and w = 1 + gamma of the row's lane,
    dx = r w dy - (r^3 / d) x sum(dy w x) and dgamma = the lane's sum over
    rows of dy x r; dx in x's dtype, dgamma in gamma's."""
    xf, dyf = x.float(), dy.float()
    w = 1.0 + gamma.float()[:, None, :]
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    s = torch.sum(dyf * w * xf, dim=-1, keepdim=True)
    dx = r * w * dyf - (r * r * r / x.shape[-1]) * xf * s
    dgamma = torch.sum(dyf * xf * r, dim=1)
    return dx.to(x.dtype), dgamma.to(gamma.dtype)


def cost(shapes, dtypes, backward: bool = False) -> tuple:
    """(operations, HBM bytes) of one launch at x ``shapes[0]`` (K, rows, d)
    and gain ``shapes[1]`` (K, d) in ``dtypes``: the forward reads x and the
    gain and writes the output, 4 operations an element (square, sum,
    scale, gain); the backward reads x, dy and the gain and writes dx and
    dgamma, 10 an element.  Each byte is counted once."""
    (xs, gs), (xd, gd) = shapes, dtypes
    n = math.prod(xs)
    xb, gb = n * xd.itemsize, math.prod(gs) * gd.itemsize
    return (10 * n, 3 * xb + 2 * gb) if backward else (4 * n, 2 * xb + gb)


def _record(x: torch.Tensor, gamma: torch.Tensor, backward: bool = False) -> None:
    if walk.active():
        walk.record("rmsnorm_bwd" if backward else "rmsnorm",
                    *cost((x.shape, gamma.shape), (x.dtype, gamma.dtype), backward))


def _check(x: torch.Tensor, gamma: torch.Tensor, name: str, device: str = "cuda") -> None:
    if x.dim() != 3 or gamma.dim() != 2 or gamma.shape != (x.shape[0], x.shape[2]):
        raise ValueError(f"{name}: want x (K, rows, d), gamma (K, d); got "
                         f"{tuple(x.shape)}, {tuple(gamma.shape)}")
    if x.dtype not in _SUPPORTED or gamma.dtype not in _SUPPORTED:
        raise TypeError(f"{name}: dtypes {x.dtype}, {gamma.dtype} not in {_SUPPORTED}")
    if not (x.device.type == device and gamma.device == x.device):
        raise ValueError(f"{name}: x and gamma must lie on the same "
                         f"{'CUDA' if device == 'cuda' else device} device")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError(f"{name}: x and gamma must be contiguous")


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on what it does not take."""
    global launches
    _check(x, gamma, "rmsnorm")
    K, rows, d = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rmsnorm_fwd(x.data_ptr(), gamma.data_ptr(), out.data_ptr(), K, rows, d,
                          float(eps), int(x.dtype == torch.bfloat16),
                          int(gamma.dtype == torch.bfloat16), stream)
    build.check(err, "rmsnorm_fwd")
    with _count_lock:
        launches += 1
    _record(x, gamma)
    return out


def rmsnorm_meta(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """The forward on the meta device: the kernel's output, empty, and its
    cost recorded."""
    _check(x, gamma, "rmsnorm", "meta")
    out = torch.empty_like(x)
    _record(x, gamma)
    return out


def rmsnorm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                     eps: float, lanes: Optional[int] = None) -> tuple:
    """Launch the backward on the current stream: (dx, dgamma), each lane's
    rows planned as in a launch of ``lanes`` lanes (default
    ``planned_lanes``, else K times ``mesh_ranks``; a lane's dgamma bits
    depend on it).  Its fp32 scratch, a
    partial dgamma row a block, comes from the torch allocator, so the
    launch can be captured in a CUDA graph.  Raises on what it does not
    take."""
    global launches_bwd
    _check(x, gamma, "rmsnorm_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy must match x; got {tuple(dy.shape)} {dy.dtype} "
                         f"on {dy.device}")
    if not dy.is_contiguous():
        raise ValueError("rmsnorm_bwd: dy must be contiguous")
    K, rows, d = x.shape
    lanes = lanes_for(K) if lanes is None else int(lanes)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx, torch.zeros_like(gamma)
    lib = build.library()
    flags = (int(x.dtype == torch.bfloat16), int(gamma.dtype == torch.bfloat16))
    ptrs = (x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr())
    blocks = ctypes.c_int()
    build.check(lib.rmsnorm_bwd_blocks(*ptrs, K, lanes, rows, d, *flags,
                                       ctypes.byref(blocks)), "rmsnorm_bwd_blocks")
    dgamma = torch.empty_like(gamma)
    partials = torch.empty((K, blocks.value, d), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rmsnorm_bwd(*ptrs, dgamma.data_ptr(), partials.data_ptr(), K, lanes, rows, d,
                          float(eps), *flags, blocks.value, stream)
    build.check(err, "rmsnorm_bwd")
    with _count_lock:
        launches_bwd += 1
    _record(x, gamma, backward=True)
    return dx, dgamma


def rmsnorm_bwd_meta(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                     eps: float) -> tuple:
    """The backward on the meta device: (dx, dgamma), empty, and its cost
    recorded.  The kernel's fp32 scratch (a partial dgamma row a block of
    rows) takes a block count that only the built library gives; it is not
    allocated here."""
    _check(x, gamma, "rmsnorm_bwd", "meta")
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    _record(x, gamma, backward=True)
    return dx, dgamma


def rmsnorm_fwd(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_plain(x, gamma, eps)
    if x.is_cuda:
        return rmsnorm_cuda(x, gamma, eps)
    if x.is_meta:
        return rmsnorm_meta(x, gamma, eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float) -> tuple:
    """(dx, dgamma); dy may be strided or expanded (autograd hands in what the
    output's consumer produced)."""
    dy = dy.contiguous()
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, gamma, dy, eps)
    if x.is_cuda:
        return rmsnorm_bwd_cuda(x, gamma, dy, eps)
    if x.is_meta:
        return rmsnorm_bwd_meta(x, gamma, dy, eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


class RMSNorm(torch.autograd.Function):
    """Forward and backward: the kernels (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return rmsnorm_fwd(x, gamma, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma = rmsnorm_bwd(x, gamma, dy, ctx.eps)
        return dx, dgamma, None


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Differentiable RMSNorm of x (K, rows, d) with per-lane gamma (K, d)."""
    return RMSNorm.apply(x, gamma, float(eps))
