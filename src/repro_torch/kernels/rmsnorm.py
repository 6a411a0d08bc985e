"""RMSNorm: the CUDA kernels, their plain versions and the autograd function.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm_pallas`` (body
``_rmsnorm_kernel``).  The forward kernel (``csrc/rmsnorm.cu``) normalises
each row of a lane-batched ``x (K, rows, d)`` with that lane's gain
``gamma (K, d)``; the gain is stored as ``gamma - 1``.  The backward kernel
computes the VJP that the JAX package takes of the reference norm, in
closed form: dx and dgamma in one pass over x and dy, dgamma summed over a
lane's rows without atomics, so its bits repeat from run to run and from
lane to lane.  A CPU tensor takes the plain versions; a CUDA tensor
launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import build, ref

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


def _check(x: torch.Tensor, gamma: torch.Tensor, name: str) -> None:
    if x.dim() != 3 or gamma.dim() != 2 or gamma.shape != (x.shape[0], x.shape[2]):
        raise ValueError(f"{name}: want x (K, rows, d), gamma (K, d); got "
                         f"{tuple(x.shape)}, {tuple(gamma.shape)}")
    if x.dtype not in _SUPPORTED or gamma.dtype not in _SUPPORTED:
        raise TypeError(f"{name}: dtypes {x.dtype}, {gamma.dtype} not in {_SUPPORTED}")
    if not (x.is_cuda and gamma.device == x.device):
        raise ValueError(f"{name}: x and gamma must lie on the same CUDA device")
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
    return out


def rmsnorm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                     eps: float, lanes: Optional[int] = None) -> tuple:
    """Launch the backward on the current stream: (dx, dgamma), each lane's
    rows planned as in a launch of ``lanes`` lanes (default K times
    ``mesh_ranks``; a lane's dgamma bits depend on it).  Its fp32 scratch, a
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
    lanes = K * mesh_ranks if lanes is None else int(lanes)
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
    return dx, dgamma


def rmsnorm_fwd(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_plain(x, gamma, eps)
    if x.is_cuda:
        return rmsnorm_cuda(x, gamma, eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float) -> tuple:
    """(dx, dgamma); dy may be strided or expanded (autograd hands in what the
    output's consumer produced)."""
    dy = dy.contiguous()
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, gamma, dy, eps)
    if x.is_cuda:
        return rmsnorm_bwd_cuda(x, gamma, dy, eps)
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
