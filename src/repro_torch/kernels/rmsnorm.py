"""RMSNorm: the CUDA kernel, its plain version and its autograd function.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm_pallas`` (body
``_rmsnorm_kernel``).  The kernel (``csrc/rmsnorm.cu``) normalises each row of
a lane-batched ``x (K, rows, d)`` with that lane's gain ``gamma (K, d)``; the
gain is stored as ``gamma - 1``.  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  The backward pass is the plain
version's autograd, as the JAX package takes the reference norm's VJP.
"""
from __future__ import annotations

import threading

import torch

from . import build, ref

_SUPPORTED = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()
launches = 0  # kernel launches in this process (plain-version calls excluded)


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """x (K, rows, d), gamma (K, d) -> x's shape and dtype."""
    return ref.rmsnorm(x, gamma[:, None, :], eps)


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on what it does not take."""
    global launches
    if x.dim() != 3 or gamma.dim() != 2 or gamma.shape != (x.shape[0], x.shape[2]):
        raise ValueError(f"rmsnorm: want x (K, rows, d), gamma (K, d); got "
                         f"{tuple(x.shape)}, {tuple(gamma.shape)}")
    if x.dtype not in _SUPPORTED or gamma.dtype not in _SUPPORTED:
        raise TypeError(f"rmsnorm: dtypes {x.dtype}, {gamma.dtype} not in {_SUPPORTED}")
    if not (x.is_cuda and gamma.device == x.device):
        raise ValueError("rmsnorm: x and gamma must lie on the same CUDA device")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm: x and gamma must be contiguous")
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


def rmsnorm_fwd(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_plain(x, gamma, eps)
    if x.is_cuda:
        return rmsnorm_cuda(x, gamma, eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


class RMSNorm(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU).  Backward: autograd
    through the plain version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return rmsnorm_fwd(x, gamma, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            gg = gamma.detach().requires_grad_(True)
            y = rmsnorm_plain(xx, gg, ctx.eps)
            dx, dg = torch.autograd.grad(y, (xx, gg), dy)
        return dx, dg, None


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Differentiable RMSNorm of x (K, rows, d) with per-lane gamma (K, d)."""
    return RMSNorm.apply(x, gamma, float(eps))
