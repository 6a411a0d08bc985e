"""Flash attention forward: the CUDA kernel, its plain version and its
autograd function.

Replaces ``repro/kernels/flash_attention.py::_flash_fwd_pallas`` (body
``_flash_kernel``).  Semantics of the Pallas kernel: grouped-query heads (q
head ``h`` reads kv head ``h // g``), causal / sliding-window masks and the
logit softcap, ragged ``Sq``/``Sk`` masked with ``q_pos < sq & k_pos < sk``,
an fp32 online softmax, and an fp32 ``lse (B, H, Sq)`` that is ``NEG_INF`` on
fully masked rows.  The output has q's dtype.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(``csrc/flash_attention.cu``) or raises.  The backward pass is the plain
blocked flash backward ``ref._blocked_bwd`` fed the kernel's ``lse``, as in
the JAX package's ``_make_flash``.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from . import build, ref

NEG_INF = ref.NEG_INF
BWD_BLOCK = 512  # block_q = block_kv of the plain backward (JAX default)
_SUPPORTED = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()
launches = 0  # kernel launches in this process (plain-version calls excluded)


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def flash_fwd_plain(q, k, v, *, causal: bool, window: Optional[int],
                    softcap: Optional[float], scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense fp32 statement of the kernel: (out (B,Sq,H,Dv) in q's dtype,
    lse (B,H,Sq) fp32)."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    g = H // Hkv
    dev = q.device
    qf = q.float().reshape(B, Sq, Hkv, g, D) * scale
    s = torch.einsum("bqngd,bknd->bngqk", qf, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=dev)[:, None]
    k_pos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    live = m > NEG_INF / 2
    m_safe = torch.where(live, m, 0.0)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.einsum("bngqk,bknd->bqngd", p, v.float())
    out = out / l.permute(0, 3, 1, 2)[..., None]
    lse = torch.where(live, m + torch.log(l), NEG_INF)
    return out.reshape(B, Sq, H, Dv).to(q.dtype), lse.reshape(B, H, Sq)


def _check(q, k, v, window, softcap):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, heads, dim)")
    B, Sq, H, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if (Bk, Sk, Hkv) != tuple(v.shape[:3]) or Bk != B or Dk != D:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not agree")
    if H % Hkv:
        raise ValueError(f"flash_attention: {H} q heads over {Hkv} kv heads")
    Dv = v.shape[3]
    if D % 16 or Dv % 16 or not (0 < D <= 256 and 0 < Dv <= 256):
        raise ValueError(f"flash_attention: head dims {D}, {Dv} must be "
                         f"multiples of 16 up to 256")
    if q.dtype not in _SUPPORTED or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window {window} must be positive")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap {softcap} must be positive")


def flash_fwd_cuda(q, k, v, *, causal: bool, window: Optional[int],
                   softcap: Optional[float], scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream; raises on what it does not take."""
    global launches
    _check(q, k, v, window, softcap)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, Sq, Sk, H, Hkv, D, Dv, float(scale), int(bool(causal)),
        int(window or 0), float(softcap or 0.0), int(q.dtype == torch.bfloat16),
        stream)
    build.check(err, "flash_attn_fwd")
    with _count_lock:
        launches += 1
    return out, lse


def flash_fwd(q, k, v, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        _check(q, k, v, kw["window"], kw["softcap"])
        return flash_fwd_plain(q, k, v, **kw)
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, **kw)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU), saving ``lse``.
    Backward: the plain blocked flash backward from (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        out, lse = flash_fwd(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, window, softcap, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap, scale = ctx.cfg
        B, Sq, H, _ = q.shape
        Hkv = k.shape[2]
        dq, dk, dv = ref._blocked_bwd(
            q, k, v, out, lse.reshape(B, Hkv, H // Hkv, Sq), dout,
            causal=causal, window=window, softcap=softcap, scale=scale,
            q_offset=0, block_q=BWD_BLOCK, block_kv=BWD_BLOCK, causal_skip=True)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Differentiable flash attention (GQA, sliding window, softcap)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, bool(causal), window, softcap, float(scale))
