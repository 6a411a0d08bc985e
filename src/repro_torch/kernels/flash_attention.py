"""Flash attention: the CUDA kernels, their plain versions and the autograd
function.

Replaces ``repro/kernels/flash_attention.py::_flash_fwd_pallas`` (body
``_flash_kernel``).  Semantics of the Pallas kernel: grouped-query heads (q
head ``h`` reads kv head ``h // g``), causal / sliding-window masks and the
logit softcap, ragged ``Sq``/``Sk`` masked with ``q_pos < sq & k_pos < sk``,
an fp32 online softmax, and an fp32 ``lse (B, H, Sq)`` that is ``NEG_INF`` on
fully masked rows.  The output has q's dtype.

A CPU tensor takes the plain version; a CUDA tensor launches a kernel or
raises.  The forward goes by dtype: bf16 runs the tensor-core kernel
(``csrc/flash_attention_sm90.cu``: wgmma, TMA-fed K/V ring), fp32 the exact
CUDA-core kernel (``csrc/flash_attention.cu``).  ``launches_sm90`` and
``launches_fp32`` count each; ``launches`` is their sum.

The backward is the VJP the JAX package computes in plain jnp
(``_make_flash.bwd``: the blocked backward fed the forward's ``lse``).  On
the card it is hand-written too (``csrc/flash_attention_bwd.cu``: a dK/dV
kernel and a dQ kernel, the row sums of dO O formed by the dQ kernel or a
pre-pass; no atomics), bf16 on the tensor cores (wgmma + TMA at the main
paths' widths, mma.sync at the others) and
fp32 in exact FMAs, counted by ``launches_bwd_bf16`` and
``launches_bwd_fp32``; ``bwd_plan`` names its tiles, how a kv head's group
of q heads splits over blocks and the fp32 scratch that takes.  On the CPU
its plain version ``flash_bwd_plain`` runs (``ref._blocked_bwd``).

A tensor on the meta device (the dry run) gets empty outputs, and the
kernel's work (``cost``) goes to the op-cost walk (``kernels/walk.py``), as a
launch on the card reports it while a walk is active.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from . import build, ref, walk

NEG_INF = ref.NEG_INF
BWD_BLOCK = 512  # block_q = block_kv of the plain backward (JAX default)
# the dK/dV blocks a batch row that the wgmma backward's split of a kv head's
# group aims at (a quarter of the card's 132 SMs): more runs fill the card at
# small batches, and each run past the first adds an fp32 partial's round
# trip at large ones
SPLIT_BLOCKS = 32
_SUPPORTED = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()
# kernel launches in this process (plain-version calls excluded)
launches_sm90 = 0   # bf16, tensor-core kernel
launches_fp32 = 0   # fp32, CUDA-core kernel
launches = 0        # launches_sm90 + launches_fp32
launches_bwd_bf16 = 0   # backward, bf16, tensor cores
launches_bwd_fp32 = 0   # backward, fp32, CUDA cores


def reset_launches() -> None:
    global launches, launches_sm90, launches_fp32, launches_bwd_bf16, launches_bwd_fp32
    with _count_lock:
        launches = launches_sm90 = launches_fp32 = 0
        launches_bwd_bf16 = launches_bwd_fp32 = 0


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


def visible_pairs(sq: int, sk: int, causal: bool, window: Optional[int]) -> int:
    """The (q, k) pairs a head attends to: query i sees keys j < sk with
    j <= i when causal and j > i - window under a window."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window is not None else np.zeros(sq, dtype=np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def cost(shapes, dtypes, causal: bool = True, window: Optional[int] = None,
         backward: bool = False) -> tuple:
    """(operations, HBM bytes) of one launch at q ``shapes[0]`` (B, Sq, H,
    D), k ``shapes[1]`` (B, Sk, Hkv, D) and v ``shapes[2]`` (B, Sk, Hkv, Dv)
    in ``dtypes``.  The forward: two products of D + Dv multiply-adds over
    each visible (q, k) pair of each head; q, k and v read once, the output
    (H heads of Dv) and the fp32 lse written once.  The backward: five
    products (S, dP, dV, dK, dQ), 3 D + 2 Dv multiply-adds a pair; q, k, v,
    out, dout and lse read once, dq, dk and dv written once."""
    (B, Sq, H, D), (_, Sk, _, _), (_, _, _, Dv) = shapes
    qd, kd, vd = dtypes
    pairs = B * H * visible_pairs(Sq, Sk, causal, window)
    qkv = (math.prod(shapes[0]) * qd.itemsize + math.prod(shapes[1]) * kd.itemsize
           + math.prod(shapes[2]) * vd.itemsize)
    o_bytes, lse_bytes = B * Sq * H * Dv * qd.itemsize, B * H * Sq * 4
    if backward:
        return 2 * pairs * (3 * D + 2 * Dv), 2 * qkv + 2 * o_bytes + lse_bytes
    return 2 * pairs * (D + Dv), qkv + o_bytes + lse_bytes


def _record(q, k, v, causal, window, backward: bool = False) -> None:
    if walk.active():
        walk.record("flash_attention_bwd" if backward else "flash_attention",
                    *cost((q.shape, k.shape, v.shape), (q.dtype, k.dtype, v.dtype),
                          causal, window, backward))


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
    """Launch the dtype's kernel on the current stream (bf16: tensor cores,
    fp32: CUDA cores); raises on what it does not take."""
    global launches, launches_sm90, launches_fp32
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
    sm90 = q.dtype == torch.bfloat16
    name = "flash_attn_fwd_sm90" if sm90 else "flash_attn_fwd"
    err = getattr(build.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, Sq, Sk, H, Hkv, D, Dv, float(scale), int(bool(causal)),
        int(window or 0), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    with _count_lock:
        launches += 1
        if sm90:
            launches_sm90 += 1
        else:
            launches_fp32 += 1
    _record(q, k, v, causal, window)
    return out, lse


def flash_fwd_meta(q, k, v, *, causal: bool, window: Optional[int],
                   softcap: Optional[float], scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward on the meta device: empty ``out`` and ``lse`` and the
    kernel's cost recorded."""
    _check(q, k, v, window, softcap)
    if not (q.is_meta and k.is_meta and v.is_meta):
        raise ValueError("flash_attention: q, k, v must lie on the meta device")
    B, Sq, H, _ = q.shape
    Dv = v.shape[3]
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _record(q, k, v, causal, window)
    return out, lse


def flash_fwd(q, k, v, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        _check(q, k, v, kw["window"], kw["softcap"])
        return flash_fwd_plain(q, k, v, **kw)
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, **kw)
    if q.is_meta:
        return flash_fwd_meta(q, k, v, **kw)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


# -- backward -------------------------------------------------------------------------
def flash_bwd_plain(q, k, v, out, lse, dout, *, causal: bool, window: Optional[int],
                    softcap: Optional[float], scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The blocked flash backward (JAX's ``_make_flash.bwd``) in the kernel's
    signature: ``lse`` (B, H, Sq); (dq, dk, dv) in the inputs' dtypes."""
    B, Sq, H, _ = q.shape
    Hkv = k.shape[2]
    return ref._blocked_bwd(
        q, k, v, out, lse.reshape(B, Hkv, H // Hkv, Sq), dout,
        causal=causal, window=window, softcap=softcap, scale=scale,
        q_offset=0, block_q=BWD_BLOCK, block_kv=BWD_BLOCK, causal_skip=True)


def _check_bwd(q, k, v, out, lse, dout, window, softcap) -> None:
    _check(q, k, v, window, softcap)
    B, Sq, H, _ = q.shape
    want = (B, Sq, H, v.shape[3])
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != want or t.dtype != q.dtype:
            raise ValueError(f"flash_attention backward: {name} {tuple(t.shape)} "
                             f"{t.dtype}, want {want} {q.dtype}")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: lse {tuple(lse.shape)} {lse.dtype}, "
                         f"want {(B, H, Sq)} float32")


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How a backward launch tiles its work: which kernels (``wgmma``,
    ``mma.sync`` or ``fp32``) at which instance (the widths D and Dv run
    at), the kv rows of a dK/dV block and the q rows of each of its steps,
    the q rows of a dQ block and the kv rows of each of its steps, and
    ``splits``: the runs a kv head's q heads split into, a dK/dV block each,
    each run (where there are several) writing an fp32 partial that the
    launch sums in run order."""
    kernels: str
    instance: Tuple[int, int]
    kv_rows: int
    q_step: int
    q_rows: int
    kv_step: int
    splits: int
    heads: Tuple[int, int]      # (H, Hkv)
    lengths: Tuple[int, int]    # (Sq, Sk)
    widths: Tuple[int, int]     # (D, Dv)

    def scratch(self, B: int) -> list:
        """The launch's fp32 scratch at batch ``B``: the row sums (B, H,
        Sq), then with splits > 1 the partial dk and dv (B, Sk, Hkv *
        splits, D / Dv)."""
        (H, Hkv), (Sq, Sk), (D, Dv) = self.heads, self.lengths, self.widths
        out = [(B, H, Sq)]
        if self.splits > 1:
            out += [(B, Sk, Hkv * self.splits, D), (B, Sk, Hkv * self.splits, Dv)]
        return out


def bwd_plan(H: int, Hkv: int, Sq: int, Sk: int, D: int, Dv: int, causal: bool,
             window: Optional[int], dtype: torch.dtype) -> BwdPlan:
    """The backward's plan (``csrc/flash_attention_bwd.cu`` follows it): a
    function of the heads, lengths, widths, masks and dtype, never of the
    batch's extent, so a lane's bits are its own rows' alone.  bf16 at D,
    Dv <= 128 past 64 and at D <= 192, Dv <= 128 runs the wgmma kernels: a
    kv head's g q heads split into the fewest runs (a divisor of g) that give
    ``SPLIT_BLOCKS`` dK/dV blocks a batch row.  The other bf16 widths run
    the mma.sync kernels and fp32 the CUDA-core ones, both with a partial a
    q head under grouped heads.  ``causal`` and ``window`` shape no choice
    today."""
    del causal, window
    g = H // Hkv
    common = dict(heads=(H, Hkv), lengths=(Sq, Sk), widths=(D, Dv))
    per_head = g if g > 1 else 1
    if dtype == torch.float32:
        dp = 64 if max(D, Dv) <= 64 else 128 if max(D, Dv) <= 128 else 256
        return BwdPlan("fp32", (dp, dp), 32, 32, 32, 32, per_head, **common)
    if D <= 64 and Dv <= 64 or D > 192 or Dv > 128:
        dk, dv = (64, 64) if D <= 64 and Dv <= 64 else (256, 256)
        return BwdPlan("mma.sync", (dk, dv), 64, 64 if dk + dv <= 128 else 32, 64,
                       64 if dk <= 128 else 32, per_head, **common)
    dk = 128 if D <= 128 else 192
    kv_rows = 128
    per_row = Hkv * -(-Sk // kv_rows)
    splits = next((s for s in range(1, g + 1) if g % s == 0 and per_row * s >= SPLIT_BLOCKS), g)
    return BwdPlan("wgmma", (dk, 128), kv_rows, 64 if dk + 128 <= 256 else 32, 128, 64,
                   splits, **common)


def _empty_grads(q, k, v, plan: BwdPlan):
    """dq, dk, dv and the launch's fp32 scratch (``plan.scratch``): the row
    sums (B, H, Sq) and the partial dk and dv, or None where the plan writes
    none."""
    f32 = dict(dtype=torch.float32, device=q.device)
    scratch = [torch.empty(s, **f32) for s in plan.scratch(q.shape[0])]
    parts = tuple(scratch[1:]) or (None, None)
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), scratch[0]) + parts


def _plan_of(q, v, causal, window) -> BwdPlan:
    _, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    return bwd_plan(H, Hkv, Sq, Sk, D, Dv, causal, window, q.dtype)


def flash_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool, window: Optional[int],
                   softcap: Optional[float], scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the dtype's backward on the current stream (bf16: tensor cores,
    fp32: CUDA cores): the row-sum pre-pass, the dK/dV kernel and the dQ
    kernel; raises on what it does not take."""
    global launches_bwd_bf16, launches_bwd_fp32
    _check_bwd(q, k, v, out, lse, dout, window, softcap)
    ts = (q, k, v, out, lse, dout)
    if not (q.is_cuda and all(t.device == q.device for t in ts)):
        raise ValueError("flash_attention backward: q, k, v, out, lse, dout must lie on "
                         "one CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention backward: q, k, v, out, lse, dout must be "
                         "contiguous")
    plan = _plan_of(q, v, causal, window)
    dq, dk, dv, delta, part_k, part_v = _empty_grads(q, k, v, plan)
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    bf16 = q.dtype == torch.bfloat16
    name = "flash_attn_bwd_bf16" if bf16 else "flash_attn_bwd"
    err = getattr(build.library(), name)(
        *(0 if t is None else t.data_ptr()
          for t in (q, k, v, out, dout, lse, delta, part_k, part_v, dq, dk, dv)),
        B, Sq, Sk, H, Hkv, D, Dv, plan.splits, float(scale), int(bool(causal)), int(window or 0),
        float(softcap or 0.0), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    with _count_lock:
        if bf16:
            launches_bwd_bf16 += 1
        else:
            launches_bwd_fp32 += 1
    _record(q, k, v, causal, window, backward=True)
    return dq, dk, dv


def flash_bwd_meta(q, k, v, out, lse, dout, *, causal: bool, window: Optional[int],
                   softcap: Optional[float], scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on the meta device: the buffers the card's launch takes
    (the grads and the plan's scratch), empty, and the kernel's cost
    recorded."""
    _check_bwd(q, k, v, out, lse, dout, window, softcap)
    if not all(t.is_meta for t in (q, k, v, out, lse, dout)):
        raise ValueError("flash_attention backward: inputs must lie on the meta device")
    dq, dk, dv = _empty_grads(q, k, v, _plan_of(q, v, causal, window))[:3]
    _record(q, k, v, causal, window, backward=True)
    return dq, dk, dv


def flash_bwd(q, k, v, out, lse, dout, **kw
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        _check_bwd(q, k, v, out, lse, dout, kw["window"], kw["softcap"])
        return flash_bwd_plain(q, k, v, out, lse, dout, **kw)
    if q.is_cuda:
        return flash_bwd_cuda(q, k, v, out, lse, dout, **kw)
    if q.is_meta:
        return flash_bwd_meta(q, k, v, out, lse, dout, **kw)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU), saving ``lse``.
    Backward: the backward kernel (plain blocked backward on the CPU) from
    (q, k, v, out, lse)."""

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
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(), causal=causal,
                               window=window, softcap=softcap, scale=scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Differentiable flash attention (GQA, sliding window, softcap)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, bool(causal), window, softcap, float(scale))
