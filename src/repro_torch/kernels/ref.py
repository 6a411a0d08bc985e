"""Plain PyTorch oracles for the kernels, ported from ``repro.kernels.ref``.

These are the semantics of record: each hand-written kernel is held against
them on the card, and they are held against the JAX oracles on the CPU.
fp32 accumulation everywhere it matters (softmax, norm statistics).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 statistics; returns x's dtype.  ``gamma`` is stored
    as ``gamma - 1`` and broadcasts against ``x``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def attention(
    q: torch.Tensor,                 # (B, Sq, H, Dq)
    k: torch.Tensor,                 # (B, Sk, Hkv, Dq)
    v: torch.Tensor,                 # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len=None,
) -> torch.Tensor:
    """Grouped-query attention oracle. Returns (B, Sq, H, Dv)."""
    B, Sq, H, Dq = q.shape
    _, Sk, Hkv, Dv = v.shape
    assert H % Hkv == 0, (H, Hkv)
    g = H // Hkv
    scale = scale if scale is not None else Dq ** -0.5
    dev = q.device

    qf = q.float() * scale
    kf = k.float()
    scores = torch.einsum("bqngd,bknd->bngqk", qf.reshape(B, Sq, Hkv, g, Dq), kf)
    scores = _softcap(scores, softcap)

    q_pos = q_offset + torch.arange(Sq, device=dev)[:, None]
    k_pos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    if kv_len is not None:
        mask &= k_pos < kv_len
    scores = torch.where(mask, scores, NEG_INF)

    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", probs, v.float())
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def _block_bounds(iq, nk, block_q, block_kv, q_offset, causal, window, causal_skip):
    """[lo, hi) kv-block range visible to q block ``iq`` (flash skip)."""
    lo = 0
    if causal and causal_skip:
        hi = min(nk, (q_offset + (iq + 1) * block_q + block_kv - 1) // block_kv)
        if window is not None:
            lo = max(0, (q_offset + iq * block_q - window + 1) // block_kv)
    else:
        hi = nk
    return lo, hi


def _block_mask(q_pos, k_pos, causal, window, valid_k):
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    mask &= (k_pos < valid_k)[None, :]
    return mask


def _pad_seq(x: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """Pad axis 1 of a (B, S, ...) tensor at the end."""
    if not pad:
        return x
    shape = (x.shape[0], pad) + tuple(x.shape[2:])
    return torch.cat([x, x.new_full(shape, value)], dim=1)


def _blocked_fwd(
    q, k, v, *, causal, window, softcap, scale, q_offset, kv_len,
    block_q, block_kv, causal_skip,
):
    """Flash-style forward. Returns (out (B,Sq,H,Dv), lse (B,Hkv,g,Sq) fp32)."""
    B, Sq, H, Dq = q.shape
    _, Sk, Hkv, Dv = v.shape
    g = H // Hkv
    dev = q.device
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Sk)
    pad_q = (-Sq) % block_q
    pad_k = (-Sk) % block_kv
    qf = _pad_seq(q.float() * scale, pad_q)
    kf = _pad_seq(k.float(), pad_k)
    vf = _pad_seq(v.float(), pad_k)
    nq, nk = (Sq + pad_q) // block_q, (Sk + pad_k) // block_kv
    kb = kf.reshape(B, nk, block_kv, Hkv, Dq)
    vb = vf.reshape(B, nk, block_kv, Hkv, Dv)
    valid_k = Sk if kv_len is None else kv_len
    qf = qf.reshape(B, nq, block_q, Hkv, g, Dq)

    outs, lses = [], []
    for iq in range(nq):
        qblk = qf[:, iq]
        q_pos = q_offset + iq * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, Hkv, g, block_q), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, g, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, block_q, Hkv, g, Dv), dtype=torch.float32, device=dev)
        lo, hi = _block_bounds(iq, nk, block_q, block_kv, q_offset, causal, window, causal_skip)
        for ik in range(lo, hi):
            s = torch.einsum("bqngd,bknd->bngqk", qblk, kb[:, ik])
            s = _softcap(s, softcap)
            k_pos = ik * block_kv + torch.arange(block_kv, device=dev)
            mask = _block_mask(q_pos, k_pos, causal, window, valid_k)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # fully-masked rows keep m=-inf; exp(-inf - -inf) guard:
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(mask, p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bngqk,bknd->bqngd", p, vb[:, ik])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        lse = m_safe + torch.log(torch.clamp(l, min=1e-30))
        lse = torch.where(torch.isfinite(m), lse, NEG_INF)
        outs.append(out)
        lses.append(lse)
    out = torch.stack(outs, dim=1).reshape(B, nq * block_q, H, Dv)[:, :Sq]
    lse = torch.cat(lses, dim=-1)[..., :Sq]  # (B,Hkv,g,Sq)
    return out.to(q.dtype), lse


def _blocked_bwd(
    q, k, v, out, lse, dout, *, causal, window, softcap, scale, q_offset,
    block_q, block_kv, causal_skip,
):
    """Flash backward: recompute P blockwise from (q, k, lse); no S^2
    residuals.  ``lse`` is (B, Hkv, g, Sq) fp32, NEG_INF on fully masked rows."""
    B, Sq, H, Dq = q.shape
    _, Sk, Hkv, Dv = v.shape
    g = H // Hkv
    dev = q.device
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Sk)
    pad_q = (-Sq) % block_q
    pad_k = (-Sk) % block_kv
    qf = _pad_seq(q.float(), pad_q)
    do = _pad_seq(dout.float(), pad_q)
    of = _pad_seq(out.float(), pad_q)
    if pad_q:
        lse = torch.cat([lse, lse.new_full(lse.shape[:3] + (pad_q,), NEG_INF)], dim=-1)
    kf = _pad_seq(k.float(), pad_k)
    vf = _pad_seq(v.float(), pad_k)
    nq, nk = (Sq + pad_q) // block_q, (Sk + pad_k) // block_kv
    kb = kf.reshape(B, nk, block_kv, Hkv, Dq)
    vb = vf.reshape(B, nk, block_kv, Hkv, Dv)
    qf = qf.reshape(B, nq, block_q, Hkv, g, Dq)
    do = do.reshape(B, nq, block_q, Hkv, g, Dv)
    of = of.reshape(B, nq, block_q, Hkv, g, Dv)
    lse = lse.reshape(B, Hkv, g, nq, block_q)

    dkb = torch.zeros_like(kb)
    dvb = torch.zeros_like(vb)
    dqs = []
    for iq in range(nq):
        qblk, doblk, oblk = qf[:, iq], do[:, iq], of[:, iq]
        lseblk = lse[:, :, :, iq]
        q_pos = q_offset + iq * block_q + torch.arange(block_q, device=dev)
        delta = torch.einsum("bqngd,bqngd->bngq", doblk, oblk)
        # rows with the NEG_INF sentinel (fully masked / q padding) must give
        # p = exp(s - inf) = 0, never exp(s + 1e30)
        lse_safe = torch.where(lseblk > NEG_INF / 2, lseblk, float("inf"))
        lo, hi = _block_bounds(iq, nk, block_q, block_kv, q_offset, causal, window, causal_skip)
        dq = torch.zeros((B, block_q, Hkv, g, Dq), dtype=torch.float32, device=dev)
        for ik in range(lo, hi):
            kblk, vblk = kb[:, ik], vb[:, ik]
            s_raw = scale * torch.einsum("bqngd,bknd->bngqk", qblk, kblk)
            if softcap is not None:
                tanh_val = torch.tanh(s_raw / softcap)
                s = softcap * tanh_val
            else:
                s = s_raw
            k_pos = ik * block_kv + torch.arange(block_kv, device=dev)
            mask = _block_mask(q_pos, k_pos, causal, window, Sk)
            p = torch.where(mask, torch.exp(s - lse_safe[..., None]), 0.0)
            dv_c = torch.einsum("bngqk,bqngd->bknd", p, doblk)
            dp = torch.einsum("bqngd,bknd->bngqk", doblk, vblk)
            ds = p * (dp - delta[..., None])
            if softcap is not None:
                ds = ds * (1.0 - tanh_val * tanh_val)
            ds = ds * scale
            dq = dq + torch.einsum("bngqk,bknd->bqngd", ds, kblk)
            dk_c = torch.einsum("bngqk,bqngd->bknd", ds, qblk)
            dkb[:, ik] += dk_c
            dvb[:, ik] += dv_c
        dqs.append(dq)
    dq = torch.stack(dqs, dim=1).reshape(B, nq * block_q, H, Dq)[:, :Sq]
    dk = dkb.reshape(B, nk * block_kv, Hkv, Dq)[:, :Sk]
    dv = dvb.reshape(B, nk * block_kv, Hkv, Dv)[:, :Sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
