"""Kernels of the PyTorch port.

On the CPU: the port's plain RMSNorm and flash attention (the versions a CPU
tensor takes) against the JAX package's Pallas kernels in interpret mode, on
the same numpy inputs, fp32; and a PyTorch model of the bf16 tensor-core
flash kernel's rounding against the Pallas kernel on bf16 inputs.  On an
NVIDIA GPU (marker ``cuda``): each CUDA kernel against its plain version on
the card.

JAX is imported inside the parity tests so that the card-only cases also run
where JAX is not installed:
``python -m pytest tests/test_torch_kernels.py -m cuda``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn

torch.set_num_threads(2)


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    return jax, jnp


def _qkv(rng, B, Sq, H, Hkv, D, Sk=None, Dv=None):
    Sk = Sk or Sq
    Dv = Dv or D
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, Dv)).astype(np.float32)
    return q, k, v


# ------------------------------------------------------------------ CPU parity
@pytest.mark.parametrize("shape", [(2, 24, 64), (1, 5, 384), (3, 16, 96)])
def test_rmsnorm_plain_matches_pallas(shape):
    """The plain RMSNorm against ``rmsnorm_pallas(interpret=True)``, lane by
    lane (the Pallas kernel takes one gain row), at 1e-6."""
    jax, jnp = _jax()
    from repro.kernels.rmsnorm import rmsnorm_pallas

    rng = np.random.default_rng(0)
    K, rows, d = shape
    x = rng.standard_normal(shape).astype(np.float32)
    g = (0.1 * rng.standard_normal((K, d))).astype(np.float32)
    got = rn.rmsnorm_fwd(torch.from_numpy(x), torch.from_numpy(g), 1e-6).numpy()
    for lane in range(K):
        want = rmsnorm_pallas(jnp.asarray(x[lane]), jnp.asarray(g[lane]),
                              interpret=True, block_rows=16)
        np.testing.assert_allclose(got[lane], np.asarray(want), atol=1e-6, rtol=1e-6)


def test_rmsnorm_grads_match_jax_reference_vjp():
    """The autograd function's backward (the closed-form plain backward on
    the CPU) against ``jax.grad`` through the reference norm, per-lane
    gains, 5e-6."""
    jax, jnp = _jax()
    from repro.kernels import ref as jref

    rng = np.random.default_rng(1)
    K, rows, d = 2, 6, 48
    x = rng.standard_normal((K, rows, d)).astype(np.float32)
    g = (0.1 * rng.standard_normal((K, d))).astype(np.float32)

    def jloss(x, g):
        return jnp.sum(jnp.sin(jref.rmsnorm(x, g[:, None, :])))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    torch.sin(ops.rmsnorm(xt, gt)).sum().backward()
    for got, w in zip((xt.grad, gt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-6, rtol=5e-6)


FLASH_CASES = [
    # B, Sq, H, Hkv, D, causal, window, softcap, Sk, Dv, scale (None: D and D**-0.5)
    pytest.param(2, 64, 4, 2, 16, True, None, None, None, None, None, id="gqa-causal"),
    pytest.param(1, 128, 4, 1, 32, True, 40, None, None, None, None, id="window"),
    pytest.param(1, 96, 2, 2, 16, True, None, 20.0, None, None, None, id="softcap"),
    pytest.param(1, 200, 4, 2, 16, True, 64, 30.0, None, None, None, id="ragged-200"),
    pytest.param(1, 80, 2, 1, 16, False, None, None, 112, None, None,
                 id="non-causal-ragged-kv"),
    # MLA's form: q/k wider than v (nope + rope), scale 1/sqrt(q/k width)
    pytest.param(2, 64, 4, 4, 48, True, None, None, None, 32, 48 ** -0.5,
                 id="mla-d48-dv32"),
    pytest.param(1, 100, 4, 2, 48, True, None, None, None, 32, 0.3,
                 id="ragged-100-d48-dv32-scale0.3"),
]


@pytest.mark.parametrize("B,Sq,H,Hkv,D,causal,window,softcap,Sk,Dv,scale", FLASH_CASES)
def test_flash_plain_matches_pallas(B, Sq, H, Hkv, D, causal, window, softcap, Sk, Dv,
                                    scale):
    """Forward output and lse of the plain flash version against
    ``_flash_fwd_pallas(interpret=True)`` at 3e-5, and the gradients of the
    autograd function (plain blocked backward) against ``jax.grad`` through
    the Pallas flash attention at 5e-5; v may be narrower than q and k."""
    jax, jnp = _jax()
    from repro.kernels.flash_attention import _flash_fwd_pallas, flash_attention

    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, B, Sq, H, Hkv, D, Sk=Sk, Dv=Dv)
    kw = dict(causal=causal, window=window, softcap=softcap)
    scale = scale or D ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_out, want_lse = _flash_fwd_pallas(jq, jk, jv, scale=scale, block_q=64,
                                           block_kv=64, interpret=True, **kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = fa.flash_fwd_plain(tq.detach(), tk.detach(), tv.detach(), scale=scale, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=3e-5, rtol=3e-5)

    def jloss(q, k, v):
        return (flash_attention(q, k, v, scale=scale, block_q=64, block_kv=64,
                                interpret=True, **kw) ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    got_out = ops.attention(tq, tk, tv, scale=scale, **kw)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(want_out),
                               atol=3e-5, rtol=3e-5)
    (got_out ** 2).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-5, rtol=5e-5)


def _sm90_model(q, k, v, *, causal, window, softcap, scale):
    """The bf16 tensor-core kernel's arithmetic (``csrc/flash_attention_sm90.cu``)
    in PyTorch: fp32 scores from bf16 q and k, the scale on the fp32 scores
    (log2 e folded in, after the tanh under a softcap), an online softmax over
    kv tiles of the kernel's BK rows in log2 units, P rounded to bf16 before
    P V, fp32 l and O; out in bf16, lse in natural-log units."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    g = H // Hkv
    bk = 64 if max(D, Dv) > 128 else 128
    log2e = 1.0 / math.log(2.0)
    qf = q.float().reshape(B, Sq, Hkv, g, D)
    m = torch.full((B, Hkv, g, Sq), -math.inf)
    l = torch.zeros((B, Hkv, g, Sq))
    o = torch.zeros((B, Hkv, g, Sq, Dv))
    q_pos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, bk):
        kt, vt = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk].float()
        s = torch.einsum("bqngd,bknd->bngqk", qf, kt)
        s = (softcap * log2e) * torch.tanh(s * scale / softcap) if softcap else s * (scale * log2e)
        k_pos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        mask = torch.ones((Sq, kt.shape[1]), dtype=torch.bool)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        mu = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp2(m - mu)
        p = torch.exp2(s - mu[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bngqk,bknd->bngqd",
                                               p.bfloat16().float(), vt)
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(m == -math.inf, fa.NEG_INF, (m + torch.log2(l)) * math.log(2.0))
    return (out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).bfloat16(),
            lse.reshape(B, H, Sq))


SM90_CASES = [
    # B, Sq, H, Hkv, D, causal, window, softcap, Sk, Dv, scale (None: D and D**-0.5)
    pytest.param(2, 64, 4, 2, 16, True, None, None, None, None, None, id="gqa-causal-d16"),
    pytest.param(1, 160, 4, 2, 96, True, 40, None, None, None, None, id="window-d96"),
    pytest.param(1, 128, 2, 1, 128, True, None, 20.0, None, None, None, id="softcap-d128"),
    pytest.param(1, 200, 4, 2, 128, True, 64, 30.0, 130, None, None,
                 id="ragged-200-130-d128"),
    pytest.param(1, 130, 6, 1, 16, False, None, None, 200, None, None,
                 id="non-causal-130-200-gqa6"),
    # MLA's form: the 256-wide instance pads both to max(D, Dv), BK = 64
    pytest.param(1, 200, 4, 4, 192, True, None, None, None, 128, 192 ** -0.5,
                 id="mla-d192-dv128"),
    pytest.param(2, 64, 4, 4, 48, True, None, None, None, 32, 48 ** -0.5,
                 id="mla-d48-dv32"),
]


@pytest.mark.parametrize("B,Sq,H,Hkv,D,causal,window,softcap,Sk,Dv,scale", SM90_CASES)
def test_sm90_rounding_model_matches_pallas_bf16(B, Sq, H, Hkv, D, causal, window, softcap,
                                                 Sk, Dv, scale, record_property):
    """Rounding P to bf16 before P V (the tensor-core kernel's one change of
    arithmetic against the Pallas kernel, which multiplies P in fp32) stays
    inside the bf16 gate: the kernel's model against
    ``_flash_fwd_pallas(interpret=True)`` on the same bf16 inputs, 3e-2 on out
    and lse.  The observed maxima are recorded as test properties."""
    jax, jnp = _jax()
    from repro.kernels.flash_attention import _flash_fwd_pallas

    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(rng, B, Sq, H, Hkv, D, Sk=Sk, Dv=Dv))
    kw = dict(causal=causal, window=window, softcap=softcap)
    scale = scale or D ** -0.5
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    want_out, want_lse = _flash_fwd_pallas(jq, jk, jv, scale=scale, block_q=64,
                                           block_kv=64, interpret=True, **kw)
    want_out = torch.from_numpy(np.array(want_out.astype(jnp.float32)))
    want_lse = torch.from_numpy(np.array(want_lse))
    out, lse = _sm90_model(q, k, v, scale=scale, **kw)
    record_property("max_abs_err_out", float((out.float() - want_out).abs().max()))
    record_property("max_abs_err_lse", float((lse - want_lse).abs().max()))
    torch.testing.assert_close(out.float(), want_out, atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(lse, want_lse, atol=3e-2, rtol=3e-2)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers take the plain versions: no launch counted
    (neither flash kernel's, in either dtype; neither RMSNorm kernel's, forward
    or backward) and no library built."""
    rn.reset_launches()
    fa.reset_launches()
    x = torch.ones(1, 4, 32, requires_grad=True)
    ops.rmsnorm(x, torch.zeros(1, 32, requires_grad=True)).sum().backward()
    assert rn.launches_bwd == 0
    q = torch.ones(1, 8, 2, 16)
    ops.attention(q, q, q)
    ops.attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    assert rn.launches == 0 and fa.launches == 0
    assert fa.launches_sm90 == 0 and fa.launches_fp32 == 0


def test_flash_rejects_unsupported_head_dim():
    q = torch.ones(1, 8, 2, 24)
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.attention(q, q, q)


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    for src, tpu in (("rmsnorm.cu", "rmsnorm_pallas"),
                     ("flash_attention.cu", "_flash_fwd_pallas"),
                     ("flash_attention_sm90.cu", "_flash_fwd_pallas")):
        text = (build.CSRC / src).read_text()
        assert tpu in text and "Bound on this card" in text


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,xdt,gdt", [
    ((2, 33, 64), torch.float32, torch.float32),
    ((3, 17, 100), torch.float32, torch.float32),
    ((3, 17, 100), torch.bfloat16, torch.bfloat16),     # d not a vector multiple
    ((2, 40, 3072), torch.bfloat16, torch.bfloat16),
    ((1, 9, 384), torch.bfloat16, torch.float32),
    ((1, 9, 384), torch.float32, torch.bfloat16),
    ((2, 2048, 8192), torch.bfloat16, torch.bfloat16),  # jamba's d_model
    ((1, 4096, 6144), torch.bfloat16, torch.float32),
])
def test_rmsnorm_kernel_matches_plain(cuda, shape, xdt, gdt):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(xdt)
    g = (0.1 * torch.randn((shape[0], shape[2]), generator=gen, device=cuda)).to(gdt)
    before = rn.launches
    got = rn.rmsnorm_cuda(x, g, 1e-6)
    torch.cuda.synchronize()
    assert rn.launches == before + 1
    want = rn.rmsnorm_plain(x, g, 1e-6)
    tol = 1e-5 if xdt == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,H,Hkv,D,causal,window,softcap,Sk,dtype,Dv", [
    (2, 64, 4, 2, 16, True, None, None, None, torch.float32, None),
    (1, 200, 4, 2, 16, True, 64, 30.0, None, torch.float32, None),
    (1, 80, 2, 1, 32, False, None, None, 112, torch.float32, None),
    (2, 256, 6, 2, 128, True, None, None, None, torch.float32, None),
    (1, 130, 2, 1, 256, True, 50, None, None, torch.float32, None),
    (2, 256, 6, 2, 128, True, None, None, None, torch.bfloat16, None),
    # bf16: the tensor-core kernel at every head-dim instance and feature
    (2, 64, 4, 2, 16, True, None, None, None, torch.bfloat16, None),
    (1, 192, 4, 2, 64, True, None, None, None, torch.bfloat16, None),
    (1, 200, 4, 2, 96, True, None, None, None, torch.bfloat16, None),
    (1, 300, 4, 2, 256, True, 96, 50.0, None, torch.bfloat16, None),
    (1, 130, 2, 1, 64, True, None, None, None, torch.bfloat16, 128),
    (1, 130, 2, 1, 256, False, None, None, None, torch.bfloat16, 64),
    (1, 200, 4, 2, 16, True, 64, 30.0, None, torch.bfloat16, None),
    (1, 200, 4, 2, 128, False, None, None, 130, torch.bfloat16, None),
    (1, 130, 4, 2, 128, True, 48, None, 200, torch.bfloat16, None),
    (2, 384, 24, 2, 128, True, None, None, None, torch.bfloat16, None),
    # MLA (deepseek-v2-lite): q/k 192 wide (nope + rope), v 128 wide
    (2, 300, 16, 16, 192, True, None, None, None, torch.bfloat16, 128),
    (1, 200, 4, 4, 192, True, None, None, None, torch.float32, 128),
])
def test_flash_kernel_matches_plain(cuda, B, Sq, H, Hkv, D, causal, window, softcap,
                                    Sk, dtype, Dv):
    """Each dtype's kernel against the plain version: bf16 goes to the
    tensor-core kernel (``launches_sm90``), fp32 to the CUDA-core kernel
    (``launches_fp32``), and nothing else launches."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    Sk = Sk or Sq
    Dv = Dv or D
    q = torch.randn((B, Sq, H, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, Sk, Hkv, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, Sk, Hkv, Dv), generator=gen, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=D ** -0.5)
    before = (fa.launches, fa.launches_sm90, fa.launches_fp32)
    out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    sm90 = dtype == torch.bfloat16
    assert (fa.launches, fa.launches_sm90, fa.launches_fp32) == (
        before[0] + 1, before[1] + sm90, before[2] + (not sm90))
    want_out, want_lse = fa.flash_fwd_plain(q, k, v, **kw)
    tol = 3e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_sm90_fully_masked_rows(cuda):
    """Rows whose window ends before the last key (ragged Sk) see no key: the
    tensor-core kernel writes lse = NEG_INF and out = 0 there, exactly."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    Sq, Sk, window = 200, 130, 32
    q = torch.randn((1, Sq, 4, 64), generator=gen, device=cuda).bfloat16()
    k = torch.randn((1, Sk, 2, 64), generator=gen, device=cuda).bfloat16()
    v = torch.randn((1, Sk, 2, 64), generator=gen, device=cuda).bfloat16()
    out, lse = fa.flash_fwd_cuda(q, k, v, causal=True, window=window, softcap=None,
                                 scale=0.125)
    torch.cuda.synchronize()
    dead = Sk - 1 + window          # first row with k > q - window for no k < Sk
    assert bool((lse[:, :, dead:] == fa.NEG_INF).all())
    assert bool((out[:, dead:] == 0).all())
    assert bool((lse[:, :, :dead] > fa.NEG_INF / 2).all())
