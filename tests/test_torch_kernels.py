"""Kernels of the PyTorch port.

On the CPU: the port's plain RMSNorm and flash attention (the versions a CPU
tensor takes) against the JAX package's Pallas kernels in interpret mode, on
the same numpy inputs, fp32.  On an NVIDIA GPU (marker ``cuda``): each CUDA
kernel against its plain version on the card.

JAX is imported inside the parity tests so that the card-only cases also run
where JAX is not installed:
``python -m pytest tests/test_torch_kernels.py -m cuda``.
"""
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
    """The autograd function's backward (plain version's autograd) against
    ``jax.grad`` through the reference norm, per-lane gains, 5e-6."""
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
    # B, Sq, H, Hkv, D, causal, window, softcap, Sk
    pytest.param(2, 64, 4, 2, 16, True, None, None, None, id="gqa-causal"),
    pytest.param(1, 128, 4, 1, 32, True, 40, None, None, id="window"),
    pytest.param(1, 96, 2, 2, 16, True, None, 20.0, None, id="softcap"),
    pytest.param(1, 200, 4, 2, 16, True, 64, 30.0, None, id="ragged-200"),
    pytest.param(1, 80, 2, 1, 16, False, None, None, 112, id="non-causal-ragged-kv"),
]


@pytest.mark.parametrize("B,Sq,H,Hkv,D,causal,window,softcap,Sk", FLASH_CASES)
def test_flash_plain_matches_pallas(B, Sq, H, Hkv, D, causal, window, softcap, Sk):
    """Forward output and lse of the plain flash version against
    ``_flash_fwd_pallas(interpret=True)`` at 3e-5, and the gradients of the
    autograd function (plain blocked backward) against ``jax.grad`` through
    the Pallas flash attention at 5e-5."""
    jax, jnp = _jax()
    from repro.kernels.flash_attention import _flash_fwd_pallas, flash_attention

    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, B, Sq, H, Hkv, D, Sk=Sk)
    kw = dict(causal=causal, window=window, softcap=softcap)
    scale = D ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_out, want_lse = _flash_fwd_pallas(jq, jk, jv, scale=scale, block_q=64,
                                           block_kv=64, interpret=True, **kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = fa.flash_fwd_plain(tq.detach(), tk.detach(), tv.detach(), scale=scale, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=3e-5, rtol=3e-5)

    def jloss(q, k, v):
        return (flash_attention(q, k, v, block_q=64, block_kv=64, interpret=True,
                                **kw) ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    got_out = ops.attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(want_out),
                               atol=3e-5, rtol=3e-5)
    (got_out ** 2).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-5, rtol=5e-5)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers take the plain versions: no launch counted
    and no library built."""
    rn.reset_launches()
    fa.reset_launches()
    x = torch.ones(1, 4, 32)
    ops.rmsnorm(x, torch.zeros(1, 32))
    q = torch.ones(1, 8, 2, 16)
    ops.attention(q, q, q)
    assert rn.launches == 0 and fa.launches == 0


def test_flash_rejects_unsupported_head_dim():
    q = torch.ones(1, 8, 2, 24)
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.attention(q, q, q)


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    for src, tpu in (("rmsnorm.cu", "rmsnorm_pallas"),
                     ("flash_attention.cu", "_flash_fwd_pallas")):
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
    ((3, 17, 100), torch.float32, torch.float32),       # d not a vector multiple
    ((2, 40, 3072), torch.bfloat16, torch.bfloat16),
    ((1, 9, 384), torch.bfloat16, torch.float32),
    ((1, 9, 384), torch.float32, torch.bfloat16),
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
@pytest.mark.parametrize("B,Sq,H,Hkv,D,causal,window,softcap,Sk,dtype", [
    (2, 64, 4, 2, 16, True, None, None, None, torch.float32),
    (1, 200, 4, 2, 16, True, 64, 30.0, None, torch.float32),
    (1, 80, 2, 1, 32, False, None, None, 112, torch.float32),
    (2, 256, 6, 2, 128, True, None, None, None, torch.float32),
    (1, 130, 2, 1, 256, True, 50, None, None, torch.float32),
    (2, 256, 6, 2, 128, True, None, None, None, torch.bfloat16),
])
def test_flash_kernel_matches_plain(cuda, B, Sq, H, Hkv, D, causal, window, softcap,
                                    Sk, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    Sk = Sk or Sq
    q = torch.randn((B, Sq, H, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, Sk, Hkv, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, Sk, Hkv, D), generator=gen, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=D ** -0.5)
    before = fa.launches
    out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want_out, want_lse = fa.flash_fwd_plain(q, k, v, **kw)
    tol = 3e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
