"""The RMSNorm backward of the PyTorch port.

On the CPU: the closed-form plain backward (the version a CPU tensor takes)
against ``jax.vjp`` of the JAX package's reference norm with per-lane gains,
on the same numpy inputs, fp32; the autograd function's gradients against
torch autograd through the plain forward in every mix of fp32 and bf16; an
expanded, zero-stride dy.  On an NVIDIA GPU (marker ``cuda``): the backward
kernel against the plain version, its dgamma bits from run to run and from
lane to lane, graph capture, and a forward and backward on the card that
run no plain op.

JAX is imported inside the parity tests so that the card-only cases also run
where JAX is not installed:
``python -m pytest tests/test_torch_rmsnorm_bwd.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn

torch.set_num_threads(2)
EPS = 1e-6


def _inputs(rng, shape):
    K, _, d = shape
    x = rng.standard_normal(shape).astype(np.float32)
    g = (0.1 * rng.standard_normal((K, d))).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, g, dy


# ------------------------------------------------------------------ CPU parity
@pytest.mark.parametrize("shape", [(2, 24, 64), (3, 17, 100), (2, 16, 512), (1, 5, 384)])
def test_rmsnorm_bwd_plain_matches_jax_vjp(shape):
    """dx and dgamma of the closed form against ``jax.vjp`` of
    ``repro.kernels.ref.rmsnorm`` with a gain row per lane, at 5e-6."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    x, g, dy = _inputs(np.random.default_rng(3), shape)
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm(a, b[:, None, :], EPS),
                     jnp.asarray(x), jnp.asarray(g))
    want = vjp(jnp.asarray(dy))
    got = rn.rmsnorm_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(dy), EPS)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-6, rtol=5e-6)


@pytest.mark.parametrize("xdt,gdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_rmsnorm_autograd_matches_autograd_through_plain(xdt, gdt):
    """The autograd function's gradients, in x's and gamma's dtypes, against
    torch autograd through ``rmsnorm_plain``: 5e-6 in fp32, 3e-2 where bf16
    takes part."""
    x, g, dy = _inputs(np.random.default_rng(4), (2, 12, 96))
    x, g, dy = torch.from_numpy(x).to(xdt), torch.from_numpy(g).to(gdt), torch.from_numpy(dy)
    grads = []
    for fn in (lambda a, b: rn.rmsnorm(a, b, EPS), lambda a, b: rn.rmsnorm_plain(a, b, EPS)):
        a, b = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
        y = fn(a, b)
        y.backward(dy.to(y.dtype))
        grads.append((a.grad, b.grad))
    tol = 5e-6 if xdt == gdt == torch.float32 else 3e-2
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_rmsnorm_backward_takes_an_expanded_dy():
    """``y.sum().backward()`` hands the backward a zero-stride dy; the
    gradients equal those of a materialised ones cotangent."""
    x, g, _ = _inputs(np.random.default_rng(5), (2, 7, 64))
    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    ops.rmsnorm(xt, gt, EPS).sum().backward()
    dx, dg = rn.rmsnorm_bwd_plain(xt.detach(), gt.detach(), torch.ones_like(xt), EPS)
    torch.testing.assert_close(xt.grad, dx, atol=0, rtol=0)
    torch.testing.assert_close(gt.grad, dg, atol=0, rtol=0)


def test_rmsnorm_bwd_cuda_refuses_what_it_does_not_take():
    x, g, dy = torch.ones(1, 4, 32), torch.zeros(1, 32), torch.ones(1, 4, 32)
    with pytest.raises(ValueError, match="CUDA device"):
        rn.rmsnorm_bwd_cuda(x, g, dy, EPS)
    with pytest.raises(ValueError, match="gamma"):
        rn.rmsnorm_bwd_cuda(x, torch.zeros(2, 32), dy, EPS)
    with pytest.raises(TypeError):
        rn.rmsnorm_bwd_cuda(x.half(), g, dy.half(), EPS)


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _card_inputs(dev, shape, xdt, gdt, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    K, _, d = shape
    x = torch.randn(shape, generator=gen, device=dev).to(xdt)
    g = (0.1 * torch.randn((K, d), generator=gen, device=dev)).to(gdt)
    dy = torch.randn(shape, generator=gen, device=dev).to(xdt)
    return x, g, dy


@pytest.mark.cuda
@pytest.mark.parametrize("shape,xdt,gdt", [
    ((2, 33, 64), torch.float32, torch.float32),
    ((3, 17, 100), torch.float32, torch.float32),
    ((3, 17, 100), torch.bfloat16, torch.bfloat16),     # d not a vector multiple
    ((2, 40, 3072), torch.bfloat16, torch.bfloat16),
    ((1, 9, 384), torch.bfloat16, torch.float32),
    ((1, 9, 384), torch.float32, torch.bfloat16),
    ((2, 2048, 512), torch.bfloat16, torch.bfloat16),   # MLA's kv_norm
    # jamba's d 8192, and d 6144 with an fp32 gain: one row group a block
    # (few rows), then two, whose gain and fold take 48 KB of shared memory
    # or more
    ((2, 64, 8192), torch.bfloat16, torch.bfloat16),
    ((1, 64, 6144), torch.bfloat16, torch.float32),
    ((2, 2048, 8192), torch.bfloat16, torch.bfloat16),
    ((1, 4096, 6144), torch.bfloat16, torch.float32),
])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, shape, xdt, gdt):
    """dx and dgamma against the closed form on the same inputs, one launch a
    call: 5e-5 in fp32, 3e-2 where bf16 takes part."""
    x, g, dy = _card_inputs(cuda, shape, xdt, gdt)
    before = rn.launches_bwd
    got = rn.rmsnorm_bwd_cuda(x, g, dy, EPS)
    torch.cuda.synchronize()
    assert rn.launches_bwd == before + 1
    want = rn.rmsnorm_bwd_plain(x, g, dy, EPS)
    tol = 5e-5 if xdt == gdt == torch.float32 else 3e-2
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_bits_repeat_and_agree_across_lanes(cuda, xdt):
    """Two lanes fed the same x, dy and gain get the same dx and dgamma bits,
    and a second call gives the first call's bits."""
    x, g, dy = _card_inputs(cuda, (1, 1000, 3072), xdt, xdt)
    x, g, dy = (t.expand(2, *t.shape[1:]).contiguous() for t in (x, g, dy))
    first = rn.rmsnorm_bwd_cuda(x, g, dy, EPS)
    again = rn.rmsnorm_bwd_cuda(x, g, dy, EPS)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
        assert torch.equal(a[0], a[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4, 8])
def test_rmsnorm_bwd_bits_of_a_mesh_rank_match_the_whole_launch(cuda, k):
    """K lanes in one launch get the bits each lane gets alone and in every
    split of them when each split is planned for K lanes, as a population
    mesh's rank plans its K/N of K lanes (``mesh_ranks``)."""
    x, g, dy = _card_inputs(cuda, (k, 4096, 3072), torch.bfloat16, torch.bfloat16)
    whole = rn.rmsnorm_bwd_cuda(x, g, dy, EPS)
    for lo, hi in ((0, 1), (0, k // 2), (k // 2, k)):
        rn.plan_for_mesh(k // (hi - lo))
        try:
            part = rn.rmsnorm_bwd_cuda(x[lo:hi].contiguous(), g[lo:hi].contiguous(),
                                       dy[lo:hi].contiguous(), EPS)
        finally:
            rn.plan_for_mesh(1)
        torch.cuda.synchronize()
        for w, p in zip(whole, part):
            assert torch.equal(w[lo:hi], p)


@pytest.mark.cuda
def test_rmsnorm_forward_and_backward_replay_in_a_cuda_graph(cuda):
    """Forward and backward captured in a CUDA graph and replayed give the
    eager call's bits (the scratch comes from the graph's pool)."""
    x, g, dy = _card_inputs(cuda, (2, 256, 2048), torch.bfloat16, torch.bfloat16)

    def step():
        y = rn.rmsnorm_cuda(x, g, EPS)
        return (y,) + rn.rmsnorm_bwd_cuda(x, g, dy, EPS)

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, captured):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_rmsnorm_on_the_card_runs_no_plain_op(cuda, monkeypatch):
    """On CUDA tensors the autograd function calls only the kernels: with the
    plain versions patched to raise, a forward and backward still run, one
    launch each."""
    def refuse(*a, **k):
        raise AssertionError("a plain RMSNorm ran on the card")

    for name in ("rmsnorm_plain", "rmsnorm_bwd_plain"):
        monkeypatch.setattr(rn, name, refuse)
    monkeypatch.setattr(ref, "rmsnorm", refuse)
    x, g, dy = _card_inputs(cuda, (2, 64, 1024), torch.bfloat16, torch.bfloat16)
    x.requires_grad_(True)
    g.requires_grad_(True)
    before = (rn.launches, rn.launches_bwd)
    ops.rmsnorm(x, g, EPS).backward(dy)
    torch.cuda.synchronize()
    assert (rn.launches, rn.launches_bwd) == (before[0] + 1, before[1] + 1)
    assert x.grad.dtype == torch.bfloat16 and g.grad.dtype == torch.bfloat16
