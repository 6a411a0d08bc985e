"""The selective-scan kernel module of the PyTorch port.

On the CPU: the port's plain scan (the version a CPU tensor takes) against
the JAX package's reference scan and its Pallas kernel in interpret mode (also
at falcon-mamba's initial A and dt, where decays near 1 carry far), and
the autograd function's chunked backward against ``jax.grad``, on the same
numpy inputs, fp32.  On an NVIDIA GPU (marker ``cuda``): the CUDA kernel
against its plain version on the card, and the chunked backward fed the
kernel's chunk states against autograd through the plain version.

JAX is imported inside the parity tests so that the card-only cases also run
where JAX is not installed:
``python -m pytest tests/test_torch_ssm_scan.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import ssm_scan as ss

torch.set_num_threads(2)


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    return jax, jnp


def _inputs(rng, R, L, Dm, N, K=1, h0=False, init=False):
    """numpy inputs of one scan: rows (R, ...) and per-lane A (K, Dm, N),
    D (K, Dm); dt is a softplus, A negative, as in the mixer.  ``init``: A
    and dt as falcon-mamba starts training, A_n = -(n + 1) and dt
    log-uniform in [1e-3, 1e-1], so decays up to 0.999 carry over the whole
    sequence."""
    x = (0.5 * rng.standard_normal((R, L, Dm))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((R, L, Dm)) - 1.0)).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal((K, Dm, N)))).astype(np.float32)
    Bc = (0.5 * rng.standard_normal((R, L, N))).astype(np.float32)
    Cc = (0.5 * rng.standard_normal((R, L, N))).astype(np.float32)
    D = (0.2 * rng.standard_normal((K, Dm))).astype(np.float32)
    hh = (0.5 * rng.standard_normal((R, Dm, N))).astype(np.float32) if h0 else None
    if init:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (R, L, Dm))).astype(np.float32)
        A = np.broadcast_to(-np.arange(1, N + 1, dtype=np.float32), (K, Dm, N)).copy()
    return x, dt, A, Bc, Cc, D, hh


def _t(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------------ CPU parity
@pytest.mark.parametrize("B,L,D,N,chunk,block_d,h0", [
    (2, 64, 32, 8, 16, 16, False),      # the JAX package's kernel geometries
    (1, 100, 64, 16, 32, 64, False),
    (3, 48, 128, 4, 48, 32, False),
    (2, 40, 64, 8, 16, 32, True),       # an initial state
])
def test_ssm_plain_matches_jax_ref_and_pallas(B, L, D, N, chunk, block_d, h0):
    """The plain scan (one lane) against ``ref.ssm_scan`` and
    ``ssm_scan_pallas(interpret=True)``: y and h_last within 1e-4."""
    jax, jnp = _jax()
    from repro.kernels import ref as jref
    from repro.kernels.ssm_scan import ssm_scan_pallas

    x, dt, A, Bc, Cc, Dk, hh = _inputs(np.random.default_rng(0), B, L, D, N, h0=h0)
    jargs = [jnp.asarray(a) for a in (x, dt, A[0], Bc, Cc, Dk[0])]
    jh0 = None if hh is None else jnp.asarray(hh)
    wants = [jref.ssm_scan(*jargs, h0=jh0, chunk=chunk),
             ssm_scan_pallas(*jargs, h0=jh0, chunk=chunk, block_d=block_d, interpret=True)]
    y, h = ss.ssm_scan_fwd(*_t((x, dt, A, Bc, Cc, Dk, hh)), chunk=chunk)
    assert y.shape == (B, L, D) and h.shape == (B, D, N) and h.dtype == torch.float32
    for y_want, h_want in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=1e-4, rtol=1e-4)


def test_ssm_plain_matches_jax_in_the_long_horizon_regime():
    """falcon-mamba's initial A and dt (decays up to 0.999 carried over 512
    steps, chunk states at 128): the plain scan against ``ref.ssm_scan`` and
    ``ssm_scan_pallas(interpret=True)``, y, h_last and the chunk states
    within 1e-4.  The card holds its kernel against this plain version in
    the same regime."""
    jax, jnp = _jax()
    from repro.kernels import ref as jref
    from repro.kernels.ssm_scan import ssm_scan_pallas

    B, L, Dm, N, chunk = 2, 512, 64, 16, 128
    x, dt, A, Bc, Cc, Dk, _ = _inputs(np.random.default_rng(7), B, L, Dm, N, init=True)
    assert np.exp(dt.min() * A[0].max()) > 0.998 and np.exp(dt.max() * A[0].min()) < 0.21
    jargs = [jnp.asarray(a) for a in (x, dt, A[0], Bc, Cc, Dk[0])]
    y, h, hs = ss.ssm_scan_fwd(*_t((x, dt, A, Bc, Cc, Dk)), chunk=chunk, chunk_states=True)
    wants = [jref.ssm_scan(*jargs, chunk=chunk),
             ssm_scan_pallas(*jargs, chunk=chunk, block_d=Dm, interpret=True)]
    for y_want, h_want in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=1e-4, rtol=1e-4)
    # the state entering chunk c is h_last of the JAX scan over the first c chunks
    for c in range(1, hs.shape[1]):
        _, h_c = jref.ssm_scan(*(a[:, :c * chunk] if a.ndim == 3 and a.shape[1] == L else a
                                 for a in jargs), chunk=chunk)
        np.testing.assert_allclose(hs[:, c].numpy(), np.asarray(h_c), atol=1e-4, rtol=1e-4)
    assert not hs[:, 0].any()


def test_ssm_per_lane_A_and_D_equal_separate_calls():
    """K=2 lanes (2 rows each) with different A and D give, bit for bit, what
    two K=1 calls on each lane's rows give; the ops seam flattens (K, B)."""
    x, dt, A, Bc, Cc, Dk, hh = _t(_inputs(np.random.default_rng(1), 4, 37, 24, 8, K=2,
                                          h0=True))
    assert not torch.equal(A[0], A[1])
    y, h = ss.ssm_scan_fwd(x, dt, A, Bc, Cc, Dk, hh, chunk=16)
    for k in range(2):
        rows = slice(2 * k, 2 * k + 2)
        yk, hk = ss.ssm_scan_fwd(x[rows], dt[rows], A[k:k + 1], Bc[rows], Cc[rows],
                                 Dk[k:k + 1], hh[rows], chunk=16)
        assert torch.equal(y[rows], yk) and torch.equal(h[rows], hk)
    lane = lambda t: t.reshape((2, 2) + tuple(t.shape[1:]))  # noqa: E731
    y2, h2 = ops.ssm_scan(lane(x), lane(dt), A, lane(Bc), lane(Cc), Dk, lane(hh), chunk=16)
    assert torch.equal(y2.reshape(y.shape), y) and torch.equal(h2.reshape(h.shape), h)


@pytest.mark.parametrize("L,chunk", [(40, 16), (32, 32)], ids=["ragged-chunks", "one-chunk"])
def test_ssm_chunked_backward_matches_jax_grad(L, chunk):
    """``SSMScan`` on CPU tensors (plain forward, chunked backward) against
    ``jax.grad`` through the JAX package's fused scan (Pallas forward in
    interpret mode, reference VJP), lane by lane: gradients of x, dt, A, B,
    C, D, through y and h_last, within 5e-4."""
    jax, jnp = _jax()
    from repro.kernels import ops as jops

    rng = np.random.default_rng(2)
    K, b, Dm, N = 2, 1, 32, 4
    x, dt, A, Bc, Cc, Dk, _ = _inputs(rng, K * b, L, Dm, N, K=K)
    wy = rng.standard_normal((K * b, L, Dm)).astype(np.float32)
    wh = rng.standard_normal((K * b, Dm, N)).astype(np.float32)
    leaves = [t.requires_grad_(True) for t in _t((x, dt, A, Bc, Cc, Dk))]
    y, h = ss.ssm_scan(*leaves, chunk=chunk)
    ((y * torch.from_numpy(wy)).sum() + (h * torch.from_numpy(wh)).sum()).backward()

    for k in range(K):
        rows = slice(k * b, (k + 1) * b)

        def jloss(x, dt, A, Bc, Cc, D):
            y, h = jops.ssm_scan(x, dt, A, Bc, Cc, D, chunk=chunk, fused=True)
            return (y * wy[rows]).sum() + (h * wh[rows]).sum()

        want = jax.grad(jloss, argnums=tuple(range(6)))(
            *(jnp.asarray(a) for a in (x[rows], dt[rows], A[k], Bc[rows], Cc[rows], Dk[k])))
        got = [leaves[0].grad[rows], leaves[1].grad[rows], leaves[2].grad[k],
               leaves[3].grad[rows], leaves[4].grad[rows], leaves[5].grad[k]]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, rtol=5e-4)


def test_ssm_chunked_backward_with_h0_matches_jax_grad():
    """With an initial state the gradient also flows to h0; against
    ``jax.grad`` through the JAX reference scan, within 5e-4."""
    jax, jnp = _jax()
    from repro.kernels import ref as jref

    rng = np.random.default_rng(3)
    x, dt, A, Bc, Cc, Dk, hh = _inputs(rng, 2, 30, 16, 8, h0=True)
    wy = rng.standard_normal(x.shape).astype(np.float32)
    leaves = [t.requires_grad_(True) for t in _t((x, dt, A, Bc, Cc, Dk, hh))]
    y, h = ss.ssm_scan(*leaves, chunk=8)
    ((y * torch.from_numpy(wy)).sum() + h.square().sum()).backward()

    def jloss(x, dt, A, Bc, Cc, D, h0):
        y, h = jref.ssm_scan(x, dt, A, Bc, Cc, D, h0=h0, chunk=8)
        return (y * wy).sum() + jnp.square(h).sum()

    want = jax.grad(jloss, argnums=tuple(range(7)))(
        *(jnp.asarray(a) for a in (x, dt, A[0], Bc, Cc, Dk[0], hh)))
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy().reshape(np.shape(w)), np.asarray(w),
                                   atol=5e-4, rtol=5e-4)


def test_ssm_scan_equals_stepwise_decode():
    """Inside the port: the chunked scan equals the token-by-token decode
    recurrence (``ops.ssm_decode_step``), two lanes, within 1e-4."""
    K, b, L, Dm, N = 2, 2, 17, 8, 4
    x, dt, A, Bc, Cc, Dk, hh = _t(_inputs(np.random.default_rng(4), K * b, L, Dm, N, K=K,
                                          h0=True))
    lane = lambda t: t.reshape((K, b) + tuple(t.shape[1:]))  # noqa: E731
    x, dt, Bc, Cc, hh = (lane(t) for t in (x, dt, Bc, Cc, hh))
    y_scan, h_scan = ops.ssm_scan(x, dt, A, Bc, Cc, Dk, hh, chunk=5)
    h, ys = hh, []
    for t in range(L):
        y, h = ops.ssm_decode_step(x[:, :, t], dt[:, :, t], A, Bc[:, :, t], Cc[:, :, t], Dk, h)
        ys.append(y)
    torch.testing.assert_close(y_scan, torch.stack(ys, dim=2), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h_scan, h, atol=1e-4, rtol=1e-4)


def test_ssm_cpu_wrapper_launches_nothing():
    """On CPU tensors the scan takes the plain version: no launch counted."""
    ss.reset_launches()
    x, dt, A, Bc, Cc, Dk, _ = _t(_inputs(np.random.default_rng(5), 2, 8, 16, 4, K=2))
    lane = lambda t: t[:, None]  # noqa: E731
    ops.ssm_scan(lane(x), lane(dt), A, lane(Bc), lane(Cc), Dk)
    ss.ssm_scan(x, dt, A, Bc, Cc, Dk)
    assert ss.launches == 0


@pytest.mark.parametrize("change,err,match", [
    (dict(N=65), ValueError, "state size 65"),
    (dict(Bc=torch.bfloat16), TypeError, "all be fp32 or all bf16"),
    (dict(A=torch.bfloat16), TypeError, "must be fp32"),
    (dict(K=3), ValueError, "do not agree"),
], ids=["N>64", "mixed-dtypes", "A-not-fp32", "rows-not-lanes"])
def test_ssm_rejects_unsupported_input(change, err, match):
    N, K = change.get("N", 4), change.get("K", 2)
    x, dt, A, Bc, Cc, Dk, _ = _t(_inputs(np.random.default_rng(6), 4, 8, 16, N, K=K))
    if "Bc" in change:
        Bc = Bc.to(change["Bc"])
    if "A" in change:
        A = A.to(change["A"])
    with pytest.raises(err, match=match):
        ss.ssm_scan_fwd(x, dt, A, Bc, Cc, Dk)


def test_ssm_kernel_source_names_the_tpu_kernel_it_replaces():
    text = (build.CSRC / "ssm_scan.cu").read_text()
    assert "ssm_scan_pallas" in text and "_ssm_kernel" in text and "Bound on this card" in text
    assert "__expf" not in text and "ssm_scan_fwd" in build.SIGNATURES


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(dev, R, L, Dm, N, K, h0=False, seed=0):
    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in _inputs(np.random.default_rng(seed), R, L, Dm, N, K=K, h0=h0)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,L,Dm,N,K,h0,dtype", [
    (2, 64, 32, 8, 1, False, torch.float32),
    (2, 100, 200, 4, 2, True, torch.float32),        # ragged L and Dm, per-lane A
    (4, 300, 128, 16, 2, False, torch.float32),
    (2, 65, 64, 64, 1, True, torch.float32),         # N at its limit
    (4, 256, 256, 16, 2, False, torch.bfloat16),
])
def test_ssm_kernel_matches_plain(cuda, R, L, Dm, N, K, h0, dtype):
    x, dt, A, Bc, Cc, Dk, hh = _card_inputs(cuda, R, L, Dm, N, K, h0)
    x, dt, Bc, Cc = (t.to(dtype) for t in (x, dt, Bc, Cc))
    before = ss.launches
    y, h, hs = ss.ssm_scan_cuda(x, dt, A, Bc, Cc, Dk, hh, chunk=32, chunk_states=True)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    y_want, h_want, hs_want = ss.ssm_scan_plain(x, dt, A, Bc, Cc, Dk, hh, chunk=32,
                                                chunk_states=True)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(y.float(), y_want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, h_want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hs, hs_want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("R,L,Dm,N,K,h0,dtype,chunk,init", [
    (8, 1024, 8192, 16, 4, False, torch.bfloat16, 128, False),
    (4, 1024, 256, 16, 2, False, torch.float32, 128, True),
    (2, 200, 128, 64, 1, True, torch.float32, 64, False),
    (4, 300, 192, 12, 2, False, torch.float32, 128, False),
    (4, 300, 192, 12, 2, True, torch.bfloat16, 128, False),
    (4, 77, 100, 16, 2, False, torch.bfloat16, 32, False),
    (2, 1000, 256, 16, 1, False, torch.bfloat16, 50, False),
    (2, 1000, 256, 16, 2, False, torch.float32, 128, False),
    (6, 130, 320, 16, 2, True, torch.float32, 64, False),
    (65538, 3, 8, 4, 2, False, torch.float32, 2, False),
], ids=["main-bf16-chunk-states", "long-horizon-init-fp32", "N64", "N12-fp32", "N12-bf16-h0",
        "Dm100-unaligned-bf16", "L1000-chunk50", "L1000-chunk128", "3-rows-a-lane",
        "rows-past-65535"])
def test_ssm_kernel_edges_match_plain(cuda, R, L, Dm, N, K, h0, dtype, chunk, init):
    """The kernel's splits of N (padded where N = 12), its ragged channel
    tiles and unaligned bf16 rows (Dm = 100), L and chunk that are not
    multiples of its step tile, 3 rows a lane, more rows than one grid
    dimension holds, and falcon-mamba's initial A and dt over 1,024 steps: y
    at the dtype's tolerance, h_last and the chunk states at 1e-4, against
    the plain version."""
    rng = np.random.default_rng(8)
    x, dt, A, Bc, Cc, Dk, hh = [None if a is None else torch.from_numpy(a).to(cuda)
                                for a in _inputs(rng, R, L, Dm, N, K=K, h0=h0, init=init)]
    x, dt, Bc, Cc = (t.to(dtype) for t in (x, dt, Bc, Cc))
    before = ss.launches
    got = ss.ssm_scan_cuda(x, dt, A, Bc, Cc, Dk, hh, chunk=chunk, chunk_states=True)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    want = ss.ssm_scan_plain(x, dt, A, Bc, Cc, Dk, hh, chunk=chunk, chunk_states=True)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_ssm_kernel_keeps_eight_warps_a_scheduler_at_N16(cuda):
    """falcon-mamba's N = 16 in bf16 runs 8 resident warps a scheduler: the
    instance fits 64 registers a thread, and eight blocks' shared memory
    fits an SM."""
    occ = ss.kernel_occupancy(16, torch.bfloat16)
    assert occ["warps_per_scheduler"] >= 8, occ


@pytest.mark.cuda
def test_ssm_chunked_backward_on_card_matches_plain_autograd(cuda):
    x, dt, A, Bc, Cc, Dk, hh = _card_inputs(cuda, 4, 90, 64, 8, 2, True)
    w = torch.randn(x.shape, device=cuda)
    a = [t.clone().requires_grad_(True) for t in (x, dt, A, Bc, Cc, Dk, hh)]
    b = [t.clone().requires_grad_(True) for t in (x, dt, A, Bc, Cc, Dk, hh)]
    y, h = ss.ssm_scan(*a, chunk=32)
    ((y * w).sum() + h.square().sum()).backward()
    y, h = ss.ssm_scan_plain(*b, chunk=32)
    ((y * w).sum() + h.square().sum()).backward()
    for g, want in zip(a, b):
        torch.testing.assert_close(g.grad, want.grad, atol=5e-4, rtol=5e-4)
