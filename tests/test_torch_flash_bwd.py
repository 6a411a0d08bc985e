"""The flash-attention backward of the PyTorch port.

On the CPU: the plain backward (``flash_bwd_plain``, the version a CPU tensor
takes) against ``jax.vjp`` through the JAX package's flash attention in
interpret mode, fp32 at 5e-5; a PyTorch model of the bf16 backward kernels'
arithmetic (``csrc/flash_attention_bwd.cu``: the tiles of ``bwd_plan``, P
and dS rounded to bf16 before the products that take them, grouped heads
summed in fp32 by run) against JAX's VJP on the same bf16 inputs at 3e-2;
the plan (independent of the batch, its scratch under a quarter of a
partial a q head at the main shape, the meta wrapper allocating exactly
it); the cost the kernel reports; the meta and CPU wrappers, which launch
nothing.  On an NVIDIA GPU (marker ``cuda``): each dtype's backward kernel
against the plain version fed the same (out, lse), its bits run to run,
lane to lane and whatever the batch beside a row (at each wgmma instance
too), graph capture, and training through it with the plain backward
refused.

JAX is imported inside the parity tests so that the card-only cases also run
where JAX is not installed:
``python -m pytest tests/test_torch_flash_bwd.py -m cuda``.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, walk
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from test_torch_kernels import FLASH_CASES, _jax, _qkv

torch.set_num_threads(2)

BWD_CASES = FLASH_CASES + [
    # rows 161.. see no key: causal, a window of 32 and 130 keys under 200 queries
    pytest.param(1, 200, 4, 2, 16, True, 32, None, 130, None, None, id="fully-masked-rows"),
]
# the bf16 kernels' instances: every width class, softcap with a window at 256
BF16_CASES = BWD_CASES + [
    pytest.param(1, 128, 2, 1, 128, True, None, 20.0, None, None, None, id="softcap-d128"),
    pytest.param(1, 200, 4, 4, 192, True, None, None, None, 128, 192 ** -0.5,
                 id="mla-d192-dv128"),
    pytest.param(1, 150, 4, 2, 256, True, 48, 50.0, None, None, None,
                 id="d256-window-softcap"),
    pytest.param(1, 96, 2, 2, 80, False, None, None, 130, None, None, id="hubert-d80"),
]


def _jax_fwd_vjp(q, k, v, dout, scale, kw, dtype):
    """JAX's forward (out, lse) and ``jax.vjp`` through ``flash_attention(
    interpret=True)`` at ``dout``, all as float32 numpy arrays."""
    jax, jnp = _jax()
    from repro.kernels.flash_attention import _flash_fwd_pallas, flash_attention

    jq, jk, jv, jd = (jnp.asarray(a).astype(dtype) for a in (q, k, v, dout))
    out, lse = _flash_fwd_pallas(jq, jk, jv, scale=scale, block_q=64, block_kv=64,
                                 interpret=True, **kw)
    _, vjp = jax.vjp(lambda a, b, c: flash_attention(a, b, c, scale=scale, block_q=64,
                                                     block_kv=64, interpret=True, **kw),
                     jq, jk, jv)
    grads = vjp(jd)
    as_np = lambda a: np.array(a.astype(jnp.float32))  # noqa: E731
    return as_np(out), as_np(lse), [as_np(g) for g in grads]


@pytest.mark.parametrize("B,Sq,H,Hkv,D,causal,window,softcap,Sk,Dv,scale", BWD_CASES)
def test_flash_bwd_plain_matches_jax_vjp(B, Sq, H, Hkv, D, causal, window, softcap, Sk, Dv,
                                         scale):
    """``flash_bwd_plain`` fed JAX's (out, lse) against ``jax.vjp`` through
    the Pallas flash attention (interpret mode) at the same cotangent, fp32,
    5e-5; v may be narrower than q and k, and rows may see no key."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, B, Sq, H, Hkv, D, Sk=Sk, Dv=Dv)
    dout = rng.standard_normal((B, Sq, H, Dv or D)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    scale = scale or D ** -0.5
    out, lse, want = _jax_fwd_vjp(q, k, v, dout, scale, kw, np.float32)
    got = fa.flash_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, out, lse, dout)),
                             scale=scale, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=5e-5, rtol=5e-5)


def _bf16_bwd_model(q, k, v, out, lse, dout, *, causal, window, softcap, scale):
    """The bf16 backward kernels' arithmetic in PyTorch: delta = rowsum(dO O)
    in fp32; fp32 S and dP from bf16 operands; the scale on the fp32 scores,
    the softcap's tanh and its derivative, P = exp2(S log2 e - lse log2 e)
    masked (0 on rows whose lse is NEG_INF); dS = P (dP - delta) (1 - tanh^2)
    scale (at the wgmma instances (P (1 - tanh^2) scale) (dP - delta), the
    factor taken before dP arrives).  dK and dV from P and dS rounded to
    bf16, summed in fp32 over a
    run of a kv head's q heads in head order, each head's q tiles of the
    plan's step in order (one q head a run at the mma.sync instances), and
    the runs' sums added in run order; dQ summed over kv tiles of the dQ block's step from dS
    rounded to bf16.  Returns (dq, dk, dv) in bf16."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    g = H // Hkv
    plan = fa.bwd_plan(H, Hkv, Sq, Sk, D, Dv, causal, window, torch.bfloat16)
    bq, bk, per = plan.q_step, plan.kv_step, g // plan.splits
    log2e = 1.0 / math.log(2.0)
    qf = q.float().reshape(B, Sq, Hkv, g, D)
    do = dout.float().reshape(B, Sq, Hkv, g, Dv)
    kf, vf = k.float(), v.float()
    delta = (dout.float() * out.float()).sum(-1).reshape(B, Sq, Hkv, g).permute(0, 2, 3, 1)
    lse = lse.reshape(B, Hkv, g, Sq)
    lse2 = torch.where(lse > fa.NEG_INF / 2, lse * log2e, math.inf)
    x = torch.einsum("bqngd,bknd->bngqk", qf, kf) * scale
    fac = torch.full_like(x, scale)
    if softcap:
        t = torch.tanh(x / softcap)
        x, fac = softcap * t, scale * (1.0 - t * t)
    q_pos, k_pos = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    p = torch.where(mask, torch.exp2(x * log2e - lse2[..., None]), 0.0)
    dp = torch.einsum("bqngd,bknd->bngqk", do, vf)
    if plan.kernels == "wgmma":   # P and its factor are formed before dP arrives
        ds = (p * fac) * (dp - delta[..., None])
    else:
        ds = p * (dp - delta[..., None]) * fac
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dk = dv = 0.0
    for r in range(plan.splits):   # each run's sum, then the runs in order
        pk = torch.zeros((B, Sk, Hkv, D))
        pv = torch.zeros((B, Sk, Hkv, Dv))
        for j in range(r * per, (r + 1) * per):
            for q0 in range(0, Sq, bq):
                sl = slice(q0, q0 + bq)
                pv = pv + torch.einsum("bnqk,bqnd->bknd", pb[:, :, j, sl], do[:, sl, :, j])
                pk = pk + torch.einsum("bnqk,bqnd->bknd", dsb[:, :, j, sl], qf[:, sl, :, j])
        dk, dv = dk + pk, dv + pv
    dq = torch.zeros((B, Sq, Hkv, g, D))
    for k0 in range(0, Sk, bk):
        sl = slice(k0, k0 + bk)
        dq = dq + torch.einsum("bngqk,bknd->bqngd", dsb[..., sl], kf[:, sl])
    return dq.reshape(B, Sq, H, D).bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("B,Sq,H,Hkv,D,causal,window,softcap,Sk,Dv,scale", BF16_CASES)
def test_bf16_bwd_rounding_model_matches_jax_vjp(B, Sq, H, Hkv, D, causal, window, softcap,
                                                 Sk, Dv, scale, record_property):
    """Rounding P and dS to bf16 before the products that take them (the
    bf16 kernels' change of arithmetic against JAX's backward, which
    multiplies them in fp32) stays inside the bf16 gate: the kernels' model
    fed JAX's (out, lse) against ``jax.vjp`` on the same bf16 inputs, 3e-2
    on dq, dk and dv.  The observed maxima are recorded as test properties."""
    import ml_dtypes

    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, B, Sq, H, Hkv, D, Sk=Sk, Dv=Dv)
    dout = rng.standard_normal((B, Sq, H, Dv or D)).astype(np.float32)
    q, k, v, dout = (a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in (q, k, v, dout))
    kw = dict(causal=causal, window=window, softcap=softcap)
    scale = scale or D ** -0.5
    out, lse, want = _jax_fwd_vjp(q, k, v, dout, scale, kw, ml_dtypes.bfloat16)
    ins = [torch.from_numpy(a).bfloat16() for a in (q, k, v, out, dout)]
    got = _bf16_bwd_model(*ins[:4], torch.from_numpy(lse), ins[4], scale=scale, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.from_numpy(w)
        record_property(f"max_abs_err_{name}", float((g.float() - w).abs().max()))
        torch.testing.assert_close(g.float(), w, atol=3e-2, rtol=3e-2)


def _smoke_bwd_cases():
    """``chip_smoke.py``'s ``FLASH_BWD_CASES`` (the script imports nothing
    at load time but the standard library)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FLASH_BWD_CASES


def test_bwd_plan_is_the_same_at_every_batch():
    """At each of ``chip_smoke.py``'s backward cases the plan (kernels,
    instance, tiles, the split of a kv head's q heads) the wrapper takes for
    its tensors is the same at B = 1, 2, 4 and 16; only the scratch's batch
    dimension follows B."""
    for case, dname, qs, kvs, dv, kw in _smoke_bwd_cases():
        causal, window = kw.get("causal", True), kw.get("window")
        plans = []
        for B in (1, 2, 4, 16):
            q = torch.empty((B,) + tuple(qs[1:]), device="meta", dtype=getattr(torch, dname))
            v = torch.empty((B,) + tuple(kvs[1:3]) + (dv or kvs[3],), device="meta")
            plan = fa._plan_of(q, v, causal, window)
            assert [s[0] for s in plan.scratch(B)] == [B] * len(plan.scratch(B)), case
            assert [s[1:] for s in plan.scratch(B)] == [s[1:] for s in plan.scratch(1)], case
            plans.append(plan)
        assert all(p == plans[0] for p in plans), case
        want = ("fp32" if dname == "float32" else "wgmma"
                if 64 < max(qs[3], dv or kvs[3]) and qs[3] <= 192 and (dv or kvs[3]) <= 128
                else "mma.sync")
        assert plans[0].kernels == want, case


def test_bwd_plan_scratch_at_the_main_shape():
    """At starcoder2's main shape, q (16, 1024, 24, 128) over 2 kv heads,
    the wgmma backward splits each kv head's 12 q heads into 2 runs of 6 (32
    dK/dV blocks a batch row), and its fp32 partials take 67,108,864 B, a
    sixth of the 402,653,184 B of a partial a q head (the layout the
    mma.sync instances keep)."""
    plan = fa.bwd_plan(24, 2, 1024, 1024, 128, 128, True, None, torch.bfloat16)
    assert (plan.kernels, plan.instance, plan.splits) == ("wgmma", (128, 128), 2)
    assert (plan.kv_rows, plan.q_step, plan.q_rows, plan.kv_step) == (128, 64, 128, 64)
    per_head = 16 * 1024 * 24 * (128 + 128) * 4
    assert per_head == 402_653_184
    parts = sum(4 * math.prod(s) for s in plan.scratch(16)[1:])
    assert parts == 67_108_864 and parts <= per_head / 4
    assert 2 * -(-1024 // plan.kv_rows) * plan.splits == fa.SPLIT_BLOCKS
    # a partial a q head at the mma.sync instances, none without grouped heads
    mma = fa.bwd_plan(24, 2, 1024, 1024, 64, 64, True, None, torch.bfloat16)
    assert mma.splits == 12 and mma.scratch(16)[1] == (16, 1024, 24, 64)
    mla = fa.bwd_plan(16, 16, 1024, 1024, 192, 128, True, None, torch.bfloat16)
    assert (mla.instance, mla.q_step, mla.scratch(4)) == ((192, 128), 32, [(4, 16, 1024)])


@pytest.mark.parametrize("shapes,dtype", [
    (((16, 1024, 24, 128), (16, 1024, 2, 128), (16, 1024, 2, 128)), torch.bfloat16),
    (((4, 1024, 32, 128), (4, 1024, 4, 128), (4, 1024, 4, 128)), torch.bfloat16),
    (((4, 1024, 16, 192), (4, 1024, 16, 192), (4, 1024, 16, 128)), torch.bfloat16),
    (((2, 300, 8, 256), (2, 300, 4, 256), (2, 300, 4, 256)), torch.bfloat16),
    (((4, 512, 24, 128), (4, 512, 2, 128), (4, 512, 2, 128)), torch.float32),
], ids=["main", "moe", "mla", "mma-d256", "fp32"])
def test_meta_backward_allocates_the_plans_scratch(shapes, dtype):
    """``flash_bwd_meta`` allocates dq, dk, dv and exactly the plan's
    scratch, as the card's launch does (the dry run's temporaries)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Empties(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.__name__.startswith("empty"):
                self.shapes.append((tuple(out.shape), out.dtype))
            return out

    q, k, v = (torch.empty(s, device="meta", dtype=dtype) for s in shapes)
    B, Sq, H, D = shapes[0]
    out, dout = (torch.empty((B, Sq, H, shapes[2][3]), device="meta", dtype=dtype)
                 for _ in range(2))
    lse = torch.empty((B, H, Sq), device="meta")
    with Empties() as seen:
        fa.flash_bwd_meta(q, k, v, out, lse, dout, causal=True, window=None, softcap=None,
                          scale=0.1)
    plan = fa.bwd_plan(H, shapes[1][2], Sq, shapes[1][1], D, shapes[2][3], True, None, dtype)
    want = [(tuple(t.shape), dtype) for t in (q, k, v)] + \
        [(s, torch.float32) for s in plan.scratch(B)]
    assert sorted(seen.shapes, key=str) == sorted(want, key=str)


def test_bwd_cost_is_the_five_products_over_the_visible_pairs():
    """``cost(backward=True)`` by hand: 2 (3 D + 2 Dv) operations a visible
    pair and head; q, k, v, out, dout read, lse read, dq, dk, dv written."""
    B, Sq, H, D, Sk, Hkv, Dv = 2, 10, 4, 48, 7, 2, 32
    shapes = ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv))
    bf = (torch.bfloat16,) * 3
    # causal, 10 queries over 7 keys: query i sees min(i, 6) + 1 keys
    pairs = sum(min(i, Sk - 1) + 1 for i in range(Sq))
    ops_, nbytes = fa.cost(shapes, bf, causal=True, backward=True)
    assert ops_ == 2 * B * H * pairs * (3 * D + 2 * Dv)
    q_b, k_b, v_b, o_b = B * Sq * H * D * 2, B * Sk * Hkv * D * 2, B * Sk * Hkv * Dv * 2, \
        B * Sq * H * Dv * 2
    assert nbytes == 2 * (q_b + k_b + v_b) + 2 * o_b + B * H * Sq * 4
    # a window of 3, not causal: query i sees keys i - 2 .. 6
    pairs_w = sum(max(0, Sk - max(0, i - 2)) for i in range(Sq))
    assert fa.cost(shapes, bf, causal=False, window=3, backward=True)[0] == \
        2 * B * H * pairs_w * (3 * D + 2 * Dv)
    # the forward's cost is unchanged: two products, q k v out lse once
    assert fa.cost(shapes, bf, causal=True) == (2 * B * H * pairs * (D + Dv),
                                                q_b + k_b + v_b + o_b + B * H * Sq * 4)


def test_meta_backward_records_the_kernel_and_launches_nothing():
    """On the meta device the autograd function's backward returns empty
    grads of the inputs' shapes, reports ``flash_attention_bwd`` with its
    cost to an active walk, runs no aten product and launches nothing."""
    fa.reset_launches()
    seen = []

    def sink(name, flops, nbytes):
        seen.append((name, flops, nbytes))

    shapes = ((2, 64, 4, 48), (2, 64, 2, 48), (2, 64, 2, 32))
    q, k, v = (torch.empty(s, device="meta", dtype=torch.bfloat16, requires_grad=True)
               for s in shapes)
    walk.push(sink)
    try:
        out = fa.flash_attention(q, k, v, causal=True, window=16)
        out.backward(torch.empty_like(out))
    finally:
        walk.pop(sink)
    assert [s[0] for s in seen] == ["flash_attention", "flash_attention_bwd"]
    assert seen[1][1:] == fa.cost(shapes, (torch.bfloat16,) * 3, True, 16, backward=True)
    for t, s in zip((q, k, v), shapes):
        assert t.grad.is_meta and tuple(t.grad.shape) == s and t.grad.dtype == torch.bfloat16
    assert (fa.launches_bwd_bf16, fa.launches_bwd_fp32, fa.launches) == (0, 0, 0)


def test_cpu_backward_is_the_plain_version_and_launches_nothing():
    """On CPU tensors the autograd function's backward is ``flash_bwd_plain``
    (bit for bit), in both dtypes, with no launch counted and no library
    built."""
    fa.reset_launches()
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(rng, 1, 40, 4, 2, 16))
        dout = torch.from_numpy(rng.standard_normal((1, 40, 4, 16)).astype(np.float32)).to(dtype)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = ops.attention(*leaves, window=24)
        out.backward(dout)
        o, lse = fa.flash_fwd_plain(q, k, v, causal=True, window=24, softcap=None,
                                    scale=16 ** -0.5)
        want = fa.flash_bwd_plain(q, k, v, o, lse, dout, causal=True, window=24, softcap=None,
                                  scale=16 ** -0.5)
        for t, w in zip(leaves, want):
            assert t.grad.dtype == dtype and torch.equal(t.grad, w)
    assert (fa.launches_bwd_bf16, fa.launches_bwd_fp32, fa.launches) == (0, 0, 0)


def test_bwd_rejects_mismatched_residuals():
    q = torch.ones(1, 8, 2, 16)
    out, lse = fa.flash_fwd_plain(q, q, q, causal=True, window=None, softcap=None, scale=0.25)
    kw = dict(causal=True, window=None, softcap=None, scale=0.25)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd(q, q, q, out, lse[:, :1], out, **kw)
    with pytest.raises(ValueError, match="dout"):
        fa.flash_bwd(q, q, q, out, lse, out.bfloat16(), **kw)


def test_bwd_source_names_what_it_replaces_and_its_bound():
    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "_flash_fwd_pallas" in text and "_blocked_bwd" in text and "Bound on this card" in text
    assert "atomic" not in text.replace("no atomics", "")


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, Sq, H, Hkv, D, Sk, Dv, dtype, causal, window, softcap, seed=0):
    """q, k, v, the forward kernel's (out, lse), dout on the card, and the
    keyword arguments."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    Sk, Dv = Sk or Sq, Dv or D
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Sk, Hkv, Dv), generator=gen, device=dev).to(dtype)
    dout = torch.randn((B, Sq, H, Dv), generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=D ** -0.5)
    out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    return (q, k, v, out, lse, dout), kw


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,H,Hkv,D,causal,window,softcap,Sk,dtype,Dv", [
    (2, 256, 6, 2, 128, True, None, None, None, torch.bfloat16, None),
    (2, 384, 24, 2, 128, True, None, None, None, torch.bfloat16, None),   # starcoder2's g
    (2, 64, 4, 2, 16, True, None, None, None, torch.bfloat16, None),
    (1, 200, 4, 2, 16, True, 64, 30.0, None, torch.bfloat16, None),
    (1, 192, 8, 1, 64, True, None, None, None, torch.bfloat16, None),
    (1, 130, 2, 1, 64, True, None, None, None, torch.bfloat16, 128),
    (1, 300, 8, 4, 256, True, 96, 50.0, None, torch.bfloat16, None),     # gemma2's
    (2, 300, 16, 16, 192, True, None, None, None, torch.bfloat16, 128),  # MLA
    (2, 300, 16, 16, 80, False, None, None, None, torch.bfloat16, None),  # hubert
    (1, 200, 4, 2, 128, False, None, None, 130, torch.bfloat16, None),
    (1, 130, 4, 2, 128, True, 48, None, 200, torch.bfloat16, None),
    (1, 200, 4, 2, 64, True, 32, None, 130, torch.bfloat16, None),       # dead rows
    (1, 130, 2, 1, 48, False, None, None, 77, torch.bfloat16, 240),
    (1, 150, 4, 2, 176, True, None, None, None, torch.bfloat16, 112),   # <192, 128> at 176
    (2, 1024, 32, 4, 128, True, None, None, None, torch.bfloat16, None),  # one run of 8 heads
    (1, 200, 4, 2, 128, True, 32, 30.0, 130, torch.bfloat16, None),     # wgmma, dead rows
    (1, 300, 8, 2, 192, True, 64, 30.0, 250, torch.bfloat16, 128),      # <192, 128>, masks
    (1, 130, 12, 1, 64, True, None, None, None, torch.bfloat16, 128),   # zero-filled D 64
    (2, 256, 6, 2, 128, True, None, None, None, torch.float32, None),
    (1, 200, 4, 2, 16, True, 64, 30.0, None, torch.float32, None),
    (1, 300, 4, 2, 256, True, 96, 50.0, 200, torch.float32, None),
    (2, 200, 8, 8, 192, True, None, None, None, torch.float32, 128),
    (2, 150, 8, 8, 80, False, None, None, None, torch.float32, None),
    (1, 200, 4, 2, 64, True, 32, None, 130, torch.float32, None),        # dead rows
    (1, 130, 2, 1, 48, False, None, None, 77, torch.float32, 240),
])
def test_flash_bwd_kernel_matches_plain(cuda, B, Sq, H, Hkv, D, causal, window, softcap, Sk,
                                        dtype, Dv):
    """Each dtype's backward kernel against ``flash_bwd_plain`` fed the same
    (out, lse): bf16 at 3e-2 (``launches_bwd_bf16``), fp32 at 5e-5
    (``launches_bwd_fp32``), one launch and no other."""
    ins, kw = _inputs(cuda, B, Sq, H, Hkv, D, Sk, Dv, dtype, causal, window, softcap)
    before = (fa.launches_bwd_bf16, fa.launches_bwd_fp32)
    got = fa.flash_bwd_cuda(*ins, **kw)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (fa.launches_bwd_bf16, fa.launches_bwd_fp32) == (before[0] + bf16,
                                                            before[1] + (not bf16))
    want = fa.flash_bwd_plain(*ins, **kw)
    tol = 3e-2 if bf16 else 5e-5
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_bits_runs_lanes_and_halves(cuda, dtype):
    """The backward's bits depend on a row's own data only: two runs give
    the same bits, four identical batch rows the same bits in each, and the
    two halves of a batch launched apart the whole launch's bits."""
    ins, kw = _inputs(cuda, 1, 300, 12, 1, 128, None, None, dtype, True, None, None)
    lanes = [t.expand(4, *t.shape[1:]).contiguous() for t in ins]
    first, again = fa.flash_bwd_cuda(*lanes, **kw), fa.flash_bwd_cuda(*lanes, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(g[i], g[0]) for g in first for i in range(1, 4))
    ins, kw = _inputs(cuda, 4, 300, 12, 1, 128, None, None, dtype, True, 64, None, seed=1)
    whole = fa.flash_bwd_cuda(*ins, **kw)
    parts = [fa.flash_bwd_cuda(*(t[a:b].contiguous() for t in ins), **kw)
             for a, b in ((0, 2), (2, 4))]
    torch.cuda.synchronize()
    for i, w in enumerate(whole):
        assert torch.equal(w, torch.cat([p[i] for p in parts]))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,H,Hkv,D,causal,window,Dv", [
    (4, 384, 24, 2, 128, True, None, None),    # <128, 128>, runs of 2 heads with partials
    (4, 1024, 32, 4, 128, True, None, None),   # <128, 128>, one run of 8 heads
    (4, 300, 16, 16, 192, True, 64, 128),      # <192, 128>, MLA's widths
    (4, 300, 16, 16, 80, False, None, None),   # <128, 128> zero-filled, hubert's
], ids=["d128-runs", "d128-one-run", "mla-d192-dv128", "hubert-d80"])
def test_flash_bwd_wgmma_instances_bits_and_graph(cuda, B, Sq, H, Hkv, D, causal, window, Dv):
    """Each wgmma instance (``bwd_plan``'s ``kernels == "wgmma"``) gives the
    same bits over two runs, in four identical batch rows, in a batch's
    halves launched apart, and replayed from a CUDA graph."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    assert fa._plan_of(torch.empty(B, Sq, H, D, **meta), torch.empty(B, Sq, Hkv, Dv or D, **meta),
                       causal, window).kernels == "wgmma"
    one, kw = _inputs(cuda, 1, Sq, H, Hkv, D, None, Dv, torch.bfloat16, causal, window, None)
    lanes = [t.expand(B, *t.shape[1:]).contiguous() for t in one]
    first, again = fa.flash_bwd_cuda(*lanes, **kw), fa.flash_bwd_cuda(*lanes, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(g[i], g[0]) for g in first for i in range(1, B))
    ins, kw = _inputs(cuda, B, Sq, H, Hkv, D, None, Dv, torch.bfloat16, causal, window, None,
                      seed=1)
    whole = fa.flash_bwd_cuda(*ins, **kw)
    parts = [fa.flash_bwd_cuda(*(t[a:b].contiguous() for t in ins), **kw)
             for a, b in ((0, B // 2), (B // 2, B))]
    torch.cuda.synchronize()
    for i, w in enumerate(whole):
        assert torch.equal(w, torch.cat([p[i] for p in parts]))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fa.flash_bwd_cuda(*ins, **kw)
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            captured = fa.flash_bwd_cuda(*ins, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(whole, captured))


@pytest.mark.cuda
def test_flash_bwd_graph_capture(cuda):
    """The backward captured in a CUDA graph (its buffers allocated by the
    wrapper, nothing read on the host) replays to the eager launch's bits."""
    ins, kw = _inputs(cuda, 2, 256, 8, 2, 128, None, None, torch.bfloat16, True, None, None)
    eager = fa.flash_bwd_cuda(*ins, **kw)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fa.flash_bwd_cuda(*ins, **kw)   # warm-up on the side stream
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            captured = fa.flash_bwd_cuda(*ins, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))


@pytest.mark.cuda
def test_flash_bwd_rejects_what_it_does_not_take(cuda):
    ins, kw = _inputs(cuda, 1, 64, 4, 2, 64, None, None, torch.bfloat16, True, None, None)
    q, k, v, out, lse, dout = ins
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_bwd_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, out, lse,
                          dout, **kw)
    with pytest.raises(ValueError, match="dout"):
        fa.flash_bwd_cuda(q, k, v, out, lse, dout.float(), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_training_backward_goes_through_the_kernel(cuda, dtype, monkeypatch):
    """``ops.attention``'s backward on CUDA tensors launches the dtype's
    backward kernel once a call, with the plain backward made to raise."""
    def refuse(*_, **__):
        raise AssertionError("the plain flash backward ran on the card")

    monkeypatch.setattr(fa, "flash_bwd_plain", refuse)
    monkeypatch.setattr(ref, "_blocked_bwd", refuse)
    ins, _ = _inputs(cuda, 2, 128, 4, 2, 64, None, None, dtype, True, None, None)
    leaves = [t.clone().requires_grad_(True) for t in ins[:3]]
    before = (fa.launches_bwd_bf16, fa.launches_bwd_fp32)
    for _ in range(2):
        ops.attention(*leaves, window=48).backward(ins[5])
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (fa.launches_bwd_bf16 - before[0], fa.launches_bwd_fp32 - before[1]) == (
        2 * bf16, 2 * (not bf16))
    assert all(torch.isfinite(t.grad.float()).all() for t in leaves)
