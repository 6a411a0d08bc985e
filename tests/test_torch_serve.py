"""The port's serving path against the JAX package's.

Decode of each mixer (``gqa_decode`` global and sliding-window with the
softcap, ``mla_decode``'s absorbed form, ``mamba_decode``) against
``repro.models.*`` over 12 positions, outputs and caches at 3e-5; the whole
``decode_step`` against ``repro.models.transformer.decode_step`` on every
decoder smoke config, logits and every cache leaf at 1e-4 at each of 8
positions; inside the port, token-by-token decode against ``forward`` at
every position (1e-4) and ``forward(last_only=True)`` against the full
forward's last position (1e-5); ``greedy_generate`` and the serve loop
against JAX's tokens exactly; temperature sampling by its distribution; the
CLI.  Parameters come from JAX through ``repro_torch.interop``, inputs from a
numpy seed, fp32 on the CPU.  On an NVIDIA GPU (marker ``cuda``, without
JAX): decode on the card against the CPU, and the RMSNorm launches a step.
"""
import contextlib
import dataclasses
import io
import math
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX; there only the card-only cases run
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.launch import serve as jax_serve
    from repro.models import attention as JA
    from repro.models import mamba as JM
    from repro.models import transformer as JT
    from repro.train import serve_step as jax_serve_step
except ModuleNotFoundError:
    pass
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.train import serve_step

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DECODERS = [a for a in ARCH_IDS if a != "hubert-xlarge"]
NO_FRONTEND = [a for a in DECODERS if a != "pixtral-12b"]
B, STEPS = 2, 8


def _jax_params(arch, seed=0):
    cfg = jax_smoke_config(arch)
    return cfg, jax.device_get(JT.init_params(jax.random.PRNGKey(seed), cfg))


def _lane(tree):
    """A JAX tree (numpy leaves) as the port's population of one."""
    return interop.add_lane_axis(interop.to_torch(tree))


def _assert_tree_close(got, want, tol, what):
    """Port tree (lane axis in front) against a JAX tree, leaf by leaf."""
    got_leaves, want_leaves = interop.tree_leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves), what
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert tuple(g.shape[1:]) == w.shape, what
        np.testing.assert_allclose(g[0].numpy(), w, atol=tol, rtol=tol, err_msg=what)


# ------------------------------------------------------------- mixers at decode
MIXERS = [("starcoder2-3b", "attn"), ("gemma2-9b", "attn_local"), ("gemma2-9b", "attn"),
          ("deepseek-v2-lite-16b", "attn_mla"), ("falcon-mamba-7b", "mamba")]
MIXER_STEPS, MAX_SEQ = 12, 16   # past gemma2's smoke window of 8


def _mixer_params(params, cfg, mixer):
    """The first layer of ``mixer`` in the tree: (its mixer params, one
    superblock sliced off where it lies in ``blocks``)."""
    for i, (m, _) in enumerate(cfg.prefix_pattern):
        if m == mixer:
            return params["prefix"][i]["mixer"]
    i = next(i for i, (m, _) in enumerate(cfg.pattern) if m == mixer)
    return jax.tree.map(lambda a: a[0], params["blocks"][f"l{i}"]["mixer"])


@pytest.mark.parametrize("arch,mixer", MIXERS)
def test_mixer_decode_matches_jax(arch, mixer):
    """Each decode mixer, 12 positions from zeroed caches: y and the whole
    cache within 3e-5 of the JAX package's after every step."""
    cfg, params = _jax_params(arch)
    p = _mixer_params(params, cfg, mixer)
    tp = interop.add_lane_axis(interop.to_torch(p))
    tcfg = get_smoke_config(arch)
    rng = np.random.default_rng(3)
    if mixer == "mamba":
        jc = JM.mamba_cache_init(cfg, B, jnp.float32)
        tc = M.mamba_cache_init(tcfg, 1, B, torch.float32, "cpu")
    elif mixer == "attn_mla":
        jc = JA.mla_cache_init(cfg, B, MAX_SEQ, jnp.float32)
        tc = A.mla_cache_init(tcfg, 1, B, MAX_SEQ, torch.float32, "cpu")
    else:
        jc = JA.gqa_cache_init(cfg, B, MAX_SEQ, jnp.float32)
        tc = A.gqa_cache_init(tcfg, 1, B, MAX_SEQ, torch.float32, "cpu")
    for pos in range(MIXER_STEPS):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        tx = torch.from_numpy(x)[None]
        if mixer == "mamba":
            jy, jc = JM.mamba_decode(p, jnp.asarray(x), jc, cfg)
            ty, tc2 = M.mamba_decode(tp, tx, tc, tcfg)
        elif mixer == "attn_mla":
            jy, jc = JA.mla_decode(p, jnp.asarray(x), jc, pos, cfg)
            ty, tc2 = A.mla_decode(tp, tx, tc, pos, tcfg)
        else:
            local = mixer == "attn_local"
            jy, jc = JA.gqa_decode(p, jnp.asarray(x), jc, pos, cfg, local=local)
            ty, tc2 = A.gqa_decode(tp, tx, tc, pos, tcfg, local=local)
        assert tc2 is tc   # written in place, the same tree returned
        np.testing.assert_allclose(ty[0].numpy(), np.asarray(jy), atol=3e-5, rtol=3e-5,
                                   err_msg=f"{arch} {mixer} y at pos {pos}")
        _assert_tree_close(tc, jax.device_get(jc), 3e-5, f"{arch} {mixer} cache at {pos}")
    if mixer == "mamba":
        assert tc["h"].dtype == torch.float32


def test_bf16_mamba_decodes_in_the_cache_dtype_and_keeps_the_stream_dtype():
    """A bf16 Mamba model under the serving loop's fp32 cache: the mixer
    computes in fp32 as JAX's promoting ``mamba_decode`` does (its output
    within bf16's tolerance of JAX's, its state fp32), and ``decode_step``
    keeps the residual stream in bf16, which JAX's layer scan requires (the
    JAX package's ``decode_step`` raises on the widened carry)."""
    arch = "falcon-mamba-7b"
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = dataclasses.replace(jax_smoke_config(arch), **bf16)
    tcfg = dataclasses.replace(get_smoke_config(arch), **bf16)
    params = jax.device_get(JT.init_params(jax.random.PRNGKey(0), cfg))
    p = _mixer_params(params, cfg, "mamba")
    tp = interop.add_lane_axis(interop.to_torch(p))
    jc = JM.mamba_cache_init(cfg, B, jnp.float32)
    tc = M.mamba_cache_init(tcfg, 1, B, torch.float32, "cpu")
    rng = np.random.default_rng(19)
    for pos in range(4):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jy, jc = JM.mamba_decode(p, jnp.asarray(x, jnp.bfloat16), jc, cfg)
        ty, _ = M.mamba_decode(tp, torch.from_numpy(x).to(torch.bfloat16)[None], tc, tcfg)
        assert ty.dtype == torch.float32 and jy.dtype == jnp.float32
        np.testing.assert_allclose(ty[0].numpy(), np.asarray(jy), atol=3e-2, rtol=3e-2)
    assert tc["conv"].dtype == tc["h"].dtype == torch.float32

    seen = []
    tparams = _lane(params)
    cache = T.init_cache(tcfg, 1, B, 4, dtype=torch.float32, device="cpu")
    plain = T.apply_rmsnorm

    def recording(x, gamma, eps):
        seen.append(x.dtype)
        return plain(x, gamma, eps)

    T.apply_rmsnorm = recording
    try:
        logits, _ = T.decode_step(tparams, cache, torch.ones((1, B, 1), dtype=torch.int64), 0,
                                  tcfg)
    finally:
        T.apply_rmsnorm = plain
    assert seen == [torch.bfloat16] * (tcfg.n_layers + 1)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    with pytest.raises(TypeError, match="carry"):
        JT.decode_step(params, JT.init_cache(cfg, B, 4, dtype=jnp.float32),
                       jnp.ones((B, 1), jnp.int32), 0, cfg)


# ------------------------------------------------------------- the whole step
def _jax_decode(cfg):
    return jax.jit(lambda p, c, t, pos: JT.decode_step(p, c, t, pos, cfg))


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step_matches_jax(arch):
    """``decode_step`` from the same weights and tokens: logits and every
    leaf of the cache within 1e-4 of JAX's at each of 8 positions."""
    cfg, params = _jax_params(arch)
    tcfg = get_smoke_config(arch)
    tparams = _lane(params)
    step = _jax_decode(cfg)
    jc = JT.init_cache(cfg, B, STEPS, dtype=jnp.float32)
    tc = T.init_cache(tcfg, 1, B, STEPS, dtype=torch.float32, device="cpu")
    assert len(interop.tree_leaves(tc)) == len(jax.tree.leaves(jc))
    rng = np.random.default_rng(5)
    for pos in range(STEPS):
        tok = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jc = step(params, jc, jnp.asarray(tok), pos)
        tl, tc2 = T.decode_step(tparams, tc, torch.from_numpy(tok)[None], pos, tcfg)
        assert tc2 is tc and tl.dtype == torch.float32
        np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{arch} logits at pos {pos}")
        _assert_tree_close(tc, jax.device_get(jc), 1e-4, f"{arch} cache at pos {pos}")


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "falcon-mamba-7b"])
def test_bf16_params_under_fp32_compute_decode_like_jax(arch):
    """bf16 parameters under the fp32 compute dtype: ``decode_step``'s
    logits and cache within 1e-4 of JAX's at each of 8 positions (the MLA
    and Mamba decode products promote as JAX's einsums do)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), param_dtype="bfloat16")
    tcfg = dataclasses.replace(get_smoke_config(arch), param_dtype="bfloat16")
    params = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = _lane(params)
    assert any(t.dtype == torch.bfloat16 for t in interop.tree_leaves(tparams))
    step = _jax_decode(jcfg)
    jc = JT.init_cache(jcfg, B, STEPS, dtype=jnp.float32)
    tc = T.init_cache(tcfg, 1, B, STEPS, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    for pos in range(STEPS):
        tok = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jc = step(params, jc, jnp.asarray(tok), pos)
        tl, _ = T.decode_step(tparams, tc, torch.from_numpy(tok)[None], pos, tcfg)
        np.testing.assert_allclose(tl[0].float().numpy(), np.asarray(jl, np.float32),
                                   atol=1e-4, rtol=1e-4, err_msg=f"{arch} logits at pos {pos}")
        _assert_tree_close(tc, jax.device_get(jc), 1e-4, f"{arch} cache at pos {pos}")


def _port_config(arch):
    """The smoke config; MoE layers at a capacity no token overflows, so the
    full forward routes as dropless decode does (as tests/test_models.py)."""
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, capacity_factor=100.0) if cfg.has_moe else cfg


@pytest.mark.parametrize("arch", NO_FRONTEND)
def test_decode_matches_forward_at_every_position(arch):
    """Inside the port: the prompt decoded a token a step gives the full
    forward's logits at every position within 1e-4."""
    cfg = _port_config(arch)
    params = _lane(_jax_params(arch)[1])
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(1, B, STEPS)))
    with torch.no_grad():
        want, _ = T.forward(params, tokens, cfg)
    cache = T.init_cache(cfg, 1, B, STEPS, dtype=torch.float32, device="cpu")
    for pos in range(STEPS):
        got, _ = T.decode_step(params, cache, tokens[:, :, pos:pos + 1], pos, cfg)
        np.testing.assert_allclose(got[:, :, 0].numpy(), want[:, :, pos].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=f"{arch} pos {pos}")


@pytest.mark.parametrize("arch", NO_FRONTEND)
def test_forward_last_only_is_the_last_position(arch):
    cfg = _port_config(arch)
    params = _lane(_jax_params(arch)[1])
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(1, B, STEPS)))
    with torch.no_grad():
        full, aux = T.forward(params, tokens, cfg)
        last, aux_last = T.forward(params, tokens, cfg, last_only=True)
    assert last.shape == (1, B, 1, cfg.vocab_size)
    np.testing.assert_allclose(last[:, :, 0].numpy(), full[:, :, -1].numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(aux_last.numpy(), aux.numpy())


# ------------------------------------------------------------- generation
GREEDY = ["starcoder2-3b", "gemma2-9b", "deepseek-v2-lite-16b", "falcon-mamba-7b",
          "jamba-1.5-large-398b"]
MARGIN = 1e-4


@pytest.mark.parametrize("arch", GREEDY)
def test_greedy_generate_gives_jax_tokens(arch):
    """``greedy_generate`` gives JAX's tokens.  Each step is also checked
    teacher-forced on JAX's tokens: the port's argmax equals JAX's unless
    JAX's top-2 margin there is under 1e-4 (then the test says so and goes
    on from JAX's token)."""
    cfg, params = _jax_params(arch)
    tcfg = get_smoke_config(arch)
    tparams = _lane(params)
    P, n_new, max_seq = 4, 6, 12
    prompt = np.random.default_rng(11).integers(1, cfg.vocab_size, size=(B, P)).astype(np.int32)
    want = np.array(jax_serve_step.greedy_generate(params, cfg, jnp.asarray(prompt), n_new,
                                                     max_seq))
    step = _jax_decode(cfg)
    jc = JT.init_cache(cfg, B, max_seq, dtype=jnp.float32)
    tc = T.init_cache(tcfg, 1, B, max_seq, dtype=torch.float32, device="cpu")
    close_calls = []
    for i in range(P + n_new - 1):
        tok = want[:, i:i + 1]
        jl, jc = step(params, jc, jnp.asarray(tok), i)
        tl, _ = T.decode_step(tparams, tc, torch.from_numpy(tok)[None], i, tcfg)
        if i + 1 < P:
            continue
        jl = np.asarray(jl)[:, -1]
        top2 = np.sort(jl, axis=-1)[:, -2:]
        np.testing.assert_array_equal(jl.argmax(-1), want[:, i + 1])
        for b in range(B):
            if top2[b, 1] - top2[b, 0] < MARGIN:
                close_calls.append((i, b))
                continue
            assert int(tl[0, b, -1].argmax()) == want[b, i + 1], (arch, i, b)
    if close_calls:
        print(f"{arch}: JAX's top-2 margin under {MARGIN} at (step, row) {close_calls}; "
              "those steps checked teacher-forced only")
    else:
        got = serve_step.greedy_generate(tparams, tcfg, torch.from_numpy(prompt)[None], n_new,
                                         max_seq)
        np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma2-9b"])
def test_serve_loop_prints_jax_request_lines(arch):
    """The loop fed JAX's parameters prints the reference CLI's request
    lines at temperature 0.  More requests than slots, so refilled slots
    enter at a shared position above 0 and read the rows their slot's last
    request left (the reference's behaviour, kept)."""
    flags = dict(batch=2, requests=6, prompt_len=10, new_tokens=8, max_seq=24)
    argv = ["--arch", arch] + [a for k, v in flags.items()
                               for a in (f"--{k.replace('_', '-')}", str(v))]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_serve.main(argv) == 0
    want = [line for line in buf.getvalue().splitlines() if line.startswith("req ")]
    params = _lane(_jax_params(arch)[1])
    outputs, steps, seconds, step_seconds = serve.serve_requests(
        get_smoke_config(arch), params, **flags, device="cpu")
    got = serve.report(outputs, steps, seconds, flags["batch"])
    assert len(step_seconds) == steps
    assert len(want) == flags["requests"]
    assert got[:-1] == want
    assert got[-1].startswith(f"{flags['requests']} requests, {steps} decode steps")


def test_temperature_sampling_follows_the_softmax(monkeypatch):
    """20,000 draws at temperature 0.8 from fixed logits over 16 tokens, one
    generator: each token's frequency within 5 binomial standard errors of
    softmax(logits / 0.8)."""
    V, n, temp = 16, 20000, 0.8
    logits = torch.from_numpy(np.random.default_rng(13).standard_normal(V).astype(np.float32))
    monkeypatch.setattr(T, "decode_step", lambda p, c, t, pos, cfg: (
        logits.expand(1, n, 1, V).clone(), c))
    step = serve_step.make_serve_step(get_smoke_config("starcoder2-3b"), temperature=temp)
    gen = torch.Generator().manual_seed(0)
    nxt, _ = step(None, None, None, 0, gen)
    assert nxt.shape == (1, n, 1) and nxt.dtype == torch.int32
    freq = np.bincount(nxt.reshape(-1).numpy(), minlength=V) / n
    p = torch.softmax(logits / temp, dim=-1).numpy()
    se = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 5 * se), (freq, p)
    again, _ = step(None, None, None, 0, torch.Generator().manual_seed(0))
    assert torch.equal(again, nxt)   # the same generator seed, the same draws
    greedy = serve_step.make_serve_step(get_smoke_config("starcoder2-3b"))
    assert int(greedy(None, None, None, 0, gen)[0][0, 0, 0]) == int(logits.argmax())


# ------------------------------------------------------------- the CLI
def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    return rc, buf.getvalue().splitlines()


def test_cli_serves_on_the_cpu():
    rc, lines = _cli(["--device", "cpu", "--arch", "starcoder2-3b", "--requests", "3",
                      "--batch", "2", "--new-tokens", "4", "--max-seq", "16"])
    assert rc == 0
    assert [line.split(":")[0] for line in lines[:-1]] == ["req 0", "req 1", "req 2"]
    assert lines[-1].startswith("3 requests, ")


def test_cli_encoder_only_arch_prints_and_exits_0():
    rc, lines = _cli(["--device", "cpu", "--arch", "hubert-xlarge"])
    assert rc == 0 and lines == ["hubert-xlarge is encoder-only: no decode serving path"]


def test_cli_raises_without_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "starcoder2-3b", "--requests", "1"])


def test_the_port_import_check_walks_the_serving_modules():
    """``tests/test_torch_hpo.py``'s import check walks every module under
    ``src/repro_torch``, the two serving modules among them."""
    from test_torch_hpo import _imports

    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    for rel in ("launch/serve.py", "train/serve_step.py"):
        path = ROOT / "src" / "repro_torch" / rel
        assert path in files
        mods = list(_imports(path))
        assert mods and not [m for m in mods if m.split(".")[0] in ("jax", "repro")]


# -------------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: decode through the card's kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma2-9b", "qwen3-moe-30b-a3b",
                                  "deepseek-v2-lite-16b", "falcon-mamba-7b",
                                  "jamba-1.5-large-398b"])
def test_decode_on_the_card_matches_the_cpu(cuda, arch):
    cfg = get_smoke_config(arch)
    cpu = interop.add_lane_axis(T.init_params(torch.Generator().manual_seed(0), cfg, "cpu"))
    card = interop.tree_map(lambda t: t.to(cuda), cpu)
    cc = T.init_cache(cfg, 1, B, STEPS, dtype=torch.float32, device="cpu")
    gc_ = T.init_cache(cfg, 1, B, STEPS, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(17)
    for pos in range(STEPS):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, B, 1)))
        want, _ = T.decode_step(cpu, cc, tok, pos, cfg)
        got, _ = T.decode_step(card, gc_, tok.to(cuda), pos, cfg)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for g, w in zip(interop.tree_leaves(gc_), interop.tree_leaves(cc)):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2-3b", "falcon-mamba-7b", "deepseek-v2-lite-16b"])
def test_decode_step_launches_one_rmsnorm_forward_per_norm(cuda, arch):
    """A decode step launches the RMSNorm forward kernel once a norm (two a
    layer with an FFN, one without, one more at each MLA ``kv_norm``, and the
    final norm) and no other kernel of ours."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss

    cfg = get_smoke_config(arch)
    params = interop.add_lane_axis(T.init_params(torch.Generator(device=cuda).manual_seed(0),
                                                 cfg, cuda))
    cache = T.init_cache(cfg, 1, B, STEPS, dtype=torch.float32, device=cuda)
    layers = list(cfg.prefix_pattern) + list(cfg.pattern) * cfg.n_superblocks
    want = 1 + sum((1 + (f != "none")) * (1 + bool(cfg.post_norm)) + (m == "attn_mla")
                   for m, f in layers)
    for mod in (fa, rn, ss):
        mod.reset_launches()
    tok = torch.ones((1, B, 1), dtype=torch.int64, device=cuda)
    for pos in range(3):
        T.decode_step(params, cache, tok, pos, cfg)
    torch.cuda.synchronize()
    assert (rn.launches, rn.launches_bwd, fa.launches, ss.launches) == (3 * want, 0, 0, 0)
    assert math.isfinite(float(T.decode_step(params, cache, tok, 3, cfg)[0].abs().max()))
