"""The port's lane-batched model against ``repro.models.transformer``.

Dense architectures, the MoE ones (qwen3-moe, and jamba with its Mamba,
attention, dense and MoE layers; the MoE layers' aux loss is held too),
deepseek-v2-lite (MLA) and the backbones of hubert-xlarge and pixtral-12b;
and every configuration of the registry builds and runs.

The parameters are built by JAX and copied into the port through
``repro_torch.interop`` (the two RNGs differ); the batch is the numpy host
synthesis, which both packages share.  fp32 on the CPU, 1e-4 on logits and
loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import transformer as JT
from repro.train.loss import cross_entropy as jax_cross_entropy
from repro.train.population import init_population_state
from repro.configs.base import TrainConfig
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import transformer as T
from repro_torch.train.loss import cross_entropy

torch.set_num_threads(2)

ARCHS = ["starcoder2-3b", "phi3-mini-3.8b", "gemma2-9b", "granite-34b"]
# MoE FFNs: qwen3-moe (attention and MoE), jamba (Mamba, attention, dense, MoE)
MOE_ARCHS = ["qwen3-moe-30b-a3b", "jamba-1.5-large-398b"]
# MLA with a dense prefix and MoE superblocks; the backbones behind the two
# frontend stubs (hubert encoder-only), on tokens as the CLIs train them
LAST_ARCHS = ["deepseek-v2-lite-16b", "hubert-xlarge", "pixtral-12b"]


def test_interop_round_trip_population_state():
    """A JAX population state (fp32 and a bf16 copy of its params) survives
    numpy -> port tensors -> numpy bit for bit, with the lane axis in front
    of the stacked ``n_superblocks`` axis."""
    tc = TrainConfig(model=jax_smoke_config("starcoder2-3b"))
    pstate = jax.device_get(init_population_state(jax.random.PRNGKey(0), tc, 3))
    tstate = interop.to_torch(pstate)
    wq = tstate["inner"]["params"]["blocks"]["l0"]["mixer"]["wq"]
    assert wq.shape == (3, tc.model.n_superblocks, 64, 4, 16)
    assert tstate["diverged"].dtype == torch.bool
    assert tstate["inner"]["opt"]["step"].dtype == torch.int32
    back = interop.to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(pstate), interop.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    bf = jax.device_get(jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                     pstate["inner"]["params"]))
    tbf = interop.to_torch(bf)
    assert interop.tree_leaves(tbf)[0].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(bf), interop.tree_leaves(interop.to_numpy(tbf))):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS + LAST_ARCHS)
def test_init_params_tree_matches_jax_layout(arch):
    """The port's own init builds the JAX package's tree: same keys, shapes
    and dtypes; gains start at zero (stored as gamma - 1)."""
    cfg = get_smoke_config(arch)
    want = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jax_smoke_config(arch)))
    got = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    got_leaves, want_leaves = interop.tree_leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    assert jax.tree.structure(want) == jax.tree.structure(
        interop.tree_map(lambda t: 0, got))
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert float(got["final_norm"].abs().max()) == 0.0
    attn = next(lp for _, lp in sorted(got["blocks"].items()) if "wq" in lp["mixer"])
    wq = attn["mixer"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS + LAST_ARCHS)
def test_forward_and_loss_match_jax(arch):
    """Two lanes with different weights: each lane's logits and loss equal the
    JAX forward of that lane's weights on that lane's batch, at 1e-4."""
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    K, B, S = 2, 2, 16
    jparams = [JT.init_params(jax.random.PRNGKey(i), jcfg) for i in range(K)]
    data = SyntheticLM(cfg.vocab_size, S, B, seed=0)
    jdata = JaxSyntheticLM(cfg.vocab_size, S, B, seed=0)
    batches = [data.make_batch(0, stream=i) for i in range(K)]
    for i in range(K):  # the shared host synthesis is bit-identical
        np.testing.assert_array_equal(batches[i]["tokens"],
                                      jdata.make_batch(0, stream=i)["tokens"])

    tparams = interop.tree_map(lambda *xs: torch.stack(xs),
                               *[interop.to_torch(jax.device_get(p)) for p in jparams])
    tb = {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}
    logits, aux = T.forward(tparams, tb["tokens"], cfg)
    loss, metrics = cross_entropy(logits, tb["targets"], tb["mask"])
    assert logits.shape == (K, B, S, cfg.vocab_size)
    assert aux.shape == (K,)
    for i in range(K):
        jlogits, jaux = JT.forward(jparams[i], jnp.asarray(batches[i]["tokens"]), jcfg)
        np.testing.assert_allclose(float(aux[i]), float(jaux), atol=1e-4, rtol=1e-4)
        jloss, _ = jax_cross_entropy(jlogits, jnp.asarray(batches[i]["targets"]),
                                     jnp.asarray(batches[i]["mask"]))
        np.testing.assert_allclose(logits[i].detach().numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(loss[i]), float(jloss), atol=1e-4, rtol=1e-4)
    assert metrics["accuracy"].shape == (K,)


def test_every_config_builds_and_runs():
    """The port builds every configuration the JAX package has, every mixer
    and FFN kind among them: each smoke config's own init runs one finite
    forward on K=2 lanes."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs.base import FFNS, MIXERS

    assert ARCH_IDS == JAX_ARCH_IDS
    kinds = set()
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        kinds |= {k for layer in cfg.prefix_pattern + cfg.pattern for k in layer}
        one = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        params = interop.tree_map(lambda t: torch.stack([t, 0.5 * t]), one)
        tokens = torch.randint(0, cfg.vocab_size, (2, 1, 8), generator=torch.Generator())
        logits, aux = T.forward(params, tokens, cfg)
        assert logits.shape == (2, 1, 8, cfg.vocab_size), arch
        assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux).all()), arch
    assert kinds == set(MIXERS) | set(FFNS)
