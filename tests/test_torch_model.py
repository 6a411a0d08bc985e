"""The port's lane-batched model against ``repro.models.transformer``.

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


@pytest.mark.parametrize("arch", ARCHS)
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
    wq = got["blocks"]["l0"]["mixer"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6


@pytest.mark.parametrize("arch", ARCHS)
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
    logits, _ = T.forward(tparams, tb["tokens"], cfg)
    loss, metrics = cross_entropy(logits, tb["targets"], tb["mask"])
    assert logits.shape == (K, B, S, cfg.vocab_size)
    for i in range(K):
        jlogits, _ = JT.forward(jparams[i], jnp.asarray(batches[i]["tokens"]), jcfg)
        jloss, _ = jax_cross_entropy(jlogits, jnp.asarray(batches[i]["targets"]),
                                     jnp.asarray(batches[i]["mask"]))
        np.testing.assert_allclose(logits[i].detach().numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(loss[i]), float(jloss), atol=1e-4, rtol=1e-4)
    assert metrics["accuracy"].shape == (K,)


def test_unported_mixer_raises_naming_the_roadmap_item():
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
