"""The port's paper CNN (``repro_torch.train.cnn``) and its dataset against
the JAX package's, on the CPU in fp32.

Weights come from the JAX init through ``repro_torch.interop`` (the two RNGs
differ).  The dataset bit for bit; ``cnn_forward`` within 3e-5;
``morph_params`` within 1e-6 from the same parent and fresh child weights;
``train_cnn``'s test accuracy within 1e-4 at dropout 0 (dropout draws from
different generators in the two packages).
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticClassification as JaxSyntheticClassification
from repro.train import cnn as jcnn
from repro_torch import interop
from repro_torch.data.pipeline import SyntheticClassification
from repro_torch.train import cnn

torch.set_num_threads(2)

ARCHS = {
    "paper": {"conv": [[16, 3], [32, 3]], "fc": 64},
    "eas-deepened": {"conv": [[8, 5], [12, 3], [6, 3]], "fc": 24},
}


@pytest.mark.parametrize("kw,n,seed", [({}, 96, 1), (dict(image_size=8, noise=2.0, seed=3), 40, 5)],
                         ids=["paper", "small"])
def test_dataset_bit_for_bit(kw, n, seed):
    want = JaxSyntheticClassification(**kw)
    got = SyntheticClassification(**kw)
    assert np.array_equal(got.templates, want.templates)
    a, b = got.make_split(n, seed), want.make_split(n, seed)
    for k in ("x", "y"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cnn_forward_matches_jax(name):
    arch = ARCHS[name]
    jp = jcnn.init_cnn(jax.random.PRNGKey(0), arch)
    x = SyntheticClassification().make_split(16, 4)["x"]
    want = np.asarray(jax.jit(jcnn.cnn_forward)(jp, x))
    got = cnn.cnn_forward(interop.to_torch(jax.device_get(jp)), torch.from_numpy(x))
    assert got.shape == want.shape == (16, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)


def test_morph_params_matches_jax(monkeypatch):
    """The child's fresh weights are JAX's (``init_cnn`` swapped for the JAX
    init of the child), so the warm start must agree everywhere."""
    parent, child = ARCHS["paper"], {"conv": [[24, 3], [16, 3], [8, 3]], "fc": 80}
    jparent = jcnn.init_cnn(jax.random.PRNGKey(0), parent)
    want = jcnn.morph_params(jax.random.PRNGKey(1), jparent, parent, child)
    fresh = jax.device_get(jcnn.init_cnn(jax.random.PRNGKey(1), child))
    monkeypatch.setattr(cnn, "init_cnn", lambda gen, arch, *a, **k: interop.to_torch(fresh))
    got = cnn.morph_params(torch.Generator().manual_seed(1),
                           interop.to_torch(jax.device_get(jparent)), parent, child)
    got, want = interop.tree_leaves(interop.to_numpy(got)), jax.tree.leaves(want)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=1e-6)


def test_train_cnn_score_matches_jax_at_dropout_0():
    """Three epochs of plain Adam from the JAX init weights: the same test
    accuracy within 1e-4."""
    config = dict(conv1=8, conv2=12, fc1=32, learning_rate=1e-2, dropout=0.0, n_iterations=3)
    kw = dict(n_train=256, n_test=128, batch=32, seed=0)
    arch = {"conv": [[8, 3], [12, 3]], "fc": 32}
    jp = jax.device_get(jcnn.init_cnn(jax.random.PRNGKey(0), arch))
    want = jcnn.train_cnn(config, **kw)
    got = cnn.train_cnn(config, device="cpu", init_params=interop.to_torch(jp), **kw)
    assert want > 0.2   # it learned something: chance is 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_train_cnn_runs_a_morphed_child_and_needs_a_device(monkeypatch):
    """An EAS child (``arch`` / ``arch_parent``) trains from the port's own
    init, with dropout, to an accuracy in [0, 1]; without a GPU and without
    ``device="cpu"`` the trainer raises."""
    config = {"arch": json.dumps(ARCHS["eas-deepened"]),
              "arch_parent": json.dumps(ARCHS["paper"]), "n_iterations": 1}
    score = cnn.train_cnn(config, n_train=64, n_test=32, batch=32, device="cpu")
    assert 0.0 <= score <= 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn.train_cnn({}, n_train=32, n_test=8, batch=32)
