"""The paper's §IV demonstration model: 2 conv + 2 fc, Adam, global dropout,
on the PyTorch port.

Hyperparameters exactly as the paper's experiment: ``conv1``, ``conv2``
(filter counts), ``fc1`` (hidden width), ``learning_rate``, ``dropout``, and
``n_iterations`` (epochs — the Hyperband/BOHB budget axis).  Trains on the
synthetic classification task and returns test accuracy.

Also the EAS §V client model: ``arch`` json {"conv": [[f,k],...], "fc": n}
overrides the fixed two-conv structure, and ``morph_params`` gives children
a warm start from the parent (overlapping channels copied, the rest fresh).

The parameter tree and layouts are the JAX package's (``repro.train.cnn``):
images NHWC, conv weights HWIO, fc weights (in, out).  The convolutions and
the pooling run through ``torch.nn.functional`` (the JAX package computes
them with ``lax.conv_general_dilated`` and ``lax.reduce_window``, outside
any Pallas kernel), in fp32 with TF32 off on the card.  Initial weights come
from an explicit ``torch.Generator``; dropout draws from one too, so it
cannot match JAX's threefry draws (parity holds at dropout 0).

Every entry point runs on ``cuda`` unless ``device="cpu"`` is given; without
a GPU it raises rather than fall back.
"""
from __future__ import annotations

import contextlib
import json
import math
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.pipeline import SyntheticClassification
from ..interop import tree_leaves, tree_map, tree_unflatten


def _trunc_normal(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen) * scale


def init_cnn(gen: torch.Generator, arch: Dict[str, Any], n_classes: int = 10,
             image_size: int = 16, device="cpu") -> Dict[str, Any]:
    """Parameters of ``arch`` from ``gen`` (on ``device``): truncated-normal
    weights scaled by 1/sqrt(fan-in), zero biases."""
    params: Dict[str, Any] = {"conv": []}
    cin = 1
    size = image_size
    for f, k in arch["conv"]:
        params["conv"].append({
            "w": _trunc_normal(gen, (k, k, cin, f), 1.0 / math.sqrt(k * k * cin), device),
            "b": torch.zeros(f, device=device)})
        cin = f
        size //= 2  # each conv block pools 2x
    flat = size * size * cin
    params["fc1"] = {"w": _trunc_normal(gen, (flat, arch["fc"]), 1.0 / math.sqrt(flat), device),
                     "b": torch.zeros(arch["fc"], device=device)}
    params["out"] = {"w": _trunc_normal(gen, (arch["fc"], n_classes),
                                        1.0 / math.sqrt(arch["fc"]), device),
                     "b": torch.zeros(n_classes, device=device)}
    return params


# cuDNN's TF32 switch is process-wide: the calls inside _exact_fp32, on any
# thread (an Experiment runs jobs on several), hold it off together, and the
# last one out puts back what it was
_TF32_LOCK = threading.Lock()
_tf32_off = {"users": 0, "was": None}


@contextlib.contextmanager
def _exact_fp32():
    """cuDNN without TF32 (PyTorch leaves it on for convolutions by default)."""
    with _TF32_LOCK:
        if _tf32_off["users"] == 0:
            _tf32_off["was"] = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        _tf32_off["users"] += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _tf32_off["users"] -= 1
            if _tf32_off["users"] == 0:
                torch.backends.cudnn.allow_tf32 = _tf32_off["was"]


def cnn_forward(params, x: torch.Tensor, dropout: float = 0.0,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """x (N, H, W, 1) -> logits (N, n_classes): per conv block a SAME
    convolution, ReLU and a 2x2 max pool; then the fc layer with ReLU,
    dropout when ``dropout > 0`` and ``gen`` is given, and the output."""
    with _exact_fp32():
        x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
        for layer in params["conv"]:
            w = layer["w"].permute(3, 2, 0, 1)           # HWIO -> OIHW
            x = F.relu(F.conv2d(x, w, layer["b"], padding="same"))
            x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)    # flattened as NHWC
    x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    if dropout > 0 and gen is not None:
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 1 - dropout
        x = x * keep / (1 - dropout)
    return x @ params["out"]["w"] + params["out"]["b"]


def morph_params(gen: torch.Generator, parent_params, parent_arch, child_arch,
                 n_classes: int = 10, image_size: int = 16, device="cpu"):
    """Net2net-ish warm start: copy overlapping channels, init the rest fresh."""
    child = init_cnn(gen, child_arch, n_classes, image_size, device)

    def copy_overlap(dst, src):
        sl = tuple(slice(0, min(a, b)) for a, b in zip(dst.shape, src.shape))
        dst[sl] = src[sl]
        return dst

    for i in range(min(len(child["conv"]), len(parent_params["conv"]))):
        for name in ("w", "b"):
            copy_overlap(child["conv"][i][name], parent_params["conv"][i][name])
    for layer in ("fc1", "out"):
        for name in ("w", "b"):
            copy_overlap(child[layer][name], parent_params[layer][name])
    return child


def _loss(params, x, y, dropout, gen):
    logits = cnn_forward(params, x, dropout, gen)
    return (torch.logsumexp(logits, -1) - logits.gather(1, y[:, None])[:, 0]).mean()


def train_cnn(config: Dict[str, Any], *, n_train: int = 2048, n_test: int = 512,
              batch: int = 128, image_size: int = 16, seed: int = 0,
              device=None, init_params=None) -> float:
    """Paper §IV job: config -> test accuracy.  ``init_params`` (a parameter
    tree) replaces the initial weights, as a parity test needs."""
    from ..launch.hpo import resolve_device

    dev = resolve_device(device)
    arch = (
        json.loads(config["arch"])
        if "arch" in config and config["arch"]
        else {
            "conv": [[int(config.get("conv1", 16)), 3], [int(config.get("conv2", 32)), 3]],
            "fc": int(config.get("fc1", 64)),
        }
    )
    lr = float(config.get("learning_rate", 1e-3))
    dropout = float(config.get("dropout", 0.1))
    epochs = max(1, int(config.get("n_iterations", 3)))

    data = SyntheticClassification(image_size=image_size)
    train, test = data.make_split(n_train, seed + 1), data.make_split(n_test, seed + 2)
    train = {k: torch.from_numpy(v).to(dev) for k, v in train.items()}
    test = {k: torch.from_numpy(v).to(dev) for k, v in test.items()}
    seeded = lambda: torch.Generator(device=dev).manual_seed(seed)  # noqa: E731
    if init_params is not None:
        params = tree_map(lambda t: t.detach().to(dev, torch.float32, copy=True), init_params)
    else:
        params = init_cnn(seeded(), arch, data.n_classes, image_size, dev)
        if config.get("arch_parent"):
            # the parent's and the child's fresh weights from the same seed,
            # as the JAX package draws both from one key
            parent_arch = json.loads(config["arch_parent"])
            params = morph_params(seeded(), init_cnn(seeded(), parent_arch, data.n_classes,
                                                     image_size, dev),
                                  parent_arch, arch, data.n_classes, image_size, dev)
    dropout_gen = torch.Generator(device=dev).manual_seed(seed + 1)

    # plain Adam, as in the paper
    leaves = tree_leaves(params)
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    b1, b2 = torch.tensor(0.9, device=dev), torch.tensor(0.999, device=dev)
    n_batches = n_train // batch
    t = 0
    for ep in range(epochs):
        perm = np.random.default_rng(seed + ep).permutation(n_train)
        for i in range(n_batches):
            idx = torch.from_numpy(perm[i * batch:(i + 1) * batch]).to(dev)
            t += 1
            leaves = [p.detach().requires_grad_(True) for p in leaves]
            with _exact_fp32():   # the backward's convolutions too
                loss = _loss(tree_unflatten(params, leaves), train["x"][idx],
                             train["y"][idx], dropout, dropout_gen)
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                c1, c2 = 1 - b1 ** t, 1 - b2 ** t
                for p, m, v, g in zip(leaves, mu, nu, grads):
                    m.mul_(0.9).add_(0.1 * g)
                    v.mul_(0.999).add_(0.001 * g * g)
                    p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8))
    params = tree_unflatten(params, [p.detach() for p in leaves])
    with torch.no_grad():
        logits = cnn_forward(params, test["x"])
        return float((logits.argmax(-1) == test["y"]).float().mean())
