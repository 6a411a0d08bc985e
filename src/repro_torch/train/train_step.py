"""The HPO train step over lane-batched state.

``make_hparam_train_step(tc)`` returns ``step(state, batch, hp, active=None)
-> (state, metrics)``: the state's leaves, the batch's leaves and the
HParams fields all carry a leading lane axis K, and one call trains K trials
as one program.  The serial engine is the K=1 case.

State layout (JAX package's, plus the lane axis):
``{"params": ..., "opt": {"mu", "nu", "step"}}``.  The step updates the
state's tensors in place and returns the same dict.

Numerics follow ``repro.train.train_step.make_hparam_train_step``: every
gradient is rounded to ``parallel.grad_allreduce_dtype`` (bfloat16) before
the global norm and AdamW, also in fp32 models; with
``parallel.microbatch`` the batch is split and the rounded per-microbatch
gradients are summed in fp32 and averaged.  With MoE layers the loss adds
``aux_loss_weight`` times each lane's load-balancing loss, which the metrics
report as ``aux_loss``.  A batch with ``embeds`` (K, B, S, d) feeds them
to the model in place of ``tokens``, as the JAX step does.  The forward
pass recomputes its activations as ``parallel.remat`` says (``"none" |
"full" | "dots"``); the values do not change.

**One trial.**  ``make_train_step(tc)`` is the JAX package's ``(state,
batch) -> (state, metrics)`` over one trial's state with no lane axis,
``{"params", "opt": {"mu", "nu", "step"[, "master"]}}`` with ``step`` a 0-d
int32, its hyperparameters from ``tc``; ``get_compiled_train_step(tc)`` is
the ``(state, batch, hp)`` form, one object for every trial of one static
config; ``make_eval_step(tc)`` gives a batch's metrics.  They run the
lane-batched step on a population of one: the lane axis is a view, so the
update lands in the caller's tensors.

**One trial over a trial mesh.**  ``make_sharded_train_step(tc, mesh)`` is
the step of ``launch/train.py --devices N``: the same math on a ``(data,
model)`` grid of ranks, each storing its block of every leaf as the JAX
package's ``build_sharding`` places it (``TrialLayout``: init leaf by leaf,
checkpoints gathered and cut in the one-device format).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import TrainConfig
from ..interop import add_lane_axis, tree_leaves, tree_map, tree_unflatten
from ..models import transformer as T
from ..distributed.sharding import (UsePlan, axis_size, build_sharding, gather_tree,
                                    make_rules, map_specs, shard_tree, sharded_dims,
                                    sharding_context, tp_module_flags, tp_shard_context,
                                    tp_width_rules)
from ..models.layers import dtype_of, lane_sum
from ..optim.adamw import adamw_update, init_opt_state
from ..optim.hparams import HParams, hparams_from_config, stack_hparams
from ..optim.schedule import warmup_cosine
from .loss import cross_entropy


def init_params(gen: torch.Generator, tc: TrainConfig, device) -> Dict[str, Any]:
    """One trial's parameters (no lane axis), initialised from ``gen``."""
    return T.init_params(gen, tc.model, device)


def init_train_state(gen: torch.Generator, tc: TrainConfig, device) -> Dict[str, Any]:
    """One trial's train state (no lane axis), initialised from ``gen``: its
    parameters and a zero optimizer state."""
    params = init_params(gen, tc, device)
    return {"params": params, "opt": init_opt_state(params, tc)}


def train_state_specs(tc: TrainConfig) -> Dict[str, Any]:
    """The train state's logical axis names (per trial): the optimizer's
    moments and master copy take the parameters' (the JAX package's)."""
    p = T.param_specs(tc.model)
    opt: Dict[str, Any] = {"mu": p, "nu": p, "step": ()}
    if tc.parallel.master_dtype is not None:
        opt["master"] = p
    return {"params": p, "opt": opt}


def static_step_key(tc: TrainConfig) -> Tuple:
    """The program-cache key: everything a trial may NOT vary per proposal."""
    return (tc.model, tc.parallel, tc.b1, tc.eps, tc.z_loss)


def _loss_fn(params, batch, tc: TrainConfig, denom=None, n_data: int = 1):
    """The loss and its metrics.  A trial mesh's data rank passes ``denom``,
    the whole batch's mask sum, and ``n_data``, the data ranks that split
    the rows: its loss is then its rows' share, and the ranks' shares sum
    to the whole batch's loss (the MoE load-balancing loss averaged over
    the ranks, as JAX's ``pmean``)."""
    cfg = tc.model
    logits, aux = T.forward(params, batch.get("tokens"), cfg,
                            inputs_embeds=batch.get("embeds"), remat=tc.parallel.remat)
    loss, metrics = cross_entropy(logits, batch["targets"], batch["mask"], z_loss=tc.z_loss,
                                  denom=denom)
    if cfg.has_moe:
        if n_data > 1:
            aux = aux / n_data
        loss = loss + cfg.aux_loss_weight * aux
        metrics["aux_loss"] = aux
    metrics["loss"] = loss
    return loss, metrics


def _value_and_grad(params, batch, tc: TrainConfig, **shares):
    """Per-lane metrics and per-lane gradients.  The lanes share no
    parameters, so the gradient of the summed lane losses is each lane's own
    gradient.  A leaf the loss does not read (the embedding table of a batch
    of ``embeds``) gets a zero gradient, as under ``jax.grad``.  ``shares``
    go to ``_loss_fn``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = _loss_fn(tree_unflatten(params, leaves), batch, tc, **shares)
    grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, tree_unflatten(params, list(grads))


def make_hparam_train_step(tc: TrainConfig, value_and_grad: Optional[Callable] = None,
                           reduce_metrics: Optional[Callable] = None) -> Callable:
    """``(state, batch, hp, active=None) -> (state, metrics)`` over K lanes.

    With ``active`` (bool[K]) the update lands only on lanes that are active
    and whose loss is finite; the other lanes keep their state bit for bit.
    Without it every lane is updated.

    ``value_and_grad(params, microbatch) -> (metrics, grads)`` replaces the
    per-microbatch ``_value_and_grad`` and ``reduce_metrics(metrics)`` is
    applied to the accumulated metrics; a trial mesh's step passes both."""
    mb = tc.parallel.microbatch
    acc_dt = dtype_of(tc.parallel.grad_allreduce_dtype)
    if value_and_grad is None:
        def value_and_grad(params, part):
            return _value_and_grad(params, part, tc)

    def train_step(state, batch, hp: HParams, active: Optional[torch.Tensor] = None):
        params = state["params"]
        if mb and mb > 0:
            gb = next(iter(batch.values())).shape[1]
            if gb % mb:
                raise ValueError(f"batch {gb} is not a multiple of microbatch {mb}")
            n_mb = gb // mb
            grads, metrics = None, None
            for i in range(n_mb):
                part = {k: v[:, i * mb:(i + 1) * mb] for k, v in batch.items()}
                m, g = value_and_grad(params, part)
                g = [x.to(acc_dt).float() for x in tree_leaves(g)]
                m = {k: v.float() for k, v in m.items()}
                if grads is None:
                    grads, metrics = g, m
                else:
                    grads = [a + x for a, x in zip(grads, g)]
                    metrics = {k: metrics[k] + m[k] for k in m}
            grads = tree_unflatten(params, [g / n_mb for g in grads])
            metrics = {k: v / n_mb for k, v in metrics.items()}
        else:
            metrics, grads = value_and_grad(params, batch)
            grads = tree_map(lambda g: g.to(acc_dt), grads)
        if reduce_metrics is not None:
            metrics = reduce_metrics(metrics)

        lr = warmup_cosine(state["opt"]["step"], peak_lr=hp.learning_rate,
                           warmup_steps=hp.warmup_steps, total_steps=hp.total_steps)
        applied = None
        if active is not None:
            applied = active & torch.isfinite(metrics["loss"])
        om = adamw_update(grads, params, state["opt"], lr, tc, hp, applied=applied)
        return state, dict(metrics, **om, lr=lr)

    return train_step


# -- one trial ------------------------------------------------------------------


def _one_lane_batch(batch, device) -> Dict[str, torch.Tensor]:
    """One trial's batch (numpy arrays or tensors) on ``device``, as a
    population of one."""
    return {k: torch.as_tensor(v, device=device)[None] for k, v in batch.items()}


def _single_trial(lane_step: Callable) -> Callable:
    """``(state, batch, hp) -> (state, metrics)`` over one trial's state
    (no lane axis) through ``lane_step`` at K=1; ``hp``'s fields are floats
    or 0-d tensors; the metrics are 0-d tensors."""

    def train_step(state, batch, hp: HParams):
        dev = state["opt"]["step"].device
        _, metrics = lane_step(add_lane_axis(state), _one_lane_batch(batch, dev),
                               stack_hparams([hp], dev))
        return state, {k: v[0] for k, v in metrics.items()}

    return train_step


def make_train_step(tc: TrainConfig) -> Callable:
    """``(state, batch) -> (state, metrics)`` for one trial, its
    hyperparameters from ``tc`` (the JAX package's back-compat form)."""
    step = _single_trial(make_hparam_train_step(tc))
    hp = hparams_from_config(tc)

    def train_step(state, batch):
        return step(state, batch, hp)

    return train_step


# -- the step cache -----------------------------------------------------------------
#
# Keyed on the static parts of TrainConfig only (frozen dataclasses hash by
# value): distinct trials of one architecture share one step callable, their
# knobs arriving as the ``hp`` argument.  There is no compilation behind it
# in the port; the cache keeps the JAX package's contract.

_STEP_CACHE: Dict[Tuple, Any] = {}
_STEP_CACHE_LOCK = threading.Lock()


def get_compiled_train_step(tc: TrainConfig) -> Callable:
    """The memoized one-trial ``(state, batch, hp) -> (state, metrics)``:
    the same object for every trial of one static config
    (``static_step_key``).  Thread-safe; ``clear_step_cache()`` empties it."""
    key = static_step_key(tc)
    with _STEP_CACHE_LOCK:
        fn = _STEP_CACHE.get(key)
        if fn is None:
            fn = _STEP_CACHE[key] = _single_trial(make_hparam_train_step(tc))
    return fn


def clear_step_cache() -> None:
    with _STEP_CACHE_LOCK:
        _STEP_CACHE.clear()


def make_eval_step(tc: TrainConfig) -> Callable:
    """``(params, batch) -> metrics`` for one trial's parameters (no lane
    axis): the loss and its metrics, 0-d tensors, without a gradient."""

    @torch.no_grad()
    def eval_step(params, batch):
        dev = tree_leaves(params)[0].device
        _, metrics = _loss_fn(add_lane_axis(params), _one_lane_batch(batch, dev), tc)
        return {k: v[0] for k, v in metrics.items()}

    return eval_step


# -- one trial over a trial mesh ---------------------------------------------------


def use_plans(cfg, mesh, placements: Any, specs: Any) -> Dict[str, Any]:
    """How each stored leaf of a parameter tree placed by ``placements``
    becomes what its module computes on, by part (``sharding.at_use``):
    attention, the dense MLP and Mamba's channels stay split over the model
    axis where the seams cover them at this width (``tp_module_flags``), the
    MoE experts where the width divides them (expert parallelism); every
    other dim a placement splits is gathered (the vocab-split embedding,
    attention whose kv heads do not divide the width, the norms, the
    router, the shared experts), the data dim over the data axes."""
    computed = set(tp_width_rules(cfg, mesh.width))
    if cfg.has_moe and cfg.n_experts % mesh.width == 0:
        computed.add("expert")
    data_axes = tuple(mesh.data_axes)

    def plans(part_placements, logical_specs, offset):
        def one(placement, logical):
            dims = sharded_dims(placement, mesh)
            split = [logical[i] for i, a in dims if a == "model"]
            if mesh.width > 1 and any(n in computed and n not in split for n in logical):
                raise ValueError(f"{logical} placed {placement}: a dim its module "
                                 "computes split is not stored split over the model axis")
            data = [i for i, a in dims if a != "model"]
            for i in data:
                if (a := placement[i]) not in (data_axes, data_axes[0] if len(data_axes) == 1
                                               else None):
                    raise ValueError(f"{logical} placed {placement}: a data dim over {a}, "
                                     f"not the data axes {data_axes}")
            return UsePlan(
                model=tuple(i + offset for i, a in dims
                            if a == "model" and logical[i] not in computed),
                data=data[0] + offset if data else None)

        return map_specs(part_placements, logical_specs, one)

    # the tensors at use carry the lane axis; a superblock's leaves have lost
    # the stacked axis in its place
    uses = {"embedding": plans(placements["embedding"], specs["embedding"], 1),
            "blocks": plans(placements["blocks"], specs["blocks"], 0),
            "final_norm": plans(placements["final_norm"], specs["final_norm"], 1)}
    if "prefix" in placements:
        uses["prefix"] = plans(placements["prefix"], specs["prefix"], 1)
    return uses


def init_placement(placements: Any, part: str, path: tuple) -> tuple:
    """The placement of the leaf ``T.init_params`` makes at ``part`` /
    ``path`` (a superblock's: without the stacked axis)."""
    node = placements
    for k in part.split("/") + list(path):
        node = node[int(k)] if isinstance(node, list) else node[k]
    return node[1:] if part == "blocks" else node


def block_of(leaf: torch.Tensor, placement: tuple, mesh) -> torch.Tensor:
    """This rank's block of a whole ``leaf`` placed by ``placement``, a
    copy."""
    for i, a in sharded_dims(placement, mesh):
        n = leaf.shape[i] // axis_size(mesh, a)
        leaf = leaf.narrow(i, mesh.axis_index(a) * n, n)
    return leaf.contiguous().clone()


def _zip_map(fn, tree: Any, *placements: Any) -> Any:
    """``fn(leaf, *its placements)`` over a (nested dict / list) tree of
    tensors, walked with placement trees of the same structure."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], *(p[k] for p in placements)) for k in tree}
    if isinstance(tree, list):
        return [_zip_map(fn, t, *(p[i] for p in placements)) for i, t in enumerate(tree)]
    return fn(tree, *placements)


def _axes_mask(placements: Any, mesh) -> Any:
    """Per leaf, the frozenset of the axes its placement splits it over (the
    global norm all-reduces its sum of squares over them)."""
    return map_specs(placements, placements, lambda placement, _: frozenset(
        a for _, a in sharded_dims(placement, mesh)))


class TrialLayout:
    """Where one trial's train state lives on a trial mesh (``launch/mesh.py``):
    ``placements`` mirrors the state, per leaf the JAX package's
    ``build_sharding(train_state_specs(tc), make_rules(mesh axes))``
    placement; a rank stores its block of each leaf.  With
    ``parallel.zero_stage == "zero1"`` (the JAX dry run's ``--set
    zero_stage=zero1``) the parameters are placed by ``dict(rules,
    embed=())``: split over the model axis as before, whole over the data
    axes; the optimizer state stays data-split.

    What each module computes on: ``use_plans``; every leaf's ``embed`` dim
    over the data axes (FSDP), or, under ZeRO-1, the parameters whole."""

    def __init__(self, tc: TrainConfig, mesh):
        self.tc, self.mesh = tc, mesh
        cfg = tc.model
        self.zero1 = tc.parallel.zero_stage == "zero1"
        shapes = T.init_params(torch.Generator(), cfg, "meta")
        opt = {"mu": shapes, "nu": shapes, "step": torch.empty((), device="meta")}
        if tc.parallel.master_dtype is not None:
            opt["master"] = shapes
        specs = train_state_specs(tc)
        rules = make_rules(mesh.axis_names)
        self.placements = build_sharding({"params": shapes, "opt": opt}, specs, rules, mesh)
        if self.zero1:
            self.placements["params"] = build_sharding(shapes, specs["params"],
                                                       dict(rules, embed=()), mesh)
        pp, ps = self.placements["params"], specs["params"]
        self.uses = use_plans(cfg, mesh, pp, ps)
        # the gradients the norm reads are stored as the moments are
        self.gnorm_mask = _axes_mask(self.placements["opt"]["mu"], mesh)

    def _placement(self, part: str, path: tuple) -> tuple:
        return init_placement(self.placements["params"], part, path)

    def keep(self, part: str, path: tuple, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole leaf of the init (``T.init_params``'s
        ``keep``), a copy: the whole leaf is freed."""
        return block_of(leaf, self._placement(part, path), self.mesh)

    def opt_blocks(self, params, lanes: bool = False) -> Any:
        """Views of this rank's parameter blocks as the optimizer state
        stores them (``lanes``: the leaves carry a lane axis first): under
        ZeRO-1 each leaf's block over the data axes of the rank's parameter
        (whole over them); else the blocks themselves."""
        if not self.zero1:
            return params

        def one(x, p_place, o_place):
            for i, (a, b) in enumerate(zip(p_place, o_place)):
                if a is None and b is not None and axis_size(self.mesh, b) > 1:
                    n = x.shape[i + lanes] // axis_size(self.mesh, b)
                    x = x.narrow(i + lanes, self.mesh.axis_index(b) * n, n)
            return x

        return _zip_map(one, params, self.placements["params"], self.placements["opt"]["mu"])

    def init_state(self, gen: torch.Generator) -> Dict[str, Any]:
        """This rank's blocks of ``init_train_state(gen, tc)``: the same draws
        in the same order, one whole leaf at a time."""
        params = T.init_params(gen, self.tc.model, self.mesh.device, keep=self.keep)
        return {"params": params, "opt": init_opt_state(self.opt_blocks(params), self.tc)}

    def shard(self, state) -> Dict[str, Any]:
        """This rank's blocks of a whole state (a checkpoint's), on its device."""
        return shard_tree(state, self.placements, self.mesh)

    def gather(self, state, to_host: bool = False, keep: bool = True) -> Dict[str, Any]:
        """The whole state from the ranks' blocks, leaf by leaf (every rank
        calls it; ``to_host``: each whole leaf copied to host memory as it
        is joined; a rank that does not ``keep`` it gets None leaves)."""
        return gather_tree(state, self.placements, self.mesh, to_host=to_host, keep=keep)


def make_sharded_train_step(tc: TrainConfig, mesh) -> Callable:
    """``(state, batch) -> (state, metrics)`` for one trial on a trial mesh:
    ``state`` this rank's blocks (``step.layout``: a ``TrialLayout``), the
    update in place; ``batch`` the whole batch (every rank the same).  It is
    ``make_train_step(tc)``'s step, microbatching, rounding and AdamW
    included, with its per-microbatch gradient and its metrics taken on the
    mesh:

    * the data ranks take their rows of each microbatch (global microbatch
      i's rows split over the data axis, as JAX reshapes ``(n_mb, mb, ...)``
      and shards); the loss's denominators are the whole microbatch's mask
      sum (every rank holds the whole batch, so it needs no collective), so
      the ranks' losses and gradients sum to the unsharded ones: the
      gradients are summed over the data axis in the backward pass
      (``DataGather``), in the dtype autograd gives them, and only then
      rounded to ``grad_allreduce_dtype``; the metrics are all-reduced;
    * a microbatch whose rows do not divide the data axis is not split
      (``build_pspec`` replicates the batch): every data rank runs all of it
      and nothing is summed;
    * the model axis as ``TrialLayout`` says, under the seams
      (``tp_shard_context``); the global norm all-reduces each leaf's sum of
      squares over the axes it is stored sharded on;
    * AdamW updates each block elementwise.

    Under ZeRO-1 (``TrialLayout``: the parameters whole over the data axes)
    each data rank keeps its partial gradient through the microbatches
    (summed in fp32 where there are several); the sum is reduce-scattered
    over the data axes once a step, to the blocks the moments hold (an
    all-reduce for a leaf the moments hold whole), and only then rounded to
    ``grad_allreduce_dtype``; AdamW updates the rank's block of each
    parameter, and the blocks are all-gathered once into the whole
    parameters.  With one microbatch that is the FSDP step's arithmetic;
    with several, the rounding comes after the sum over microbatches.

    ``step.raw_grads(state, batch)`` gives this rank's gradient blocks of a
    batch as one microbatch, before their rounding."""
    layout = TrialLayout(tc, mesh)
    mb = tc.parallel.microbatch
    flags = tp_module_flags(tc.model, mesh.width)
    hp = hparams_from_config(tc)
    nd = mesh.rows

    def splits(rows: int) -> bool:
        """Whether the data ranks split a microbatch of ``rows`` rows."""
        return nd > 1 and rows % nd == 0

    @contextlib.contextmanager
    def on_mesh(split: bool, reduce: bool = True):
        with sharding_context(mesh, layout.uses, split, reduce=reduce), \
                tp_shard_context(mesh, flags, gnorm_mask=layout.gnorm_mask):
            yield

    def micro(params, whole):
        """Metrics and this rank's gradient blocks of one whole (lane-batched)
        microbatch, summed over the data ranks, before any rounding."""
        rows = whole["mask"].shape[1]
        split = splits(rows)
        first, n = (mesh.row * (rows // nd), rows // nd) if split else (0, rows)
        part = {k: v[:, first:first + n] for k, v in whole.items()}
        denom = torch.clamp(lane_sum(whole["mask"]), min=1.0)
        return _value_and_grad(params, part, tc, denom=denom, n_data=nd if split else 1)

    def all_reduce_metrics(metrics):
        keys = sorted(metrics)
        summed = mesh.axis_all_reduce(torch.stack([metrics[k].float() for k in keys]),
                                      mesh.axis)
        return {k: summed[j].to(metrics[k].dtype) for j, k in enumerate(keys)}

    steps = {split: _single_trial(make_hparam_train_step(
        tc, value_and_grad=micro, reduce_metrics=all_reduce_metrics if split else None))
        for split in (False, True)}

    def raw_grads(state, batch):
        """This rank's gradient blocks of the whole ``batch`` as one
        microbatch, as the data ranks' sum leaves them, unrounded."""
        batch = _one_lane_batch(batch, mesh.device)
        with on_mesh(splits(batch["mask"].shape[1])):
            _, g = micro(add_lane_axis(state)["params"], batch)
        return tree_map(lambda x: x[0], g)

    acc_dt = dtype_of(tc.parallel.grad_allreduce_dtype)
    placed = _zip_map(lambda _, a, b: (a, b), layout.placements["params"],
                      layout.placements["params"], layout.placements["opt"]["mu"])

    def to_block(g, pair, split: bool):
        """This rank's block of its partial gradient ``g`` (lane axis first)
        as the moments hold it, summed over the data ranks that split the
        rows."""
        p_place, o_place = pair
        dims = [i for i, (a, b) in enumerate(zip(p_place, o_place))
                if a is None and b is not None and axis_size(mesh, b) > 1]
        if not split:
            for i in dims:
                n = g.shape[i + 1] // axis_size(mesh, o_place[i])
                g = g.narrow(i + 1, mesh.axis_index(o_place[i]) * n, n)
            return g.contiguous()
        if dims:
            return mesh.axis_reduce_scatter(g, dims[0] + 1, o_place[dims[0]])
        return mesh.axis_all_reduce(g.contiguous().clone(), mesh.axis)

    def zero1_step(state, batch):
        lanes = add_lane_axis(state)
        params, opt = lanes["params"], lanes["opt"]
        whole = _one_lane_batch(batch, mesh.device)
        rows = mb if mb and mb > 0 else whole["mask"].shape[1]
        n_mb = whole["mask"].shape[1] // rows
        split = splits(rows)
        grads, metrics = None, None
        with on_mesh(split, reduce=False):
            for i in range(n_mb):
                part = {k: v[:, i * rows:(i + 1) * rows] for k, v in whole.items()}
                m, g = micro(params, part)
                g = tree_leaves(g)
                if n_mb > 1:
                    g = [x.float() for x in g]
                    m = {k: v.float() for k, v in m.items()}
                grads = g if grads is None else [a + x for a, x in zip(grads, g)]
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
            grads = _zip_map(lambda g, pair: to_block(g, pair, split),
                             tree_unflatten(params, grads), placed)
            grads = tree_map(lambda x: x.to(acc_dt).float() / n_mb if n_mb > 1
                             else x.to(acc_dt), grads)
            metrics = {k: v / n_mb for k, v in metrics.items()} if n_mb > 1 else metrics
            if split:
                metrics = all_reduce_metrics(metrics)
            dev_hp = stack_hparams([hp], mesh.device)
            lr = warmup_cosine(opt["step"], peak_lr=dev_hp.learning_rate,
                               warmup_steps=dev_hp.warmup_steps, total_steps=dev_hp.total_steps)
            blocks = layout.opt_blocks(params, lanes=True)
            om = adamw_update(grads, blocks, opt, lr, tc, dev_hp)

        def join(p, block, pair):
            p_place, o_place = pair
            for i, (a, b) in enumerate(zip(p_place, o_place)):
                if a is None and b is not None and axis_size(mesh, b) > 1:
                    p.copy_(mesh.axis_all_gather(block, i + 1, b))
            return p

        _zip_map(join, params, blocks, placed)
        return state, {k: v[0] for k, v in dict(metrics, **om, lr=lr).items()}

    def train_step(state, batch):
        split = splits(mb if mb and mb > 0 else len(batch["mask"]))
        if layout.zero1:
            return zero1_step(state, batch)
        with on_mesh(split):
            return steps[split](state, batch, hp)

    train_step.layout, train_step.raw_grads = layout, raw_grads
    return train_step
