"""EAS-style NAS proposer (Cai et al. 2018, paper §V).

The paper wraps EAS's RL meta-controller as a Proposer: each *episode* the
controller derives K child architectures from the incumbent by net2net
morphisms (WIDEN a conv layer / DEEPEN by inserting an identity layer), runs
them as jobs, and uses the reported accuracies as reward to update its policy
before committing to the best child.  Weight reuse happens job-side via the
``arch_parent`` aux key (function-preserving morphisms => children start from
parent weights; see train/cnn.py morphism init).

The controller here is a compact softmax-preference policy (REINFORCE on
operation logits) rather than the original bidirectional-LSTM — the *framework
integration* (controller <-> jobs synchronization, which is what the paper
demonstrates) is identical.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from . import Proposer, register

_OPS = ("widen", "deepen")


def encode_arch(arch: Dict[str, Any]) -> str:
    return json.dumps(arch, sort_keys=True)


def default_arch() -> Dict[str, Any]:
    # the paper's §IV demo net: 2 conv + 2 fc
    return {"conv": [[16, 3], [32, 3]], "fc": 128}


@register("eas")
class EASProposer(Proposer):
    def __init__(self, space=None, n_episodes: int = 4, children_per_episode: int = 4,
                 lr: float = 0.5, max_layers: int = 6, max_filters: int = 256, **kwargs):
        # NAS explores architectures, not the numeric space; space may be empty.
        from ..search_space import SearchSpace
        super().__init__(space if space is not None else SearchSpace(()), **kwargs)
        self.n_episodes = int(n_episodes)
        self.K = int(children_per_episode)
        self.n_samples = self.n_episodes * self.K + 1  # +1 incumbent eval
        self.lr = float(lr)
        self.max_layers = int(max_layers)
        self.max_filters = int(max_filters)
        self.incumbent = default_arch()
        self.incumbent_score: Optional[float] = None
        self.episode = 0
        self.ep_children: List[Dict[str, Any]] = []
        self.ep_issued = 0
        self.ep_results: Dict[int, float] = {}
        # policy: preference logits over morphism ops
        self.op_logits = np.zeros(len(_OPS))
        self._baseline = 0.0
        self._pending_incumbent = True

    # -- morphisms -------------------------------------------------------------
    def _morph(self, arch: Dict[str, Any]) -> tuple:
        probs = np.exp(self.op_logits - self.op_logits.max())
        probs /= probs.sum()
        op = _OPS[int(self.rng.choice(len(_OPS), p=probs))]
        child = json.loads(json.dumps(arch))
        convs = child["conv"]
        if op == "widen" or len(convs) >= self.max_layers:
            li = int(self.rng.integers(len(convs)))
            convs[li][0] = min(self.max_filters, convs[li][0] * 2)
            op = "widen"
        else:
            li = int(self.rng.integers(len(convs)))
            # identity-initialized layer: same width as predecessor
            convs.insert(li + 1, [convs[li][0], 3])
        return child, op

    # -- proposer API ------------------------------------------------------------
    def _propose(self) -> Optional[Dict[str, Any]]:
        if self._pending_incumbent:
            self._pending_incumbent = False
            return {"arch": encode_arch(self.incumbent), "arch_parent": "", "eas_role": "incumbent"}
        if self.incumbent_score is None:
            return None  # wait for incumbent eval
        if self.episode >= self.n_episodes:
            return None
        if len(self.ep_children) < self.K:
            child, op = self._morph(self.incumbent)
            idx = len(self.ep_children)
            self.ep_children.append({"arch": child, "op": op})
            return {
                "arch": encode_arch(child),
                "arch_parent": encode_arch(self.incumbent),
                "eas_role": "child",
                "eas_episode": self.episode,
                "eas_idx": idx,
                "eas_op": op,
            }
        if len(self.ep_results) >= self.K:
            self._end_episode()
            return self._propose()
        return None  # episode barrier

    def _end_episode(self) -> None:
        # REINFORCE: advantage = child score - EMA baseline, applied to op logits
        for idx, score in self.ep_results.items():
            op = self.ep_children[idx]["op"]
            adv = score - self._baseline
            self.op_logits[_OPS.index(op)] += self.lr * adv
            self._baseline = 0.9 * self._baseline + 0.1 * score
        best_idx = max(self.ep_results, key=self.ep_results.get)
        if self.ep_results[best_idx] >= (self.incumbent_score or -np.inf):
            self.incumbent = self.ep_children[best_idx]["arch"]
            self.incumbent_score = self.ep_results[best_idx]
        self.episode += 1
        self.ep_children, self.ep_results = [], {}

    def _on_result(self, config: Dict[str, Any], score: float) -> None:
        if config.get("eas_role") == "incumbent":
            self.incumbent_score = score
        elif config.get("eas_episode") == self.episode:
            self.ep_results[config.get("eas_idx")] = score

    def _on_failure(self, config: Dict[str, Any]) -> None:
        self._on_result(config, float("-inf"))

    def finished(self) -> bool:
        return self.episode >= self.n_episodes and self.incumbent_score is not None

    def best(self) -> Optional[Dict[str, Any]]:
        if self.incumbent_score is None:
            return None
        return {"config": {"arch": encode_arch(self.incumbent)}, "score": self.incumbent_score}
