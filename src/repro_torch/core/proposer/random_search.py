"""Random search (Bergstra & Bengio 2012) — the paper's default benchmark."""
from __future__ import annotations

from typing import Any, Dict, Optional

from . import Proposer, register


@register("random")
class RandomProposer(Proposer):
    def _propose(self) -> Optional[Dict[str, Any]]:
        if self.n_proposed >= self.n_samples:
            return None  # budget fully issued; wait for stragglers
        return self.space.sample(self.rng)
