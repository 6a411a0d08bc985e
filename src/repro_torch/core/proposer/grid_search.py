"""Grid search.  ``n_samples`` is derived from the grid itself (paper §IV-D
uses 162 = 3^4 x 2 configurations)."""
from __future__ import annotations

import itertools
from typing import Any, Dict, Optional

from . import Proposer, register


@register("grid")
class GridProposer(Proposer):
    def __init__(self, space, **kwargs):
        super().__init__(space, **kwargs)
        axes = [p.grid() for p in space]
        self._grid = [
            {p.name: v for p, v in zip(space, combo)}
            for combo in itertools.product(*axes)
        ]
        # Grid size overrides any requested n_samples.
        self.n_samples = len(self._grid)

    def _propose(self) -> Optional[Dict[str, Any]]:
        if self.n_proposed >= len(self._grid):
            return None
        return dict(self._grid[self.n_proposed])
