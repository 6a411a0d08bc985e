"""Typed hyperparameter search-space definition.

The paper's ``parameter_config`` block (Code 2) defines each hyperparameter as
``{"name": ..., "type": "float"|"int"|"choice", "range": [...]}``.  We keep that
JSON form as the canonical serialized representation and add a typed layer on
top so proposers can reason about dimensionality, log-scaling and grids.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence

import numpy as np

_VALID_TYPES = ("float", "int", "choice")


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One hyperparameter dimension.

    ``range`` is [lo, hi] for float/int (inclusive) or the list of values for
    choice.  ``scale='log'`` samples uniformly in log-space (lr-style params).
    ``n_grid`` controls how many points grid search places on this dimension.
    """

    name: str
    type: str
    range: Sequence[Any]
    scale: str = "linear"  # 'linear' | 'log'
    n_grid: int = 3

    def __post_init__(self):
        if self.type not in _VALID_TYPES:
            raise ValueError(f"param {self.name}: bad type {self.type!r}")
        if self.type in ("float", "int"):
            if len(self.range) != 2 or self.range[0] > self.range[1]:
                raise ValueError(f"param {self.name}: bad range {self.range!r}")
            if self.scale == "log" and self.range[0] <= 0:
                raise ValueError(f"param {self.name}: log scale needs positive range")
            if self.type == "int" and math.ceil(self.range[0]) > math.floor(self.range[1]):
                raise ValueError(f"param {self.name}: no integer in range {self.range!r}")
        if self.type == "choice" and len(self.range) == 0:
            raise ValueError(f"param {self.name}: empty choice set")

    # -- sampling ----------------------------------------------------------
    def sample(self, rng: np.random.Generator) -> Any:
        if self.type == "choice":
            return self.range[int(rng.integers(len(self.range)))]
        lo, hi = float(self.range[0]), float(self.range[1])
        if self.scale == "log":
            v = math.exp(rng.uniform(math.log(lo), math.log(hi)))
        else:
            v = rng.uniform(lo, hi)
        if self.type == "int":
            # round can escape fractional bounds (e.g. [0.25, 1.25] -> 0);
            # clamp to the integers inside the range
            q = int(round(v))
            q = max(q, int(math.ceil(lo)))
            q = min(q, int(math.floor(hi)))
            return q
        return float(v)

    def grid(self) -> List[Any]:
        if self.type == "choice":
            return list(self.range)
        lo, hi = float(self.range[0]), float(self.range[1])
        n = max(1, int(self.n_grid))
        if n == 1:
            pts = [0.5 * (lo + hi)]
        elif self.scale == "log":
            pts = list(np.exp(np.linspace(math.log(lo), math.log(hi), n)))
        else:
            pts = list(np.linspace(lo, hi, n))
        if self.type == "int":
            out, seen = [], set()
            for p in pts:
                q = int(round(p))
                q = max(q, int(math.ceil(lo)))
                q = min(q, int(math.floor(hi)))
                if q not in seen:
                    seen.add(q)
                    out.append(q)
            return out
        return [float(p) for p in pts]

    # -- unit-cube encoding (for GP-BO / TPE internals) ---------------------
    def to_unit(self, value: Any) -> float:
        if self.type == "choice":
            return self.range.index(value) / max(1, len(self.range) - 1) if len(self.range) > 1 else 0.0
        lo, hi = float(self.range[0]), float(self.range[1])
        v = float(value)
        if self.scale == "log":
            lo, hi, v = math.log(lo), math.log(hi), math.log(max(v, 1e-300))
        return 0.0 if hi == lo else (v - lo) / (hi - lo)

    def from_unit(self, u: float) -> Any:
        u = min(1.0, max(0.0, float(u)))
        if self.type == "choice":
            idx = int(round(u * (len(self.range) - 1)))
            return self.range[idx]
        lo, hi = float(self.range[0]), float(self.range[1])
        if self.scale == "log":
            v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            v = lo + u * (hi - lo)
        return int(round(v)) if self.type == "int" else float(v)

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "type": self.type,
            "range": list(self.range),
            "scale": self.scale,
            "n_grid": self.n_grid,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ParamSpec":
        return ParamSpec(
            name=d["name"],
            type=d["type"],
            range=d["range"],
            scale=d.get("scale", "linear"),
            n_grid=int(d.get("n_grid", 3)),
        )


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    params: Sequence[ParamSpec]

    def __post_init__(self):
        names = [p.name for p in self.params]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate parameter names: {names}")

    def __len__(self) -> int:
        return len(self.params)

    def __iter__(self):
        return iter(self.params)

    def names(self) -> List[str]:
        return [p.name for p in self.params]

    def sample(self, rng: np.random.Generator) -> Dict[str, Any]:
        return {p.name: p.sample(rng) for p in self.params}

    def to_unit(self, config: Dict[str, Any]) -> np.ndarray:
        return np.array([p.to_unit(config[p.name]) for p in self.params], dtype=np.float64)

    def from_unit(self, u: np.ndarray) -> Dict[str, Any]:
        return {p.name: p.from_unit(u[i]) for i, p in enumerate(self.params)}

    def to_json(self) -> List[Dict[str, Any]]:
        return [p.to_json() for p in self.params]

    @staticmethod
    def from_json(lst: Sequence[Dict[str, Any]]) -> "SearchSpace":
        return SearchSpace(tuple(ParamSpec.from_json(d) for d in lst))
