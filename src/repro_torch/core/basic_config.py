"""BasicConfig + ``print_result`` — the paper's job-side protocol (§III-A1, Code 1/3).

A job receives its hyperparameters as a JSON file whose path is ``sys.argv[1]``;
it reports its score by printing a single tagged line to stdout.  The script
remains independently runnable (the config has defaults), which is the paper's
key usability claim: the SAME script works standalone and under the framework.
"""
from __future__ import annotations

import json
import sys
from typing import Any, Dict, Optional

RESULT_TAG = "#Auptimizer:"


class BasicConfig(dict):
    """A dict with ``load``/``save`` helpers (paper §III-A1).

    ``BasicConfig(**defaults).load(sys.argv[1])`` is the adoption one-liner:
    defaults keep the script standalone-runnable; the framework's JSON file
    overrides them at job time.  Attribute access mirrors the released tool.
    """

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:  # pragma: no cover - attribute protocol
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def load(self, path: Optional[str] = None) -> "BasicConfig":
        """Merge JSON file at ``path`` over the defaults; returns self."""
        if path:
            with open(path, "r") as f:
                self.update(json.load(f))
        return self

    def load_argv(self) -> "BasicConfig":
        """Convenience: load from sys.argv[1] when present."""
        return self.load(sys.argv[1] if len(sys.argv) > 1 else None)

    def save(self, path: str) -> "BasicConfig":
        with open(path, "w") as f:
            json.dump(dict(self), f, indent=1, sort_keys=True, default=str)
        return self

    def to_json(self) -> str:
        return json.dumps(dict(self), sort_keys=True, default=str)


def print_result(result: Any, extra: Any = None, file=None) -> None:
    """Report a job's score back to the framework (paper Code 3, line 10).

    ``result`` is the scalar score (higher is better by convention; the
    experiment config's ``target`` field can flip it).  ``extra`` is the
    "arbitrary string passed back to Proposer" mentioned in §III-B2 — used
    e.g. by Hyperband to hand back a checkpoint path.
    """
    payload: Dict[str, Any] = {"score": float(result)}
    if extra is not None:
        payload["extra"] = extra
    out = file if file is not None else sys.stdout
    print(RESULT_TAG + json.dumps(payload), file=out, flush=True)


def parse_result(stdout_text: str) -> Dict[str, Any]:
    """Extract the last tagged result line from a job's stdout.

    Raises ValueError when the job never reported — the experiment marks such
    jobs FAILED rather than crashing the whole run.
    """
    last = None
    for line in stdout_text.splitlines():
        line = line.strip()
        if line.startswith(RESULT_TAG):
            last = line[len(RESULT_TAG):]
    if last is None:
        raise ValueError("job produced no result line (expected `print_result(...)`)")
    return json.loads(last)
