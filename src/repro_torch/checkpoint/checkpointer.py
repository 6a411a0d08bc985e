"""Atomic, optionally-async checkpointing for trees of tensors and arrays.

Layout: ``<dir>/step_<n>/arrays.npz`` (flattened path -> array) +
``manifest.json``.  Writes go to ``step_<n>.tmp`` then ``os.rename``: a crash
mid-save never corrupts the latest checkpoint.  ``save_async`` copies the
state to host memory on the caller's thread and writes on a background
thread; ``wait`` surfaces the background write's error.

Leaves may be numpy arrays or torch tensors (on any device).  A tensor goes
to disk as the numpy array of its raw bits and its torch dtype is recorded in
the manifest (``torch_dtypes``), so ``restore`` gives back a CPU tensor with
the same dtype and the same bits; numpy has no bfloat16, so a bfloat16
tensor is stored as its 16-bit pattern, never as a rounded value.  The
format is the PyTorch port's own: it does not read the JAX package's
checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_RAW_VIEW = {torch.bfloat16, torch.float16}   # dtypes numpy cannot hold as themselves


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if isinstance(node, dict) and node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def _to_host(v, copy: bool) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as (numpy array of its bits, its torch dtype name or None).
    ``copy`` forces a copy of a CPU tensor (the caller may write it later)."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v), None
    t = v.detach()
    t = t.to("cpu", copy=True) if copy or t.device.type != "cpu" else t
    name = str(t.dtype).replace("torch.", "")
    if t.dtype in _RAW_VIEW:
        t = t.view(_INT_OF_SIZE[t.element_size()])
    return t.numpy(), name


def _from_host(a: np.ndarray, dtype_name: Optional[str]):
    if dtype_name is None:
        return a
    dtype = getattr(torch, dtype_name)
    t = torch.from_numpy(a if a.flags.c_contiguous else a.copy())   # keeps 0-d leaves 0-d
    return t.view(dtype) if dtype in _RAW_VIEW else t


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------------
    def _host(self, state, copy: bool):
        flat, dtypes = {}, {}
        for k, v in _flatten(state).items():
            flat[k], name = _to_host(v, copy)
            if name is not None:
                dtypes[k] = name
        return flat, dtypes

    def save(self, step: int, state: Any, extra: Optional[Dict[str, Any]] = None) -> str:
        flat, dtypes = self._host(state, copy=False)
        return self._write(step, flat, dtypes, extra or {})

    def save_async(self, step: int, state: Any, extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        # copy to host on the caller's thread; write in the background
        flat, dtypes = self._host(state, copy=True)

        def _bg():
            try:
                self._write(step, flat, dtypes, extra or {})
            except BaseException as e:  # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=_bg, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _write(self, step: int, flat: Dict[str, np.ndarray], dtypes: Dict[str, str],
               extra: Dict[str, Any]) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        old = final + ".old"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "time": time.time(), "keys": sorted(flat),
                    "torch_dtypes": dtypes, **extra}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, default=str)
        # atomic replace: never a window with no restorable copy of this step.
        # The previous dir is renamed aside and removed only once the new one
        # is in place; ``all_steps`` / ``restore`` pick up an orphaned
        # ``.old`` left by a crash between the two renames.
        if os.path.exists(old):
            shutil.rmtree(old)  # leftover from a previous crash, superseded
        if os.path.exists(final):
            os.rename(final, old)
        os.rename(tmp, final)
        if os.path.exists(old):
            shutil.rmtree(old)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            base = os.path.join(self.dir, f"step_{s:08d}")
            shutil.rmtree(base, ignore_errors=True)
            shutil.rmtree(base + ".old", ignore_errors=True)

    # -- restore ---------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        """Steps with a restorable checkpoint.  Non-conforming ``step_*``
        entries (junk files, partial copies) are skipped with a warning; an
        orphaned ``step_N.old`` (a crash between the two renames in
        ``_write``) counts as step N."""
        out = set()
        for name in os.listdir(self.dir):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            base = name[:-4] if name.endswith(".old") else name
            try:
                step = int(base[5:])
            except ValueError:
                warnings.warn(f"ignoring non-checkpoint entry {name!r} in {self.dir}",
                              stacklevel=2)
                continue
            if name.endswith(".old") and os.path.exists(os.path.join(self.dir, base)):
                continue  # superseded: the final dir for this step exists
            out.add(step)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Tuple[Any, Dict[str, Any]]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        if not os.path.exists(path) and os.path.exists(path + ".old"):
            path += ".old"  # crash between _write's renames: the old copy survives
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("torch_dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: _from_host(z[k], dtypes.get(k)) for k in z.files}
        return _unflatten(flat), manifest


class LaneSnapshotStore:
    """Per-trial lane snapshots for crash-safe streaming flights.

    Keyed by *lineage* (the trial's data-stream id, which is stable across
    flight restarts and ``--resume``: the Experiment re-stamps a re-queued
    job's original stream), each entry holds the latest harvested lane state
    (``train.population.make_lane_snapshot``: CPU tensors) plus the host
    cursors needed to resume the lane mid-budget: local step, data cursor,
    applied-step base, stream word.

    In memory always (flight-restart recovery inside one process); with
    ``root`` each ``put`` also lands on disk through a per-lineage
    ``Checkpointer`` (atomic replace, junk-hardened listing), which is what
    ``--resume`` reads after a host crash.  ``forget`` drops a completed
    trial's snapshot: it can never be leased again.
    """

    def __init__(self, root: Optional[str] = None, keep: int = 2):
        self.root = root
        self.keep = int(keep)
        self._mem: Dict[int, Tuple[Any, Dict[str, Any]]] = {}
        self._ckpt: Dict[int, Checkpointer] = {}
        self._lock = threading.Lock()
        self.n_persisted = 0
        if root:
            os.makedirs(root, exist_ok=True)

    def _ckpt_of(self, lineage: int) -> Checkpointer:
        with self._lock:
            ck = self._ckpt.get(lineage)
            if ck is None:
                ck = Checkpointer(os.path.join(self.root, f"lineage_{int(lineage)}"),
                                  keep=self.keep)
                self._ckpt[lineage] = ck
        return ck

    def put(self, lineage: int, snap: Any, meta: Dict[str, Any]) -> Any:
        """Keep ``snap`` as the lineage's latest snapshot; returns the one
        it supersedes in memory (None if there was none), which nothing of
        the store reads any more."""
        lineage = int(lineage)
        with self._lock:
            old = self._mem.get(lineage)
            self._mem[lineage] = (snap, dict(meta))
        if self.root:
            self._ckpt_of(lineage).save(int(meta["local"]), snap, extra=meta)
            self.n_persisted += 1
        return None if old is None or old[0] is snap else old[0]

    def get(self, lineage: int) -> Optional[Tuple[Any, Dict[str, Any]]]:
        lineage = int(lineage)
        with self._lock:
            hit = self._mem.get(lineage)
        if hit is not None:
            return hit
        if not self.root:
            return None
        d = os.path.join(self.root, f"lineage_{lineage}")
        if not os.path.isdir(d):
            return None
        ck = self._ckpt_of(lineage)
        if ck.latest_step() is None:
            return None
        snap, manifest = ck.restore()
        with self._lock:
            self._mem[lineage] = (snap, manifest)
        return snap, manifest

    def forget(self, lineage: int) -> Any:
        """Drop the lineage's snapshots; returns the one it held in memory
        (None if there was none)."""
        lineage = int(lineage)
        with self._lock:
            old = self._mem.pop(lineage, None)
            self._ckpt.pop(lineage, None)
        if self.root:
            shutil.rmtree(os.path.join(self.root, f"lineage_{lineage}"), ignore_errors=True)
        return None if old is None else old[0]

    def lineages(self) -> List[int]:
        """Every lineage with a restorable snapshot (memory or disk)."""
        out = set()
        with self._lock:
            out.update(self._mem)
        if self.root and os.path.isdir(self.root):
            for name in os.listdir(self.root):
                if name.startswith("lineage_"):
                    try:
                        out.add(int(name[8:]))
                    except ValueError:
                        continue
        return sorted(out)
