"""Mesh-slice resource pool: trials on contiguous tiles of a device grid.

The paper's resource quantum is a GPU id; on a pod of accelerators it is a
**mesh slice**: a contiguous tile of the device grid.  A 4x4 grid tiled into
2x2 slices yields 4 HPO trials, each itself a multi-device program over its
slice.  ``tile_pod`` does the row-major tiling (pure arithmetic, the JAX
package's), and ``MeshSlice.mesh()`` hands the trial its slice's devices as a
``(rows, cols)`` grid of ``torch.device`` s.

``virtual=True`` backs slices with labeled placeholders instead of real
devices, so scheduling behaviour (the paper's Fig. 3 scalability experiment)
can be studied at 256-slice scale on one CPU.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from . import ResourceManager, register
from ..job import Job, JobResult, JobStatus


def _visible_devices() -> list:
    import torch

    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


@dataclasses.dataclass(frozen=True)
class MeshSlice:
    slice_id: str
    shape: Tuple[int, ...]          # device-grid tile shape, e.g. (2, 2)
    devices: Tuple[Any, ...]        # torch devices, or str labels if virtual
    origin: Tuple[int, ...] = (0, 0)

    @property
    def virtual(self) -> bool:
        return len(self.devices) > 0 and isinstance(self.devices[0], str)

    def mesh(self) -> np.ndarray:
        """The slice's devices as a ``shape`` grid (an object array of
        ``torch.device``); a virtual slice has none."""
        if self.virtual:
            raise RuntimeError(f"slice {self.slice_id} is virtual; no devices available")
        return np.array(self.devices, dtype=object).reshape(self.shape)

    def __str__(self) -> str:
        return self.slice_id


def tile_pod(
    pod_shape: Tuple[int, int],
    slice_shape: Tuple[int, int],
    devices: Optional[Sequence[Any]] = None,
    virtual: bool = False,
) -> List[MeshSlice]:
    """Tile a (rows, cols) pod grid into row-major contiguous slices."""
    R, C = pod_shape
    r, c = slice_shape
    if R % r or C % c:
        raise ValueError(f"slice {slice_shape} does not tile pod {pod_shape}")
    if virtual:
        grid = np.array([f"chip({i},{j})" for i in range(R) for j in range(C)],
                        dtype=object).reshape(R, C)
    else:
        devs = list(devices) if devices is not None else _visible_devices()
        if len(devs) < R * C:
            raise ValueError(f"need {R * C} devices for pod {pod_shape}, have {len(devs)}")
        grid = np.empty(R * C, dtype=object)
        grid[:] = devs[: R * C]
        grid = grid.reshape(R, C)
    slices = []
    for i in range(0, R, r):
        for j in range(0, C, c):
            tile = grid[i: i + r, j: j + c].reshape(-1)
            slices.append(
                MeshSlice(
                    slice_id=f"slice[{i}:{i+r},{j}:{j+c}]",
                    shape=(r, c),
                    devices=tuple(tile.tolist()),
                    origin=(i, j),
                )
            )
    return slices


@register("mesh")
class MeshPoolResourceManager(ResourceManager):
    """Trials are callables ``f(config, mesh_slice) -> score`` run on slices."""

    def __init__(
        self,
        pod_shape: Tuple[int, int] = (1, 1),
        slice_shape: Tuple[int, int] = (1, 1),
        devices: Optional[Sequence[Any]] = None,
        virtual: bool = False,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.slices = {
            s.slice_id: s
            for s in tile_pod(tuple(pod_shape), tuple(slice_shape), devices, virtual)
        }
        for sid in self.slices:
            self.add_resource(sid)

    def slice_of(self, res_id: str) -> MeshSlice:
        return self.slices[res_id]

    def run(self, job: Job, target: Callable[[dict, MeshSlice], Any]) -> None:
        self.bind(job.resource_id, job)
        sl = self.slices[job.resource_id]

        def _worker():
            job.mark_running()
            try:
                out = target(dict(job.config), sl)
                score, extra = out if isinstance(out, tuple) else (out, None)
                job.finish(JobResult(score=float(score), extra=extra))
            except Exception as e:
                job.fail(f"{type(e).__name__}: {e}")

        threading.Thread(target=_worker, name=f"job-{job.job_id}", daemon=True).start()

    def kill(self, job: Job) -> None:
        job.fail("killed by deadline", status=JobStatus.KILLED)
