"""The trial mesh: one trial's ranks as a ``(data, model)`` grid.

The twin of the JAX package's ``launch/mesh.py::make_trial_mesh``.  JAX lays
``devices[:n]`` row-major on a ``(d, n / d)`` mesh; the port's grid is the
ranks of the initialised ``torch.distributed`` group, rank r at ``(r // m,
r % m)``, which is ``PopulationMesh(width=m)``'s grid read with the axis
names ``("data", "model")``: its model group is a data row's m ranks, its
pop group the ranks at one model position (the data axis).

``make_production_mesh`` is the twin of the JAX package's: the ``(16, 16)``
``("data", "model")`` grid of 256 ranks, or the ``(2, 16, 16)`` ``("pod",
"data", "model")`` grid of 512, over the process group already initialised
(``distributed.sharding.grid_mesh``).  It serves the dry run
(``launch/dryrun.py``), which initialises a fake process group of that
world at rank 0 and places each leaf on the meta device.
"""
from __future__ import annotations

from typing import Optional, Tuple


def trial_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """JAX's factorisation of ``n_devices`` into ``(data, model)``, favouring
    the model axis: ``(1, n)`` for tiny trials, squarish otherwise."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"a trial mesh needs at least one device, got {n_devices}")
    d = 1
    while d * d <= n:
        d += 1
    d -= 1
    while n % d:
        d -= 1
    return d, n // d


PRODUCTION = {False: (("data", "model"), (16, 16)),
              True: (("pod", "data", "model"), (2, 16, 16))}


def make_production_mesh(*, multi_pod: bool = False, device="meta"):
    """This rank's place on the production mesh: ``(data=16, model=16)``, or
    ``(pod=2, data=16, model=16)`` with ``multi_pod``, over the process
    group already initialised, whose world must be 256 or 512; ``device``
    the rank's (the dry run's: ``meta``)."""
    import torch.distributed as dist

    from ..distributed.sharding import grid_mesh

    names, shape = PRODUCTION[bool(multi_pod)]
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"production mesh {shape} needs {n} ranks, found {world}; "
            "run under launch/dryrun.py, which makes a fake process group of 512 ranks")
    return grid_mesh(names, shape, device)


def make_trial_mesh(n_devices: int, shape: Optional[Tuple[int, int]] = None, device=None,
                    **group):
    """This process's rank of a trial mesh over ``n_devices`` ranks, its
    axes ``("data", "model")`` shaped ``shape`` (default
    ``trial_mesh_shape(n_devices)``).  The process group
    is the one already initialised, else one made from ``group``'s
    ``init_method`` / ``rank`` / ``world_size`` or ``torchrun``'s
    environment, as ``distributed.sharding.population_mesh`` makes it; its
    world must be ``n_devices``.  The RMSNorm backward plans for one trial."""
    from ..distributed.sharding import population_mesh
    from ..kernels import rmsnorm

    d, m = tuple(shape) if shape is not None else trial_mesh_shape(n_devices)
    if d * m != int(n_devices):
        raise ValueError(f"mesh shape {(d, m)} does not hold {n_devices} devices")
    mesh = population_mesh(device, axis="data", width=m, **group)
    if mesh.world_size != int(n_devices):
        world = mesh.world_size
        mesh.destroy()
        raise ValueError(f"a trial mesh of {n_devices} devices over a process group of "
                         f"{world} ranks: they must be equal")
    rmsnorm.plan_for_mesh(1)
    return mesh
