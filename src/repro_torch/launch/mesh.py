"""The trial mesh: one trial's ranks as a ``(data, model)`` grid.

The twin of the JAX package's ``launch/mesh.py::make_trial_mesh``.  JAX lays
``devices[:n]`` row-major on a ``(d, n / d)`` mesh; the port's grid is the
ranks of the initialised ``torch.distributed`` group, rank r at ``(r // m,
r % m)``, which is ``PopulationMesh(width=m)``'s grid read with the axis
names ``("data", "model")``: its model group is a data row's m ranks, its
pop group the ranks at one model position (the data axis).

``make_production_mesh`` (256 or 512 chips, for the JAX package's
``dryrun.py``) has no twin yet: it comes with ROADMAP.md section 1, item 13.5.
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
