"""The population mesh over ``torch.distributed``: see ``sharding``."""
from .sharding import PopulationMesh, population_mesh, population_specs  # noqa: F401
