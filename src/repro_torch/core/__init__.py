"""repro_torch.core — the paper's contribution: the Auptimizer HPO framework.

Public API mirrors the released ``aup`` package:

    from repro_torch.core import BasicConfig, print_result      # job side
    from repro_torch.core import Experiment                     # controller side
"""
from .basic_config import BasicConfig, print_result, parse_result
from .experiment import Experiment
from .job import Job, JobResult, JobStatus
from .search_space import ParamSpec, SearchSpace
from .proposer import available_proposers, get_proposer_cls, make_proposer, Proposer
from .resource import (
    ResourceManager,
    available_resource_managers,
    get_resource_manager_cls,
)
from .tracking import TrackingDB

__all__ = [
    "BasicConfig", "print_result", "parse_result",
    "Experiment", "Job", "JobResult", "JobStatus",
    "ParamSpec", "SearchSpace",
    "Proposer", "available_proposers", "get_proposer_cls", "make_proposer",
    "ResourceManager", "available_resource_managers", "get_resource_manager_cls",
    "TrackingDB",
]
