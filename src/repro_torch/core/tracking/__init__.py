from .database import TrackingDB
from .visualizer import best_so_far, summarize_experiment, hyperparameter_table

__all__ = ["TrackingDB", "best_so_far", "summarize_experiment", "hyperparameter_table"]
