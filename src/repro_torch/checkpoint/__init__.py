from .checkpointer import Checkpointer, LaneSnapshotStore
