# Checkpoints of the train state (port of repro/checkpoint/), in the JAX
# package's format: a checkpoint written by either package restores in
# the other.
from .store import (CheckpointStore, latest_step, restore_checkpoint,
                    save_checkpoint)

__all__ = ["CheckpointStore", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
