# Optimizer of the trainers (port of repro/optim/adamw.py and schedule.py).
# adamw.py     AdamW with f32 state over dict/list trees of tensors
# schedule.py  learning-rate schedules
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, tree_leaves, tree_map,
                    tree_unflatten)
from .schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule", "tree_leaves",
           "tree_map", "tree_unflatten"]
