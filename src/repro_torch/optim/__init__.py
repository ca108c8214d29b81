# Optimizer of the trainers (port of repro/optim/).
# adamw.py        AdamW with f32 state over dict/list trees of tensors
# schedule.py     learning-rate schedules
# compression.py  int8 error-feedback gradient compression
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, tree_leaves, tree_map,
                    tree_unflatten)
from .compression import (compress_int8, compress_pytree, decompress_int8,
                          ef_compress_update)
from .schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compress_int8", "compress_pytree",
           "cosine_schedule", "decompress_int8", "ef_compress_update",
           "tree_leaves", "tree_map", "tree_unflatten"]
