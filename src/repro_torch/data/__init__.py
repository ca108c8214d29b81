# Seeded synthetic data of the trainers (port of repro/data/): the image
# task of the CNN trainers, the LM token stream and its sharded,
# restart-exact pipeline.
from .pipeline import ShardedDataPipeline
from .synthetic import TokenStream, image_task

__all__ = ["ShardedDataPipeline", "TokenStream", "image_task"]
