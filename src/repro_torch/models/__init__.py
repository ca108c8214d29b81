# The model code of the port: config.py (the architecture dataclasses the
# transformer lowering of launch/transformer.py reads, and param_count),
# common.py, attention.py and ssm.py (primitives, the attention family
# with its KV caches, and the Mamba-2 SSD mixer), transformer.py (init
# and the train/prefill/decode forward of the gqa and ssd families) and
# weights.py (the JAX package's params carried across).
from . import transformer
from .config import ArchConfig, BlockSpec, MoEConfig, Stage
from .ssm import SSMConfig
from .weights import params_from_numpy

__all__ = ["ArchConfig", "BlockSpec", "MoEConfig", "SSMConfig", "Stage",
           "params_from_numpy", "transformer"]
