# The model code of the port: config.py (the architecture dataclasses the
# transformer lowering of launch/transformer.py reads, and param_count),
# common.py, attention.py, moe.py, rglru.py and ssm.py (primitives, the
# attention family with its KV caches, Mixture-of-Experts routing, the
# RG-LRU recurrence and the Mamba-2 SSD mixer), transformer.py (init and
# the train/prefill/decode/encode forward of every block and kind of the
# reference) and weights.py (the JAX package's params carried across).
from . import transformer
from .config import ArchConfig, BlockSpec, MoEConfig, Stage
from .ssm import SSMConfig
from .weights import params_from_numpy

__all__ = ["ArchConfig", "BlockSpec", "MoEConfig", "SSMConfig", "Stage",
           "params_from_numpy", "transformer"]
