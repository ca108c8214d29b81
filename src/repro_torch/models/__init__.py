# Model configuration data of the port (the model code itself is not
# ported yet): config.py holds the dataclasses the transformer lowering
# (launch/transformer.py) reads.
from .config import ArchConfig, BlockSpec, MoEConfig, SSMConfig, Stage

__all__ = ["ArchConfig", "BlockSpec", "MoEConfig", "SSMConfig", "Stage"]
