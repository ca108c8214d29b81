"""Paper benchmark: DenseNet-40 (k=12) conv stack."""
from ..core import ArrayConfig, networks

def config():
    return {"layers": networks.densenet40(), "array": ArrayConfig(512, 512)}
