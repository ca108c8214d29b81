"""Paper benchmark: CNN8 conv stack (Table I) + default 512x512 macro."""
from ..core import ArrayConfig, networks

def config():
    return {"layers": networks.cnn8(), "array": ArrayConfig(512, 512)}
