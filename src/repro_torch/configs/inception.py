"""Paper benchmark: GoogLeNet Inception 5x5 branches (Table I)."""
from ..core import ArrayConfig, networks

def config():
    return {"layers": networks.inception(), "array": ArrayConfig(512, 512)}
