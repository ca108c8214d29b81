"""Paper benchmark: MobileNetV1 depthwise-separable stack (SIV-C3)."""
from ..core import ArrayConfig, networks

def config():
    return {"layers": networks.mobilenet(), "array": ArrayConfig(512, 512)}
