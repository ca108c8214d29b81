"""The plain reference: what a configuration computes, in plain
PyTorch, from the configuration file alone.

It imports nothing of the program.  It works the groups and the channels
each tile keeps out of the configuration's ``pins`` again, takes the
benchmark's own weights and inputs (never anything the program made)
and runs in f32 with TF32 off; ``precision="tf32"`` runs the same with
every product's operands rounded to TF32, the control that has to come
out as not correct.

    y = forward(cfg, traffic, kernels, x)            # f32
    y = forward(cfg, traffic, kernels, x, precision="tf32")
"""
from __future__ import annotations

from . import cnn, transformer

_FORWARDS = {"cnn": cnn.forward, "transformer": transformer.forward}


def forward(cfg: dict, traffic: dict, kernels, x, *,
            precision: str = "f32"):
    """The configuration's forward on ``x`` with ``kernels`` (one per
    mapped layer, grouped HWIO ``(k_h, k_w, ic // G, oc)``)."""
    try:
        fn = _FORWARDS[cfg["kind"]]
    except KeyError:
        raise ValueError(f"{cfg['name']}: no reference for kind "
                         f"{cfg['kind']!r}") from None
    return fn(cfg, traffic, kernels, x, precision=precision)
