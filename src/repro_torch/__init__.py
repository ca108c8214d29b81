"""PyTorch/CUDA port of the TetrisG-SDK reproduction.

Sits beside the JAX package ``repro`` and keeps its module layout, so
each module here has a counterpart of the same name there.  The port
imports ``torch`` and nothing of JAX or of ``repro``; the mapping
search under :mod:`repro_torch.core` is its own copy.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).
"""
