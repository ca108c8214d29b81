"""CIM macro-grid specs (port of ``macro_pass_specs`` and
``macro_mesh_fits`` of ``repro/launch/sharding.py``).

A spec names, for each leading dimension of an operand, the mesh axis
that splits it — the torch form of the JAX package's
``PartitionSpec``.  The parameter, cache, optimizer and batch specs of
the LM production mesh are not ported here.
"""
from __future__ import annotations

from typing import Optional, Tuple

Spec = Tuple[str, ...]


def macro_pass_specs(mesh=None) -> Tuple[Spec, Spec, Spec]:
    """(patch, weight, out) specs of one macro-grid super-step of the
    mapped executor on a ("row", "col") — or ("data", "row", "col") —
    mesh (`launch.mesh.make_macro_mesh`).

    The operands of ``mapped_net._macro_step`` lead with the macro axes:
    patches (sub_r, b, ...) split over "row" (each macro row holds one
    channel-pass block), weights (sub_r, sub_c, ...) over both macro
    axes (each macro holds its own ic_t x oc_t block), and the output
    (sub_c, b, ...) over "col" after the cross-row partial-sum
    reduction.  With a "data" axis the batch dimension of the patches
    and the output also splits over it; the weights are replicated
    across "data" and the reduction stays over "row"."""
    if mesh is not None and "data" in mesh.axis_names:
        return ("row", "data"), ("row", "col"), ("col", "data")
    return ("row",), ("row", "col"), ("col",)


def macro_mesh_fits(mesh, sub_r: int, sub_c: int,
                    batch: Optional[int] = None) -> bool:
    """The mesh axes must divide the macro axes — and, on a mesh with a
    "data" axis, the batch must divide that axis."""
    if (mesh is None
            or sub_r % mesh.shape["row"]
            or sub_c % mesh.shape["col"]):
        return False
    if "data" in mesh.axis_names:
        return batch is not None and batch % mesh.shape["data"] == 0
    return True
