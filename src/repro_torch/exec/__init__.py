"""Compiled execution plans (port of ``repro.exec``): CNN chains and
transformer lowerings with explicit glue.

    from repro_torch.exec import compile_plan, execute_plan
    plan = compile_plan(net_mapping, executor_policy="auto",
                        mesh=mesh, batch=8)
    y = execute_plan(plan, kernels, x, mesh=mesh)

``mesh`` is None or a `repro_torch.launch.mesh.Mesh`
(`launch.mesh.serving_mesh_for`).
"""
from .constants import PlanConstants, constant_counts, prepare_constants
from .glue import (ACTIVATIONS, GLUE_KINDS, GlueSpec, attention_stage,
                   center_crop, fit_spatial, layernorm, resolve_chain)
from .memory import LayerMemory, network_memory, peak_bytes, total_bytes
from .plan import (EXECUTORS, PASSES, LayerPlan, NetworkPlan, PlanDraft,
                   PolicyLike, compile_counts, compile_plan)
from .remat import allowed_cuts, canonical_remat, plan_segments
from .run import (apply_layer, donation_supported, execute_layerwise,
                  execute_looped, execute_oracle, execute_plan)

__all__ = [
    "ACTIVATIONS", "GLUE_KINDS", "GlueSpec", "EXECUTORS", "LayerMemory",
    "LayerPlan", "NetworkPlan", "PASSES", "PlanConstants", "PlanDraft",
    "PolicyLike",
    "allowed_cuts", "apply_layer", "attention_stage", "canonical_remat",
    "center_crop", "compile_counts", "compile_plan", "constant_counts",
    "donation_supported",
    "execute_layerwise", "execute_looped", "execute_oracle", "execute_plan",
    "fit_spatial", "layernorm", "network_memory", "peak_bytes",
    "plan_segments", "prepare_constants", "resolve_chain", "total_bytes",
]
