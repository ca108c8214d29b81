"""Compiled execution plans (port of ``repro.exec``, CNN chains).

    from repro_torch.exec import compile_plan, execute_plan
    plan = compile_plan(net_mapping, executor_policy="auto", batch=8)
    y = execute_plan(plan, kernels, x)
"""
from .glue import (ACTIVATIONS, GLUE_KINDS, GlueSpec, center_crop,
                   fit_spatial, resolve_chain)
from .memory import LayerMemory, network_memory, peak_bytes, total_bytes
from .plan import (EXECUTORS, PASSES, LayerPlan, NetworkPlan, PlanDraft,
                   PolicyLike, compile_plan)
from .remat import allowed_cuts, canonical_remat, plan_segments
from .run import execute_looped, execute_oracle, execute_plan

__all__ = [
    "ACTIVATIONS", "GLUE_KINDS", "GlueSpec", "EXECUTORS", "LayerMemory",
    "LayerPlan", "NetworkPlan", "PASSES", "PlanDraft", "PolicyLike",
    "allowed_cuts", "canonical_remat", "center_crop", "compile_plan",
    "execute_looped", "execute_oracle", "execute_plan", "fit_spatial",
    "network_memory", "peak_bytes", "plan_segments", "resolve_chain",
    "total_bytes",
]
