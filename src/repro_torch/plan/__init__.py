"""Pinned per-layer and per-network execution plans."""
from .deconv_plan import (PLAN_SCHEMA_VERSION, DeconvPlan, PlanSchemaError,
                          build_layer_plan)
from .network_plan import (NetworkPlan, build_network_plan,
                           executable_fingerprints, variant_fingerprints)

__all__ = ["PLAN_SCHEMA_VERSION", "DeconvPlan", "NetworkPlan",
           "PlanSchemaError", "build_layer_plan", "build_network_plan",
           "executable_fingerprints", "variant_fingerprints"]
