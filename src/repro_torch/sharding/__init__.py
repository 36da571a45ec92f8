"""LSHS as a sharding optimizer (counterpart of ``repro.sharding``): plans,
the load estimator and plan optimizer, the roofline, the collective counter,
all against a named device table (``hardware.H100_SXM``)."""
from .collectives import CollectiveCounter
from .estimator import LoadEstimate, estimate, local_param_numel
from .hardware import H100_SXM, Hardware
from .optimizer import PlanChoice, choose_plan
from .plans import (SINGLE_CARD, Plan, activation_rules, batch_specs, cache_spec_tree,
                    candidate_plans, param_sharding_tree, param_spec_tree, shard_tree)

__all__ = ["CollectiveCounter", "H100_SXM", "Hardware", "LoadEstimate", "Plan", "PlanChoice",
           "SINGLE_CARD", "activation_rules", "batch_specs", "cache_spec_tree",
           "candidate_plans", "choose_plan", "estimate", "local_param_numel",
           "param_sharding_tree", "param_spec_tree", "shard_tree"]
