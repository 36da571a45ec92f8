"""Sharding plans (counterpart of ``repro.sharding``): the ``Plan`` record
so far; the rules, estimator and plan optimizer come with SPMD sharding
(ROADMAP Queue 1 item 7)."""
from .plans import Plan, activation_rules

__all__ = ["Plan", "activation_rules"]
