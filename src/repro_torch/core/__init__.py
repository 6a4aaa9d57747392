"""repro_torch.core — planner (numpy) and the executor main path (torch).

  plan, dominance, cost, shares, residual, heavy_hitters, hypercube,
  skewjoin, placement, reference — the SkewShares planner and the numpy
  join oracle, numpy as in the reference package
  executor — prepare -> map -> exchange -> hash-join cascade on the
  n_dev-leading tensor layout (see executor.py)
"""
from .cost import (CostExpression, CostTerm, cost_expression, naive_hh_cost,
                   shares_hh_cost, shares_hh_splits)
from .dominance import dominated_attributes, dominates, free_share_attributes
from .heavy_hitters import HHSet, MisraGries, exact_heavy_hitters
from .hypercube import Hypercube, hash_seed, multiply_shift
from .placement import (CellPlacement, lpt_placement, modulo_placement,
                        place_cells, placement_gain)
from .plan import JoinQuery, Relation, running_example, triangle, two_way
from .reference import canonical, reference_join
from .residual import (ORDINARY, ResidualJoin, TypeCombination, decompose,
                       enumerate_combinations, residual_sizes, tuple_mask)
from .shares import (SharesSolution, brute_force_shares, optimize_shares,
                     optimize_shares_expr, round_pow2, solve_continuous)
from .skewjoin import (ResidualPlan, SkewJoinPlan, naive_two_way_cost,
                       plan_from_hhs, plan_no_skew, plan_skew_join)

__all__ = [
    "CostExpression", "CostTerm", "cost_expression", "naive_hh_cost",
    "shares_hh_cost", "shares_hh_splits", "dominated_attributes", "dominates",
    "free_share_attributes", "HHSet", "MisraGries", "exact_heavy_hitters",
    "Hypercube", "hash_seed", "multiply_shift", "CellPlacement",
    "lpt_placement", "modulo_placement", "place_cells", "placement_gain",
    "JoinQuery", "Relation",
    "running_example", "triangle", "two_way", "canonical", "reference_join",
    "ORDINARY", "ResidualJoin", "TypeCombination", "decompose",
    "enumerate_combinations", "residual_sizes", "tuple_mask", "SharesSolution",
    "brute_force_shares", "optimize_shares", "optimize_shares_expr",
    "round_pow2", "solve_continuous", "ResidualPlan", "SkewJoinPlan",
    "naive_two_way_cost", "plan_from_hhs", "plan_no_skew", "plan_skew_join",
]
