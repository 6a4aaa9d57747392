"""Synthetic skewed join workloads (numpy, seeded)."""
from .synthetic import (chain_query, drifting_join_batch, skewed_join_dataset,
                        skewed_relation, zipf_column)

__all__ = ["chain_query", "drifting_join_batch", "skewed_join_dataset",
           "skewed_relation", "zipf_column"]
