"""repro_torch — the SkewShares join system and its LM scaffold in PyTorch,
with hand-written CUDA kernels for one NVIDIA Hopper GPU.

Layout mirrors the JAX package module for module:

  configs/  architecture configs (plain dataclasses) and their registry
  core/     planner (numpy: plan, heavy hitters, residuals, Shares,
            placement, reference join), the executor (prepare -> map ->
            exchange -> hash or sort-merge join cascade) and the MoE
            dispatch planner (`moe_shares`)
  data/     synthetic skewed workloads
  kernels/  the fourteen kernels, one for each TPU kernel of the
            reference, and the hash reduce's chained probe, which the
            reference leaves to XLA: CUDA sources in `csrc/`, their
            plain PyTorch versions beside each wrapper, the dispatch and
            launch counts in `ops.py` and the build in `_build.py`
  models/   the MoE transformer (mixtral-8x22b, kimi-k2) and its layers
  serve/    serve steps and the continuous-batching `ServingEngine`

One GPU stands for n_dev servers: n_dev is a leading tensor axis (source
shards in the map, destinations in the reduce) and the all-to-all exchange
is a transpose.  Entry points run on the card unless the caller passes
`device="cpu"`; there is no silent CPU fallback.
"""
from . import configs, core, data, kernels, models, serve

__all__ = ["configs", "core", "data", "kernels", "models", "serve"]
