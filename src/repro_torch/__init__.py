"""repro_torch — the SkewShares join system and its LM scaffold in PyTorch,
with hand-written CUDA kernels for one NVIDIA Hopper GPU.

Layout mirrors the JAX package module for module:

  configs/  architecture configs (plain dataclasses) and their registry
  core/     planner (numpy: plan, heavy hitters, residuals, Shares,
            placement, reference join), the executor (prepare -> map ->
            exchange -> hash or sort-merge join cascade) and the MoE
            dispatch planner (`moe_shares`)
  data/     synthetic skewed workloads and the token pipeline
  kernels/  the fourteen kernels, one for each TPU kernel of the
            reference, and the hash reduce's chained probe, which the
            reference leaves to XLA: CUDA sources in `csrc/`, their
            plain PyTorch versions beside each wrapper, the dispatch and
            launch counts in `ops.py` and the build in `_build.py`
  models/   the six model families (dense, MoE, SSM, hybrid, enc-dec,
            VLM) of the ten registered architectures, and their layers
  serve/    serve steps and the continuous-batching `ServingEngine`
  optim/    AdamW (float32 or 8-bit states), the LR schedule, gradient
            compression
  train/    the train step (loss, microbatches, optimizer)
  ckpt/     checkpoints in the reference package's on-disk format
  ft/       health, stragglers, chaos, elastic re-meshing
  launch/   the training driver (`python -m repro_torch.launch.train`)

One GPU stands for n_dev servers: n_dev is a leading tensor axis (source
shards in the map, destinations in the reduce) and the all-to-all exchange
is a transpose.  Entry points run on the card unless the caller passes
`device="cpu"`; there is no silent CPU fallback.
"""
from . import (ckpt, configs, core, data, ft, kernels, models, optim, serve,
               train)

__all__ = ["ckpt", "configs", "core", "data", "ft", "kernels", "models",
           "optim", "serve", "train"]
