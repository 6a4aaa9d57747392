"""repro_torch — the SkewShares join system in PyTorch, with hand-written CUDA
kernels for one NVIDIA Hopper GPU.

Layout mirrors the JAX package module for module:

  core/     planner (numpy: plan, heavy hitters, residuals, Shares,
            placement, reference join) and the executor main path
            (prepare -> map -> exchange -> hash-join cascade)
  data/     synthetic skewed workloads
  kernels/  the five main-path kernels: CUDA sources in `csrc/`, their
            plain PyTorch versions beside each wrapper, the dispatch in
            `ops.py` and the build in `_build.py`

One GPU stands for n_dev servers: n_dev is a leading tensor axis (source
shards in the map, destinations in the reduce) and the all-to-all exchange
is a transpose.  Entry points run on the card unless the caller passes
`device="cpu"`; there is no silent CPU fallback.
"""
