"""Bounded-domain frequency histogram: the MoE layer's expert loads.

`segment_histogram(values, n_bins)` is the int32 (n_bins,) count of the
values in [0, n_bins); other values (padding, tombstones) are dropped.
Values are any integer dtype, cast to int32 and flattened, as the
reference's `_flatten_pad` does.  An empty input gives zeros (the
reference's Pallas kernel raises on one; its oracle gives zeros).

`segment_histogram_host` is the plain version (a mask, then one bincount);
`segment_histogram_cuda` launches csrc/segment_histogram.cu on the arm that
`histogram_plan` picks: one block (a handful of values: one launch, no
memset), a grid of blocks (many values), a thread-block cluster whose blocks
share the bins (bins past one block's shared memory; sm_90), or device
atomics (bins past a cluster's shared memory).
"""
from __future__ import annotations

import torch

from . import _build

# The arms of csrc/segment_histogram.cu and its limits (mirrored here).
SH_ONE, SH_GRID, SH_CLUSTER, SH_GLOBAL = range(4)
SHARED_BINS = 12288             # one block's counters (48 KB)
CLUSTER_BLOCKS = 8              # blocks a cluster (the portable size)
CLUSTER_BLOCK_BINS = 1 << 15    # a cluster block's bins (a power of two)
# One block takes up to this many values (16 a thread); on an H100 it beat
# the grid's memset and launch at every size up to it, at 8 and 384 bins
# (scripts/time_histogram_arms.py).
ONE_BLOCK_VALUES = 1 << 14
GRID_THREADS = 256
MAX_GRID_BLOCKS = 132 * 8
# The cluster arm: 512 threads a block (two blocks an SM); a cluster per
# n_bins values, since its second pass sums clusters x n_bins partial
# counts, and at most MAX_CLUSTERS (the best on an H100 at 2^22 and 2^24
# values in 2^16 bins; scripts/time_histogram_arms.py).
CLUSTER_THREADS = 512
MAX_CLUSTERS = 24


def histogram_plan(n: int, n_bins: int) -> tuple[int, int, int]:
    """(arm, blocks, threads) of csrc/segment_histogram.cu for n >= 1
    values in n_bins bins."""
    if n_bins <= SHARED_BINS:
        if n <= ONE_BLOCK_VALUES:
            return SH_ONE, 1, min(1024, 32 * -(-n // 128))
        per_block = max(4 * n_bins, 8 * GRID_THREADS)
        return (SH_GRID, max(1, min(-(-n // per_block), MAX_GRID_BLOCKS)),
                GRID_THREADS)
    if n_bins <= CLUSTER_BLOCKS * CLUSTER_BLOCK_BINS:
        # Past 2^17 bins a block's counters leave room for one block an SM,
        # so half as many clusters run at once.
        most = MAX_CLUSTERS if n_bins <= 1 << 17 else MAX_CLUSTERS // 2
        clusters = max(1, min(n // n_bins, most))
        return SH_CLUSTER, clusters * CLUSTER_BLOCKS, CLUSTER_THREADS
    return (SH_GLOBAL, max(1, min(-(-n // (8 * GRID_THREADS)),
                                  MAX_GRID_BLOCKS)), GRID_THREADS)


def _values(values: torch.Tensor, n_bins: int) -> torch.Tensor:
    """values flattened as int32, or raise on what the histogram does not
    take (n_bins < 1, a non-integer dtype)."""
    if n_bins < 1:
        raise ValueError(f"n_bins={n_bins} must be at least 1")
    if values.dtype.is_floating_point or values.dtype.is_complex \
            or values.dtype == torch.bool:
        raise TypeError(f"segment_histogram: expected integer values, got "
                        f"{values.dtype}")
    return values.reshape(-1).to(torch.int32)


def segment_histogram_host(values: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Plain version: int32 (n_bins,) count of the values in [0, n_bins)."""
    v = _values(values, n_bins)
    v = v[(v >= 0) & (v < n_bins)]
    return torch.bincount(v.long(), minlength=n_bins).to(torch.int32)


def segment_histogram_cuda(values: torch.Tensor, n_bins: int, *,
                           plan: tuple[int, int, int] | None = None
                           ) -> torch.Tensor:
    """Launch csrc/segment_histogram.cu on values of any integer dtype on the
    card, on `plan` ((arm, blocks, threads); `histogram_plan`'s by default;
    the kernel refuses one its arm does not take); an empty input launches
    nothing."""
    v = _build.as_i32(_values(values, n_bins), "values")
    hist = torch.empty(n_bins, dtype=torch.int32, device=v.device)
    if v.numel() == 0:
        return hist.zero_()
    arm, blocks, threads = plan or histogram_plan(v.numel(), n_bins)
    partial = None
    if arm == SH_CLUSTER and blocks > CLUSTER_BLOCKS:   # each cluster's counts
        partial = torch.empty((blocks // CLUSTER_BLOCKS, n_bins),
                              dtype=torch.int32, device=v.device)
    _build.call("segment_histogram_launch", v.data_ptr(), v.numel(), n_bins,
                arm, blocks, threads, hist.data_ptr(),
                None if partial is None else partial.data_ptr(),
                _build.stream(v))
    return hist
