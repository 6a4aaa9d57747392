"""Bounded-domain frequency histogram: the MoE layer's expert loads.

`segment_histogram(values, n_bins)` is the int32 (n_bins,) count of the
values in [0, n_bins); other values (padding, tombstones) are dropped.
Values are any integer dtype, cast to int32 and flattened, as the
reference's `_flatten_pad` does.  An empty input gives zeros (the
reference's Pallas kernel raises on one; its oracle gives zeros).

`segment_histogram_host` is the plain version (a mask, then one bincount);
`segment_histogram_cuda` launches csrc/segment_histogram.cu.
"""
from __future__ import annotations

import torch

from . import _build


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


def segment_histogram_cuda(values: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Launch csrc/segment_histogram.cu on values of any integer dtype on the
    card; an empty input launches nothing."""
    v = _build.as_i32(_values(values, n_bins), "values")
    hist = torch.empty(n_bins, dtype=torch.int32, device=v.device)
    if v.numel() == 0:
        return hist.zero_()
    _build.call("segment_histogram_launch", v.data_ptr(), v.numel(), n_bins,
                hist.data_ptr(), _build.stream(v))
    return hist
