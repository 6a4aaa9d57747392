"""Dispatch of the ported kernels, with launch counts.

Fifteen kernels: one for each TPU kernel of the reference package, and
`probe_tables`, the hash reduce's chained probe, which the reference
leaves to XLA: the join main path's `map_count`, `scatter_pack`,
`join_hash`, `build_table`, `probe_tables` and `expand_rows`; the staged
map's `route_cells`, `fold_cells` and `bucket_pack` (`fuse_map=False`);
the sort-merge reduce's `segment_scan`
(`hash_reduce=False`; `run_lengths` is the same kernel with run lengths,
and counts under `segment_scan`); the kernel library's `map_pack`,
`hash_partition`, `match_counts` and `first_match`, which the executor
does not call; and `segment_histogram`, the MoE layer's expert loads
(`models/moe.py`).

A wrapper given CUDA tensors launches its hand-written kernel (raising
`_build.KernelError` if the build or the launch fails); given CPU tensors it
runs the kernel's plain PyTorch version.  `use_kernels=False` selects the
plain version on any device (the executor's knob of the same name).  There
is no fallback from a failed kernel to the plain version.

`LAUNCHES[name]` counts the kernel launches of each wrapper, and only those
(`_build.call` adds one per successful launch; an empty input launches
nothing): a run shows that it went through the kernels when its counts are
> 0.
"""
from __future__ import annotations

import torch

from . import bucket_pack as bp
from . import build_probe as bpr
from . import hash_partition as hp
from . import join_probe as jp
from . import map_pack as mp
from . import route_cells as rc
from . import scatter_pack as sp
from . import segment_histogram as sh
from ._build import LAUNCHES

KERNELS = tuple(LAUNCHES)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _on_card(t: torch.Tensor, use_kernels: bool) -> bool:
    """True: launch the kernel; False: run the plain version."""
    if t.device.type == "cuda":
        return use_kernels
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device} (cuda or cpu)")


def map_count(rows: torch.Tensor, routes, k: int, n_src: int, *,
              use_kernels: bool = True) -> torch.Tensor:
    """(n_src, k) routed copies per (source shard, wrapped cell)."""
    if _on_card(rows, use_kernels):
        return mp.map_count_cuda(rows, routes, k, n_src)
    return mp.map_count_host(rows, routes, k, n_src)


def scatter_pack(rows: torch.Tensor, routes, ptable: torch.Tensor, k: int,
                 n_dev: int, cap: int, *, use_kernels: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Map phase per source: (buf (n_src, n_dev, cap, w+1), overflow)."""
    if _on_card(rows, use_kernels):
        return sp.scatter_pack_cuda(rows, routes, ptable, k, n_dev, cap)
    return sp.scatter_pack_host(rows, routes, ptable, k, n_dev, cap)


def join_hash(keys: torch.Tensor, valid: torch.Tensor, n_bits: int, *,
              use_kernels: bool = True) -> torch.Tensor:
    """(B, n) bucket per row; invalid rows -> 2^n_bits."""
    if _on_card(keys, use_kernels):
        return jp.join_hash_cuda(keys, valid, n_bits)
    return jp.join_hash_host(keys, valid, n_bits)


def build_table(keys: torch.Tensor, valid: torch.Tensor, n_bits: int, *,
                use_kernels: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(bucket, stable rank within bucket, (B, P) histogram)."""
    if _on_card(keys, use_kernels):
        return jp.build_table_cuda(keys, valid, n_bits)
    return jp.build_table_host(keys, valid, n_bits)


def probe_tables(lk: torch.Tensor, l_bkt: torch.Tensor, rk: torch.Tensor,
                 r_bkt: torch.Tensor, rank: torch.Tensor, hist: torch.Tensor,
                 n_bits: int, *, use_kernels: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(counts, lo, perm): each left row's matches are perm[lo, lo +
    counts), every exact-key group of the right side contiguous."""
    if _on_card(lk, use_kernels):
        return jp.probe_tables_cuda(lk, l_bkt, rk, r_bkt, rank, hist, n_bits)
    return jp.probe_tables_host(lk, l_bkt, rk, r_bkt, rank, hist, n_bits)


def expand_rows(left: torch.Tensor, right: torch.Tensor, counts: torch.Tensor,
                lo: torch.Tensor, perm: torch.Tensor, cap: int, *, cols=None,
                use_kernels: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefix-sum expansion of a probe: (out (B, cap, wl+wr), valid); with
    `cols` (indices into left ++ right), out (B, cap, len(cols)) holds those
    columns of the valid rows and -1 elsewhere."""
    if _on_card(left, use_kernels):
        return sp.expand_rows_cuda(left, right, counts, lo, perm, cap, cols)
    return sp.expand_rows_host(left, right, counts, lo, perm, cap, cols)


def route_cells(rows: torch.Tensor, recipe, *, use_kernels: bool = True,
                desc: torch.Tensor | None = None) -> torch.Tensor:
    """(n,) hypercube base cell of rows (n, w); `desc`, the kernel's
    descriptor of `recipe` on the card, if the caller holds it."""
    if _on_card(rows, use_kernels):
        return rc.route_cells_cuda(rows, recipe, desc)
    return rc.route_cells_host(rows, recipe)


def fold_cells(dest: torch.Tensor, table: torch.Tensor, *,
               use_kernels: bool = True) -> torch.Tensor:
    """table[dest], -1 kept (dest past the table -> 0)."""
    if _on_card(dest, use_kernels):
        return rc.fold_cells_cuda(dest, table)
    return rc.fold_cells_host(dest, table)


def bucket_pack(dest: torch.Tensor, rows: torch.Tensor, k: int, cap: int, *,
                use_kernels: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable pack per batch row: (buf (B, k, cap, w), overflow (B,))."""
    if _on_card(dest, use_kernels):
        return bp.bucket_pack_cuda(dest, rows, k, cap)
    return bp.bucket_pack_host(dest, rows, k, cap)


def segment_scan(keys: torch.Tensor, *, use_kernels: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(seg, start) over sorted keys (B, n, w)."""
    if _on_card(keys, use_kernels):
        return bpr.segment_scan_cuda(keys)
    return bpr.segment_scan_host(keys)


def run_lengths(keys: torch.Tensor, *, use_kernels: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(seg, start, run length) over sorted keys (B, n, w)."""
    if _on_card(keys, use_kernels):
        return bpr.run_lengths_cuda(keys)
    return bpr.run_lengths_host(keys)


def map_pack(rows: torch.Tensor, routes, ptable: torch.Tensor, k: int,
             n_dev: int, cap: int, *, use_kernels: bool = True
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Map phase per source from per-copy streams: (buf (n_src, n_dev, cap,
    w+1), overflow (n_src,)), equal to `scatter_pack`'s."""
    if _on_card(rows, use_kernels):
        return mp.map_pack_cuda(rows, routes, ptable, k, n_dev, cap)
    return mp.map_pack_host(rows, routes, ptable, k, n_dev, cap)


def hash_partition(keys: torch.Tensor, seed: int, nbuckets: int, *,
                   use_kernels: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(bucket ids (n,), histogram (nbuckets,)) of multiply-shift hashes."""
    if _on_card(keys, use_kernels):
        return hp.hash_partition_cuda(keys, seed, nbuckets)
    return hp.hash_partition_host(keys, seed, nbuckets)


def match_counts(probe: torch.Tensor, build: torch.Tensor, *,
                 use_kernels: bool = True) -> torch.Tensor:
    """(n_p,) number of equal build keys per probe key."""
    if _on_card(probe, use_kernels):
        return bpr.match_counts_cuda(probe, build)
    return bpr.match_counts_host(probe, build)


def first_match(probe: torch.Tensor, build: torch.Tensor, *,
                use_kernels: bool = True) -> torch.Tensor:
    """(n_p,) index of the first equal build key per probe key, or -1."""
    if _on_card(probe, use_kernels):
        return bpr.first_match_cuda(probe, build)
    return bpr.first_match_host(probe, build)


def segment_histogram(values: torch.Tensor, n_bins: int, *,
                      use_kernels: bool = True) -> torch.Tensor:
    """int32 (n_bins,) count of the (integer) values in [0, n_bins)."""
    if _on_card(values, use_kernels):
        return sh.segment_histogram_cuda(values, n_bins)
    return sh.segment_histogram_host(values, n_bins)
