"""Multiply-shift hash partitioning with its bucket histogram.

Every key goes to bucket h(v) = the top log2(nbuckets) bits of
(v · seed · MULT) over uint32, and the (nbuckets,) histogram of buckets
comes from the same pass; nbuckets is a power of two (1 puts every key in
bucket 0).  Keys are any integer dtype and hash as their uint32 cast, so
int16 keys sign-extend and int64 keys keep their low 32 bits.

`hash_partition_host` is the plain version (int64 arithmetic masked to 32
bits, one bincount); `hash_partition_cuda` launches
csrc/hash_partition.cu.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import MASK32, int32_bits, mulshift


def _check_nbuckets(nbuckets: int) -> int:
    """log2(nbuckets), or ValueError when it is not a power of two."""
    if nbuckets < 1 or nbuckets & (nbuckets - 1):
        raise ValueError(f"nbuckets={nbuckets} must be a power of two")
    return nbuckets.bit_length() - 1


def hash_partition_host(keys: torch.Tensor, seed: int, nbuckets: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: keys (n,) -> (ids (n,), hist (nbuckets,)) int32."""
    bits = _check_nbuckets(nbuckets)
    keys = int32_bits(keys)
    if bits == 0:
        ids = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    else:
        ids = mulshift(keys, seed & MASK32, bits)
    hist = torch.bincount(ids.reshape(-1).long(), minlength=nbuckets)
    return ids, hist.to(torch.int32)


def hash_partition_cuda(keys: torch.Tensor, seed: int, nbuckets: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/hash_partition.cu on keys (n,) of any integer dtype on
    the card (passed on as their int32 bits)."""
    bits = _check_nbuckets(nbuckets)
    if keys.dim() != 1:
        raise ValueError(f"hash_partition: keys must be (n,), got "
                         f"{tuple(keys.shape)}")
    keys = _build.as_i32(int32_bits(keys), "keys")
    n = keys.shape[0]
    ids = torch.empty(n, dtype=torch.int32, device=keys.device)
    hist = torch.zeros(nbuckets, dtype=torch.int32, device=keys.device)
    if n == 0:
        return ids, hist
    _build.call("hash_partition_launch", keys.data_ptr(), n, seed & MASK32,
                bits, ids.data_ptr(), hist.data_ptr(), _build.stream(keys))
    return ids, hist
