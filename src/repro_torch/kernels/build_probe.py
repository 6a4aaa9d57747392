"""Build/probe primitives: `match_counts` and `first_match` over a hash
table of the build side, and the sort-merge reduce's grouping pass
`segment_scan` / `run_lengths`.

match_counts gives each probe key the number of equal build keys;
first_match the index of the first equal build key, or -1.  Keys are 1-D
and of any integer dtype, compared as int32 (the reference's cast); no
side is padded, so every key value, -1 and -2 included, is data.

segment_scan keys are (B, n, w), sorted lexicographically within each
batch row (one destination); runs never cross a batch row.  Row i starts a
run when it is row 0 or any column differs from the row before.
segment_scan gives each row the dense id of its run (seg) and the run's
first row (start); run_lengths adds the run's length.

`*_host` are the plain versions (chunked equality tiles; cumsum and
cummax); `*_cuda` launch csrc/build_probe.cu.  The match kernels build a
hash table of the build side, one 64-bit word a slot (the key and its
count or least index + 1; the word 0 is an empty slot), homed by
`match_slot` and probed linearly, on the arm `match_plan` picks: while a
table fits MATCH_SHARED_BYTES, one launch (no memset) in which each block
keeps the table of one partition of the keys (`match_partition`) in shared
memory; past it, one table in a device scratch of `slots` words.
The scan is one pass over the keys: each block takes a tile of
`seg_tile_rows(w)` rows, flags its run starts from shared memory, and
carries (run starts so far, last run start) from the earlier tiles by a
decoupled look-back over one status word a tile; run_lengths adds a short
kernel for each tile's trailing run.  Its scratch is (B, tiles), none of
it (B, n).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import MASK32, MULT, int32_bits

# The scan's tile: SEG_TILE_ROWS rows, halved while their words pass
# SEG_TILE_WORDS, down to SEG_MIN_TILE_ROWS (one round of 32 rows for each
# of the block's 8 warps).  csrc/build_probe.cu takes the count as an
# argument and refuses one it cannot run.
SEG_TILE_ROWS = 2048
SEG_MIN_TILE_ROWS = 256
SEG_TILE_WORDS = 8192
# Elements of the plain versions' (probe chunk, n_b) equality tile: 256 MB
# of bools at most.
MATCH_TILE_ELEMS = 1 << 28
# The match kernels' arms and limits (csrc/build_probe.cu mirrors them).
# A table has more slots than build keys, at a load below 0.7: the device
# arm's MATCH_LOAD_DEN * n_b // MATCH_LOAD_NUM + 1, the shared arm's up to
# four a key while a block's table of 8 bytes a slot fits MATCH_SHARED_BYTES
# (blocks share an SM's SM_SHARED_BYTES, 1 KB a block reserved).  The shared
# arm splits the keys into P = 2^pbits partitions by their hash's top bits
# and the probe side into R slices, a block a (partition, slice): each block
# scans the whole build side but inserts only its partition's keys.
MATCH_SHARED, MATCH_DEVICE = 0, 1
MATCH_LOAD_NUM, MATCH_LOAD_DEN = 7, 10
MATCH_SHARED_BYTES = 200 * 1024
MATCH_SHARED_THREADS = 1024
MATCH_DEVICE_THREADS = 256
MATCH_MAX_PART_BITS = 7
SM_COUNT = 132
SM_SHARED_BYTES = 228 * 1024


def _match_keys(probe: torch.Tensor, build: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    if probe.dim() != 1 or build.dim() != 1:
        raise ValueError(f"probe and build must be 1-D, got "
                         f"{tuple(probe.shape)} and {tuple(build.shape)}")
    return int32_bits(probe), int32_bits(build)


def _probe_chunks(probe: torch.Tensor, build: torch.Tensor):
    """(slice, (chunk, n_b) equality tile) over probe chunks, n_b ≥ 1."""
    step = max(1, MATCH_TILE_ELEMS // build.shape[0])
    for i in range(0, probe.shape[0], step):
        yield slice(i, i + step), probe[i:i + step, None] == build[None, :]


def match_counts_host(probe: torch.Tensor, build: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version of `match_counts`: (n_p,) int32 counts."""
    probe, build = _match_keys(probe, build)
    out = torch.zeros(probe.shape[0], dtype=torch.int32, device=probe.device)
    if build.shape[0]:
        for rows, eq in _probe_chunks(probe, build):
            out[rows] = eq.sum(1).to(torch.int32)
    return out


def first_match_host(probe: torch.Tensor, build: torch.Tensor
                     ) -> torch.Tensor:
    """Plain version of `first_match`: (n_p,) int32 index or -1."""
    probe, build = _match_keys(probe, build)
    out = torch.full((probe.shape[0],), -1, dtype=torch.int32,
                     device=probe.device)
    if build.shape[0]:
        for rows, eq in _probe_chunks(probe, build):
            first = eq.to(torch.uint8).argmax(1).to(torch.int32)
            out[rows] = torch.where(eq.any(1), first, -1)
    return out


def _match_hash(keys: torch.Tensor) -> torch.Tensor:
    """uint32(key) * MULT over uint32, as int64."""
    return (keys.to(torch.int64) & MASK32) * MULT & MASK32


def match_partition(keys: torch.Tensor, pbits: int) -> torch.Tensor:
    """A key's partition among 2^pbits: its hash's top pbits bits."""
    return _match_hash(keys) >> (32 - pbits)


def match_slot(keys: torch.Tensor, slots: int, pbits: int = 0
               ) -> torch.Tensor:
    """Home slot of each key in a table of `slots` words: the fast range of
    its hash's bits below the partition's, ((h << pbits) mod 2^32 * slots)
    >> 32, as int64 (csrc/build_probe.cu's match_home)."""
    return ((_match_hash(keys) << pbits & MASK32) * slots) >> 32


def match_plan(n_p: int, n_b: int) -> tuple[int, int, int, int]:
    """(arm, slots, pbits, blocks) of csrc/build_probe.cu's match kernels
    for n_p, n_b >= 1 keys.  The shared arm takes P = 2^pbits partitions,
    the largest power of two up to 32 sqrt(n_b / n_p) and up to n_b (a
    block scans all n_b build keys and inserts n_b / P of them; more
    partitions leave room for fewer probe slices, whose keys each block
    also scans), and as many slices as the SMs hold blocks beside them, or
    one per MATCH_SHARED_THREADS probe keys if that is fewer."""
    slots = MATCH_LOAD_DEN * n_b // MATCH_LOAD_NUM + 1
    if slots >= 2**31:
        raise ValueError(f"build side of {n_b} keys: its table's {slots} "
                         f"slots must fit int32")
    if 8 * slots > MATCH_SHARED_BYTES:
        return (MATCH_DEVICE, slots, 0,
                max(1, min(max(-(-n_b // (4 * MATCH_DEVICE_THREADS)),
                               -(-n_p // MATCH_DEVICE_THREADS)),
                           8 * SM_COUNT)))
    slots = max(slots, min(MATCH_SHARED_BYTES // 8, 4 * n_b))
    fit = SM_COUNT * max(1, min(2048 // MATCH_SHARED_THREADS,
                                SM_SHARED_BYTES // (8 * slots + 1024)))
    pbits = 0
    while (pbits < MATCH_MAX_PART_BITS and 2 << pbits <= min(fit, n_b)
           and (4 << 2 * pbits) * n_p <= 1024 * n_b):
        pbits += 1
    slices = max(1, min(-(-n_p // MATCH_SHARED_THREADS), fit >> pbits))
    return MATCH_SHARED, slots, pbits, slices << pbits


def _match_cuda(name: str, probe: torch.Tensor, build: torch.Tensor,
                fill: int, plan: tuple[int, int, int, int] | None
                ) -> torch.Tensor:
    probe, build = _match_keys(probe, build)
    probe = _build.as_i32(probe, "probe")
    build = _build.as_i32(build, "build")
    n_p, n_b = probe.shape[0], build.shape[0]
    if n_b >= 2**31:
        raise ValueError(f"build side of {n_b} keys: indices must fit int32")
    out = torch.empty(n_p, dtype=torch.int32, device=probe.device)
    if n_p == 0 or n_b == 0:
        return out.fill_(fill)
    arm, slots, pbits, blocks = plan or match_plan(n_p, n_b)
    table = (torch.empty(slots, dtype=torch.int64, device=probe.device)
             if arm == MATCH_DEVICE else None)
    _build.call(name, probe.data_ptr(), n_p, build.data_ptr(), n_b, arm,
                slots, pbits, blocks,
                None if table is None else table.data_ptr(),
                out.data_ptr(), _build.stream(probe))
    return out


def match_counts_cuda(probe: torch.Tensor, build: torch.Tensor, *,
                      plan: tuple[int, int, int, int] | None = None
                      ) -> torch.Tensor:
    """Launch csrc/build_probe.cu's hash join (counts) on `plan` ((arm,
    slots, pbits, blocks); `match_plan`'s by default; the kernel refuses
    one its arms cannot run)."""
    return _match_cuda("match_counts_launch", probe, build, 0, plan)


def first_match_cuda(probe: torch.Tensor, build: torch.Tensor, *,
                     plan: tuple[int, int, int, int] | None = None
                     ) -> torch.Tensor:
    """Launch csrc/build_probe.cu's hash join (first index) on `plan`, as
    match_counts_cuda."""
    return _match_cuda("first_match_launch", probe, build, -1, plan)


def _scan_host(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(seg, start) int64 of keys (B, n, w), n ≥ 1."""
    b, n = keys.shape[:2]
    flags = torch.ones((b, n), dtype=torch.bool, device=keys.device)
    flags[:, 1:] = (keys[:, 1:] != keys[:, :-1]).any(-1)
    seg = torch.cumsum(flags.long(), 1) - 1
    idx = torch.arange(n, device=keys.device).expand(b, n)
    start = torch.cummax(torch.where(flags, idx, -1), 1).values
    return seg, start


def segment_scan_host(keys: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `segment_scan`: (seg (B, n), start (B, n)) int32."""
    if keys.shape[1] == 0:
        z = torch.zeros(keys.shape[:2], dtype=torch.int32, device=keys.device)
        return z, z.clone()
    seg, start = _scan_host(keys)
    return seg.to(torch.int32), start.to(torch.int32)


def run_lengths_host(keys: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `run_lengths`: (seg, start, length), each (B, n)."""
    b, n = keys.shape[:2]
    if n == 0:
        z = torch.zeros((b, 0), dtype=torch.int32, device=keys.device)
        return z, z.clone(), z.clone()
    seg, start = _scan_host(keys)
    flat = (torch.arange(b, device=keys.device)[:, None] * n + seg).reshape(-1)
    length = torch.bincount(flat, minlength=b * n)[flat].reshape(b, n)
    return (seg.to(torch.int32), start.to(torch.int32),
            length.to(torch.int32))


def seg_tile_rows(w: int) -> int:
    """Rows of a scan tile for keys of w columns."""
    rows = SEG_TILE_ROWS
    while rows > SEG_MIN_TILE_ROWS and rows * w > SEG_TILE_WORDS:
        rows //= 2
    return rows


def _scan_cuda(keys: torch.Tensor, with_length: bool) -> tuple:
    keys = _build.as_i32(keys, "keys")
    if keys.dim() != 3:
        raise ValueError(f"segment_scan: keys must be (B, n, w), got "
                         f"{keys.shape}")
    b, n, w = keys.shape
    if n >= 2**31:
        raise ValueError(f"segment_scan: {n} rows a batch row; row indices "
                         f"must fit int32")
    dev = keys.device
    outs = tuple(torch.empty((b, n), dtype=torch.int32, device=dev)
                 for _ in range(3 if with_length else 2))
    if b * n == 0:
        return outs
    tile_rows = seg_tile_rows(w)
    n_tiles = -(-n // tile_rows)
    # One status word a tile, and the tile ticket after them.
    status = torch.empty(b * n_tiles + 1, dtype=torch.int64, device=dev)
    first = (torch.empty((b, n_tiles), dtype=torch.int32, device=dev)
             if with_length else None)
    _build.call("segment_scan_launch", keys.data_ptr(), b, n, w, tile_rows,
                n_tiles, status.data_ptr(),
                first.data_ptr() if with_length else None,
                outs[0].data_ptr(), outs[1].data_ptr(),
                outs[2].data_ptr() if with_length else None,
                _build.stream(keys))
    return outs


def segment_scan_cuda(keys: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/build_probe.cu's scan: (seg, start)."""
    return _scan_cuda(keys, False)


def run_lengths_cuda(keys: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/build_probe.cu's scan with run lengths."""
    return _scan_cuda(keys, True)
