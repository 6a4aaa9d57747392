"""SkewShares execution: prepare -> map -> exchange -> reduce.

n_dev logical servers run in one process or over a mesh of ranks.  In one
process n_dev is a leading tensor axis:

  shard     a relation padded with -1 rows to a multiple of n_dev; source
            shard i is rows [i·n/n_dev, (i+1)·n/n_dev), viewed as
            (n_dev, n/n_dev, w)
  prepare   one counting pass (`map_count`, (n_src, k) routed copies per
            source and wrapped logical cell) drives LPT cell placement and
            the per-relation shuffle capacities
  map       `scatter_pack` over all sources at once: route, fold through the
            (k,) placement table, stable rank, write
            (n_src, n_dst, cap, w+1) send buffers (overflow per source)
  exchange  the all-to-all is a transpose: (n_src, n_dst, cap, w+1) ->
            (n_dst, n_src·cap, w+1), fragments in source order
  reduce    `_local_join` over all destinations at once: per cascade step
            `join_hash` (left), `build_table` (right), `probe_tables`,
            `expand_rows`, matching only within equal logical cell ids

Over a mesh (`mesh=`, a 1-D DeviceMesh of W ranks from
`launch.mesh.make_join_mesh`, W dividing n_dev) rank r owns the logical
devices [r·L, (r+1)·L), L = n_dev / W, as its leading tensor axis.  Every
rank is given the same relations (SPMD) and uploads the rows of its own L
sources.  The count pass counts (L, k) and one `all_gather` makes the
(n_dev, k) matrices on every rank, so placement and caps agree everywhere.
The exchange is one `all_to_all_single` over the mesh's group (one a chunk
under the chunked exchange, each started before the next chunk packs):
fragments arrive in global source order, bit-equal to the transpose's.
Each rank reduces its L destinations and keeps its rows; one small
`all_gather` inside the step gives every rank the global overflow and
receive counters, so retry and `stats` decide alike with no collective of
their own.  Every rank must call the same session methods in the same
order; `result_rows` gathers every rank's valid rows on every rank.

Every routed copy carries its UNWRAPPED logical cell id as a hidden last
column, so cells sharing a device never produce cross-cell matches and the
placement moves load, never correctness.  The placement table is a runtime
argument of a step: re-placing never builds a new step.  Steps are cached on
(shapes, caps, cap_out), with the `compile_count`, `step_hits` and
`evicted_steps` counters of the reference ("compile" = build a step).

Both oracle arms of the reference run here too.  `fuse_map=False` is the
staged map: `_route_relation` (`route_cells` per route, replication and
membership as torch ops, the (n_src, n_loc·F, w+1) tagged copies made),
`_fold_dests` (`fold_cells`) and `_pack_buckets` (`bucket_pack`);
`hash_reduce=False` is the sort-merge reduce: `_lexsort_rows` (torch's
stable sorts), `_group_ids` (`segment_scan`) and `_probe_sort`
(`run_lengths`, `searchsorted`).  Every arm gives the same bits.

`overlap_shuffle = C ≥ 2` is the chunked exchange: each source's rows,
padded with -1 to C·tile (tile = ⌈n_loc/C⌉), are packed a chunk of tile
rows at a time with per-chunk caps, and each chunk's send buffer is copied
into its slice of the fragments while the next chunk packs (a second CUDA
stream on the card); fragments arrive chunk-major, then source-major, as
the reference's concatenated all_to_alls do.  `use_kernels=False` runs the
kernels' plain versions on the same device.  Entry points take `device=`
and default to the card; with no card they raise.

Sessions heal overflow by bounded retry (`run_with_retry`: the failing
caps escalate on the `cap_bucket` grid), re-place cells over surviving
devices without building a step (`cell_loads`, `refold`), observe any
resident batch (`count_batch`) and keep lifetime fault counters (`stats`,
drained lazily so a warm loop never waits on the card);
`serve.engine.SelfHealingSession` drives them.

The step cache.  On the card with `use_kernels=True` a step is a CUDA
graph, the counterpart of the reference's jitted executable, under the
capture policy that the decode and train steps share (`graph.py`).  A key's
first `run_batch` runs the step eagerly and returns its result: the
warm-up, which makes each kernel's first call (the library's nvcc build,
its attributes, the route descriptors' uploads, the chunked exchange's
stream).  Its second captures the whole map -> exchange -> reduce step,
every relation and every chunk of the chunked exchange with its side
stream's fork and join, into one `torch.cuda.CUDAGraph` in the
executor's memory pool, then replays it.  The graph keeps its static
inputs (the (k,) placement table and each relation's rows), its static
outputs and the descriptors its kernels read.  Every later `run_batch`
copies the session's table and relations into the static inputs and
replays: no hand-written kernel is launched from the host.  Before a
replay every live `BatchResult` of the executor's graphs gets its own
copy of its tensors (copy-on-replay), since the replay overwrites the
static outputs.  `compile_count` counts builds (one per new key, as the
reference's compilations), `captures` the graphs captured (keys used
twice or more: a rung of a retry ladder that runs once pins no memory),
`step_hits` lookups of a cached step, `evicted_steps` steps dropped by
the `max_cached_steps` LRU, which frees a graph's outputs.  The table is
an input, so re-placing builds nothing.  A capture that fails raises.
Everything else, the CPU and the plain versions on the card
(`use_kernels=False`, the tests' oracles, which read back to the host),
and every step over a mesh (a gloo collective cannot be captured), runs
the step eagerly under the same counters.
"""
from __future__ import annotations

import collections.abc
import functools
import warnings
import weakref
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..graph import CapturedStep
from ..kernels import ops
from ..kernels.join_probe import default_bits
from ..kernels.map_pack import count_scatter, scatter_desc_tensor
from ..kernels.route_cells import recipe_desc
from .hypercube import hash_seed
from .placement import (CellPlacement, check_fold, modulo_placement,
                        place_cells)
from .plan import JoinQuery, Relation
from .skewjoin import SkewJoinPlan

INVALID = -1


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------

class ExecutorError(RuntimeError):
    """Base of the executor's structured failures."""


class InputValidationError(ExecutorError):
    """A relation's tuples violate the data-plane contract (integer 2-D,
    values ≥ -1, int32-representable).  Raised before upload."""


class CapacityOverflowError(ExecutorError):
    """A static capacity was exceeded and rows were dropped.

    `shuffle_by_rel` is the (n_devices, n_relations) dropped-copy count of
    the map (indexed by SOURCE device), `join_overflow` the (n_devices,)
    dropped-result count of the reduce cascade, `relations` the labels."""

    def __init__(self, msg: str, shuffle_by_rel: np.ndarray,
                 join_overflow: np.ndarray, relations: tuple[str, ...]):
        super().__init__(msg)
        self.shuffle_by_rel = shuffle_by_rel
        self.join_overflow = join_overflow
        self.relations = relations

    @classmethod
    def from_result(cls, result: Mapping[str, np.ndarray],
                    relations: tuple[str, ...],
                    hint: str = "raise capacity_factor/out_capacity or "
                                "retry via run_with_retry()"
                    ) -> "CapacityOverflowError":
        sh = np.asarray(result["shuffle_overflow_by_rel"], np.int64)
        jo = np.asarray(result["join_overflow"], np.int64)
        lines = []
        for dev in range(sh.shape[0]):
            parts = [f"shuffle[{rel}]={int(sh[dev, r])}"
                     for r, rel in enumerate(relations) if sh[dev, r]]
            if jo[dev]:
                parts.append(f"join={int(jo[dev])}")
            if parts:
                lines.append(f"  dev {dev}: " + ", ".join(parts))
        msg = (f"capacity overflow: shuffle={int(sh.sum())} "
               f"join={int(jo.sum())}; per-device breakdown:\n"
               + "\n".join(lines) + f"\n{hint}")
        return cls(msg, sh, jo, relations)


class RetryBudgetExceededError(CapacityOverflowError):
    """Bounded retry spent its budget and the last attempt still
    overflowed: capacities escalated `attempts` times without absorbing the
    load."""

    def __init__(self, msg: str, shuffle_by_rel: np.ndarray,
                 join_overflow: np.ndarray, relations: tuple[str, ...],
                 attempts: int):
        super().__init__(msg, shuffle_by_rel, join_overflow, relations)
        self.attempts = attempts


class DeviceLossError(ExecutorError):
    """Degraded mode cannot shrink further (no surviving device to re-fold
    onto, or an eviction target is unknown)."""


# ---------------------------------------------------------------------------
# Configuration, capacities, routes
# ---------------------------------------------------------------------------

def quantize_capacity(cap: int, ratio: float = 2.0) -> int:
    """Round a capacity UP to the geometric grid {1, ⌈r⌉, ⌈⌈r⌉·r⌉, ...};
    ratio ≤ 1 is the identity.  Never rounds down."""
    cap = int(cap)
    if ratio <= 1.0 or cap <= 1:
        return max(cap, 1)
    b = 1
    while b < cap:
        b = max(int(np.ceil(b * ratio)), b + 1)
    return b


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded overflow retry: escalate the overflowing capacities by
    `escalation` (quantized to the config's `cap_bucket` grid, so a ladder
    walked once builds no step again) and re-run the same chunk, at most
    `max_retries` times; then raise `RetryBudgetExceededError`."""
    max_retries: int = 4
    escalation: float = 2.0


@dataclass(frozen=True)
class ExecutorConfig:
    capacity_factor: float = 2.0       # shuffle slack over the max observed load
    out_capacity: int = 4096           # per-device join output rows (static)
    use_kernels: bool = True           # CUDA kernels (else their plain versions)
    fuse_map: bool = True              # fused map (else route -> fold -> pack)
    hash_reduce: bool = True           # hash join (else sort-merge)
    hash_bits: int | None = None       # hash-table bits; None -> ~2·n_r buckets
    cap_bucket: float = 2.0            # grid derived capacities are quantized to
    overlap_shuffle: int = 0           # C ≥ 2: map in C chunks, each copied
                                       # to the fragments while the next
                                       # packs (per-chunk caps); ≤ 1 serial
    max_cached_steps: int = 32         # step-cache LRU bound per executor


@dataclass(frozen=True)
class _Route:
    """Static routing recipe for one (residual, relation) pair."""
    rel: str
    hashed: tuple[tuple[int, int, int, int], ...]  # (col, seed, share, stride)
    rep_strides: tuple[int, ...]                   # flattened replication offsets
    offset: int
    k: int                                          # cells wrap modulo k
    eq_constraints: tuple[tuple[int, int], ...]    # (col, value) must equal
    notin_constraints: tuple[tuple[int, tuple[int, ...]], ...]  # (col, hh_values)


def _route_specs(routes: list[_Route]) -> tuple:
    """Flatten `_Route`s to the nested-tuple `RouteSpec` of the kernels."""
    return tuple((r.hashed, r.rep_strides, r.offset, r.eq_constraints,
                  r.notin_constraints) for r in routes)


def _build_routes(plan: SkewJoinPlan) -> dict[str, list[_Route]]:
    """Per relation: one `_Route` per residual join."""
    routes: dict[str, list[_Route]] = {r.name: [] for r in plan.query.relations}
    for rp in plan.residuals:
        cube = rp.cube
        strides = cube.strides()
        assign = rp.residual.combo.as_dict
        for rel in plan.query.relations:
            hashed, wild = [], []
            for ax, (attr, share) in enumerate(zip(cube.attr_order, cube.shares)):
                if attr in rel.attrs:
                    hashed.append((rel.attrs.index(attr),
                                   hash_seed(attr, cube.salt), share, strides[ax]))
                else:
                    wild.append((strides[ax], share))
            reps = np.zeros(1, dtype=np.int64)
            for stride, share in wild:
                reps = (reps[:, None] + np.arange(share) * stride).ravel()
            eqs, notins = [], []
            for i, attr in enumerate(rel.attrs):
                hh_vals = plan.hhs.values(attr)
                if not hh_vals:
                    continue
                if attr in assign:
                    eqs.append((i, int(assign[attr])))
                else:
                    notins.append((i, tuple(int(v) for v in hh_vals)))
            routes[rel.name].append(_Route(
                rel.name, tuple(hashed), tuple(int(x) for x in reps),
                cube.offset, plan.k, tuple(eqs), tuple(notins)))
    return routes


def _struct_key(plan: SkewJoinPlan) -> tuple:
    """Hashable identity of a plan's routing: plans with equal keys route
    identically, so they can share one executor and its step cache (k
    rides along: cells wrap mod k)."""
    specs = {name: _route_specs(rs) for name, rs in _build_routes(plan).items()}
    return (plan.k, tuple(sorted(specs.items())))


def _validate_relation(name: str, arr: np.ndarray, width: int | None = None
                       ) -> np.ndarray:
    """Reject what would alias the -1 sentinel or wrap in the int32 cast,
    naming the relation and the offending row, before anything uploads."""
    a = np.asarray(arr)
    if a.ndim != 2:
        raise InputValidationError(
            f"relation {name!r}: expected a 2-D (rows, attrs) array, got "
            f"shape {a.shape}")
    if width is not None and a.shape[1] != width:
        raise InputValidationError(
            f"relation {name!r}: {a.shape[1]} columns != {width} declared "
            f"attributes")
    if not np.issubdtype(a.dtype, np.integer):
        raise InputValidationError(
            f"relation {name!r}: dtype {a.dtype} is not integer (attribute "
            f"values are int32 ≥ 0)")
    if a.size:
        lo, hi = int(a.min()), int(a.max())
        if lo < INVALID:
            bad = np.nonzero((a < INVALID).any(axis=1))[0]
            raise InputValidationError(
                f"relation {name!r}: {bad.size} corrupted rows with values "
                f"< {INVALID} (first at row {int(bad[0])}); -1 is the "
                f"reserved padding sentinel and attribute values must be "
                f"≥ 0")
        if hi > np.iinfo(np.int32).max:
            raise InputValidationError(
                f"relation {name!r}: max value {hi} exceeds int32 range")
    return a


def _check_placement_compat(placement: CellPlacement, k: int, n_dev: int
                            ) -> None:
    if placement.k != k or placement.n_devices != n_dev:
        raise ValueError(
            f"placement maps {placement.k} cells -> {placement.n_devices} "
            f"devices; plan/executor need {k} -> {n_dev}")


def resolve_device(device=None) -> torch.device:
    """The device of the port's entry points (executor, models, serving):
    the card unless the caller asks for the CPU ("meta" gives shapes and
    dtypes alone, as `serve_step.cache_shapes` asks of `init_cache`).
    Raises when the card is asked for (the default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ExecutorError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run the kernels' plain versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ExecutorError(f"unsupported device {dev}")
    return dev


def mesh_device(mesh) -> torch.device:
    """A mesh rank's default device: the current card on a CUDA mesh, else
    the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ---------------------------------------------------------------------------
# Staged map (fuse_map=False)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _route_tensors(routes, device: torch.device) -> tuple:
    """Per route of the staged map, (the not-in constraints' HH values,
    one tensor a column; the replication offsets; on the card the
    router's descriptor of its hashed axes, else None), uploaded once per
    (routes, device) as `scatter_desc_tensor` is.  A captured step holds
    them: nothing is uploaded during a capture."""
    return tuple(
        (tuple(torch.tensor(vals, dtype=torch.int32, device=device)
               for _, vals in notins),
         torch.tensor(reps, dtype=torch.int32, device=device),
         recipe_desc(hashed, device) if device.type == "cuda" else None)
        for hashed, reps, _, _, notins in routes)


def _route_copies(rows: torch.Tensor, routes, k: int, use_kernels: bool
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(logical (n, F), dest (n, F)) of rows (n, w) over every route:
    the unwrapped and the wrapped (mod k) logical cell of each copy, -1 on
    non-members; copy columns are routes in order, reps within a route."""
    n = rows.shape[0]
    member_base = rows[:, 0] != INVALID
    logical_cols, dest_cols = [], []
    for (hashed, _, offset, eqs, notins), (hhs, reps_t, desc) in zip(
            routes, _route_tensors(routes, rows.device)):
        member = member_base
        for col, val in eqs:
            member = member & (rows[:, col] == val)
        for (col, _), hh in zip(notins, hhs):
            member = member & ~(rows[:, col][:, None] == hh[None, :]).any(1)
        if hashed:
            base = ops.route_cells(rows, hashed, use_kernels=use_kernels,
                                   desc=desc)
        else:
            base = torch.zeros(n, dtype=torch.int32, device=rows.device)
        logical = base[:, None] + reps_t[None, :] + offset
        logical_cols.append(torch.where(member[:, None], logical, INVALID))
        dest_cols.append(torch.where(member[:, None], logical % k, INVALID))
    return torch.cat(logical_cols, 1), torch.cat(dest_cols, 1)


def _route_relation(rows: torch.Tensor, routes, k: int, use_kernels: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Route every source shard's rows (n_src, n_loc, w) through all of the
    relation's routes: (dest (n_src, n_loc·F) wrapped cells, tagged
    (n_src, n_loc·F, w+1) rows ++ unwrapped cell), copies in row-major
    (row, copy) order."""
    s, n, w = rows.shape
    flat = rows.reshape(s * n, w)
    logical, dest = _route_copies(flat, routes, k, use_kernels)
    fan = logical.shape[1]
    tagged = torch.cat([flat[:, None, :].expand(s * n, fan, w),
                        logical[:, :, None]], -1)
    return dest.reshape(s, n * fan), tagged.reshape(s, n * fan, w + 1)


def _fold_dests(dest: torch.Tensor, ptable: torch.Tensor, use_kernels: bool
                ) -> torch.Tensor:
    """Wrapped logical cells -> devices through the (k,) placement table;
    -1 passes through."""
    return ops.fold_cells(dest, ptable, use_kernels=use_kernels)


def _pack_buckets(dest: torch.Tensor, rows: torch.Tensor, k: int, cap: int,
                  use_kernels: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable counting-sort pack per source: dest (n_src, m), rows
    (n_src, m, w) -> (buf (n_src, k, cap, w), overflow (n_src,))."""
    return ops.bucket_pack(dest, rows, k, cap, use_kernels=use_kernels)


def _pack_buckets_argsort(dest: torch.Tensor, rows: torch.Tensor, k: int,
                          cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-argsort pack, the tests' oracle of `_pack_buckets`: per batch
    row a stable sort of the dests (invalid last), each copy's position in
    its bucket's run, copies at positions ≥ cap dropped and counted."""
    b, m, w = rows.shape
    big = torch.where(dest < 0, k, dest.long())
    sd, order = torch.sort(big, dim=1, stable=True)
    sr = _rows_at(rows.to(torch.int32), order)
    start = torch.searchsorted(sd, sd, side="left")
    pos = torch.arange(m, device=dest.device) - start
    valid = sd < k
    overflow = ((pos >= cap) & valid).sum(1).to(torch.int32)
    slot = torch.where(valid & (pos < cap), sd * cap + pos, k * cap)
    buf = torch.full((b, k * cap + 1, w), INVALID, dtype=torch.int32,
                     device=rows.device)
    batch = torch.arange(b, device=rows.device)[:, None].expand(b, m)
    buf[batch, slot] = sr                        # trash slot k·cap dropped
    return buf[:, :k * cap].reshape(b, k, cap, w), overflow


# ---------------------------------------------------------------------------
# Exchange and reduce
# ---------------------------------------------------------------------------

def exchange(buf: torch.Tensor) -> torch.Tensor:
    """The all-to-all: send buffers (n_src, n_dst, cap, w+1) -> received
    fragments (n_dst, n_src·cap, w+1), in source order."""
    s, d, cap, w1 = buf.shape
    return buf.transpose(0, 1).reshape(d, s * cap, w1)


def chunk_parts(rows: torch.Tensor, chunks: int) -> torch.Tensor:
    """Source shards rows (n_src, n_loc, w) cut for a chunked exchange:
    each source's rows padded with -1 to chunks·tile (tile =
    ⌈n_loc/chunks⌉), chunk ci rows [ci·tile, (ci+1)·tile) of every source.
    Returns (chunks, n_src, tile, w), contiguous."""
    n_src, n_loc, w = rows.shape
    tile = -(-n_loc // chunks)
    if chunks * tile > n_loc:
        rows = torch.nn.functional.pad(
            rows, (0, 0, 0, chunks * tile - n_loc), value=INVALID)
    return rows.view(n_src, chunks, tile, w).transpose(0, 1).contiguous()


def start_mesh_exchange(buf: torch.Tensor, group, world: int,
                        async_op: bool = False):
    """The all-to-all over a mesh of `world` ranks: this rank's send
    buffers (L_src, n_dst, cap, w+1), laid out as (W, L_dst, L_src, cap,
    w+1) (the part for rank j first), through one `all_to_all_single`.
    Returns (received (W_src, L_dst, L_src, cap, w+1), the work or None);
    `mesh_fragments` of it are this rank's fragments once the work ends."""
    s, d, cap, w1 = buf.shape
    send = buf.view(s, world, d // world, cap, w1).permute(
        1, 2, 0, 3, 4).contiguous()
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=async_op)
    return recv, work


def mesh_fragments(recv: torch.Tensor) -> torch.Tensor:
    """Received (W_src, L_dst, L_src, cap, w+1) -> fragments (L_dst,
    n_src·cap, w+1) in global source order (rank-major, then local): the
    transpose's order, as the reference's tiled all_to_all."""
    w, l_dst, l_src, cap, w1 = recv.shape
    return recv.transpose(0, 1).reshape(l_dst, w * l_src * cap, w1)


def shared_columns(acc_attrs: list[str], right_attrs: list[str]
                   ) -> tuple[list[int], list[int]]:
    """Key columns of one cascade step: the shared attributes (incl.
    `__cell__`) as (left columns, right columns)."""
    shared = [(acc_attrs.index(a), right_attrs.index(a))
              for a in right_attrs if a in acc_attrs]
    return [l for l, _ in shared], [r for _, r in shared]


def step_columns(acc_attrs: list[str], right_attrs: list[str],
                 attributes=None) -> tuple[list[int], list[str]]:
    """Output columns of one cascade step as indices into ``acc ++ right``
    (acc's named attributes, the right side's new ones, `__cell__` last),
    and the attributes they hold.  With the query's `attributes` (the last
    step) the columns are those attributes in that order."""
    wa = len(acc_attrs)
    extra = [a for a in right_attrs if a not in acc_attrs]
    cols = (list(range(wa - 1)) + [wa + right_attrs.index(a) for a in extra]
            + [wa - 1])
    attrs = acc_attrs[:-1] + extra + ["__cell__"]
    if attributes is not None:
        cols = [cols[attrs.index(a)] for a in attributes]
        attrs = list(attributes)
    return cols, attrs


def _columns(x: torch.Tensor, cols) -> torch.Tensor:
    """x[..., cols] for a list of column indices, contiguous: stacked from
    views, so no index list is uploaded (a host copy cannot be captured)."""
    return torch.stack([x[..., c] for c in cols], -1)


def _rows_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, n, w) gathered at row indices idx (B, m) -> (B, m, w)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def _lexsort_rows(keys: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic row order of keys (B, n, w), column 0 primary:
    one stable sort per column, last column first.  The permutation is
    unique, so it equals the reference's packed-word sort."""
    b, n, w = keys.shape
    perm = torch.arange(n, device=keys.device).expand(b, n)
    for c in range(w - 1, -1, -1):
        col = torch.gather(keys[..., c], 1, perm)
        perm = torch.gather(perm, 1, torch.sort(col, dim=1, stable=True).indices)
    return perm


def _group_ids(left_keys: torch.Tensor, right_keys: torch.Tensor,
               use_kernels: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense ranks of the union of two key sets per batch row: rows get
    equal group ids iff their keys are equal (across or within sides)."""
    n_l = left_keys.shape[1]
    comb = torch.cat([left_keys, right_keys], 1)
    perm = _lexsort_rows(comb)
    seg, _ = ops.segment_scan(_rows_at(comb, perm), use_kernels=use_kernels)
    g = torch.empty_like(seg).scatter_(1, perm, seg)
    return g[:, :n_l], g[:, n_l:]


def _probe_sort(lk: torch.Tensor, l_valid: torch.Tensor, rk: torch.Tensor,
                r_valid: torch.Tensor, use_kernels: bool
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(counts, lo, perm) by sort-merge: dense-rank both sides' keys (with
    sentinels -2 for invalid left and -3 for invalid right rows, so they
    never match), stable-sort the right side by group id (each group in
    arrival order), and read each left row's group start and run length."""
    n_r = rk.shape[1]
    lks = torch.where(l_valid[..., None], lk, -2)
    rks = torch.where(r_valid[..., None], rk, -3)
    g_l, g_r = _group_ids(lks, rks, use_kernels)
    order_r = torch.sort(g_r, dim=1, stable=True).indices
    sg_r = torch.gather(g_r, 1, order_r)
    _, _, rlen = ops.run_lengths(sg_r[..., None], use_kernels=use_kernels)
    lo = torch.searchsorted(sg_r, g_l.contiguous())
    safe = torch.clamp(lo, max=n_r - 1)
    hit = (lo < n_r) & (torch.gather(sg_r, 1, safe) == g_l)
    counts = torch.where(hit, torch.gather(rlen, 1, safe), 0)
    return (counts.to(torch.int32), lo.to(torch.int32),
            order_r.to(torch.int32))


def _probe_hash(lk: torch.Tensor, l_valid: torch.Tensor, rk: torch.Tensor,
                r_valid: torch.Tensor, use_kernels: bool,
                hash_bits: int | None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(counts, lo, perm) by the radix hash join: `join_hash` (left),
    `build_table` (right), then `probe_tables`."""
    bits = hash_bits or default_bits(rk.shape[1])
    bl = ops.join_hash(lk, l_valid, bits, use_kernels=use_kernels)
    br, rank, hist = ops.build_table(rk, r_valid, bits,
                                     use_kernels=use_kernels)
    return ops.probe_tables(lk, bl, rk, br, rank, hist, bits,
                            use_kernels=use_kernels)


def _local_join(frags: dict[str, torch.Tensor], query: JoinQuery,
                cap_out: int, use_kernels: bool, hash_reduce: bool,
                hash_bits: int | None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cascade natural join of every destination's fragments at once.

    Fragments are (n_dst, m, w+1) with the logical cell id last; each step
    joins on the shared named attributes AND equal cell id (probed by hash
    or by sort-merge, `hash_reduce`), and expands to
    the static `cap_out` rows per destination in (left row, right arrival)
    order.  The expansion writes the step's columns (acc's named attributes,
    the new ones, the cell id; on the last step the query's attribute
    order) and -1 in rows past the matches itself, in one pass.  Returns
    (rows (n_dst, cap_out, n_attrs), valid (n_dst, cap_out), overflow
    (n_dst,) int64)."""
    rels = list(query.relations)
    acc = frags[rels[0].name]
    acc_attrs = list(rels[0].attrs) + ["__cell__"]
    acc_valid = acc[..., -1] != INVALID
    overflow = torch.zeros(acc.shape[0], dtype=torch.int64, device=acc.device)
    for step, rel in enumerate(rels[1:], 1):
        right = frags[rel.name]
        right_attrs = list(rel.attrs) + ["__cell__"]
        r_valid = right[..., -1] != INVALID
        lcols, rcols = shared_columns(acc_attrs, right_attrs)
        lk = _columns(acc, lcols)
        rk = _columns(right, rcols)
        if hash_reduce:
            counts, lo, perm = _probe_hash(lk, acc_valid, rk, r_valid,
                                           use_kernels, hash_bits)
        else:
            counts, lo, perm = _probe_sort(lk, acc_valid, rk, r_valid,
                                           use_kernels)
        n_match = counts.sum(1, dtype=torch.int64)
        overflow = overflow + torch.clamp(n_match - cap_out, min=0)
        last = step == len(rels) - 1
        cols, acc_attrs = step_columns(acc_attrs, right_attrs,
                                       query.attributes if last else None)
        acc, acc_valid = ops.expand_rows(acc, right, counts, lo, perm,
                                         cap_out, cols=tuple(cols),
                                         use_kernels=use_kernels)
    if len(rels) == 1:
        acc = _columns(acc, [acc_attrs.index(a) for a in query.attributes])
    return acc, acc_valid, overflow


def _local_join_dense(frags: dict[str, torch.Tensor], query: JoinQuery,
                      cap_out: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(n_l·n_r) match-matrix cascade, the tests' exactness oracle of
    `_local_join`: per destination the first `cap_out` matches in
    (left row, right row) order.  Same outputs, bit for bit."""
    rels = list(query.relations)
    acc = frags[rels[0].name]
    acc_attrs = list(rels[0].attrs) + ["__cell__"]
    acc_valid = acc[..., -1] != INVALID
    b = acc.shape[0]
    overflow = torch.zeros(b, dtype=torch.int64, device=acc.device)
    slots = torch.arange(cap_out, device=acc.device)
    for rel in rels[1:]:
        right = frags[rel.name]
        right_attrs = list(rel.attrs) + ["__cell__"]
        n_r = right.shape[1]
        match = acc_valid[:, :, None] & (right[..., -1] != INVALID)[:, None, :]
        for a in right_attrs:
            if a in acc_attrs:
                match &= (acc[..., acc_attrs.index(a)][:, :, None]
                          == right[..., right_attrs.index(a)][:, None, :])
        flat = match.reshape(b, -1)
        n_match = flat.sum(1)
        overflow = overflow + torch.clamp(n_match - cap_out, min=0)
        # The flat index of each batch row's t-th match at slot t (0 past
        # the matches, as jnp.nonzero's fill).
        rank = torch.cumsum(flat, 1) - 1
        keep = flat & (rank < cap_out)
        idx = torch.zeros((b, cap_out + 1), dtype=torch.int64,
                          device=acc.device)
        pos = torch.arange(flat.shape[1], device=acc.device).expand(b, -1)
        idx.scatter_(1, torch.where(keep, rank, cap_out), pos)
        first = idx[:, :cap_out]
        li, ri = first // max(n_r, 1), first % max(n_r, 1)
        extra = [a for a in rel.attrs if a not in acc_attrs]
        left_rows = _rows_at(acc, li)
        pieces = [left_rows[..., :-1]]
        if extra:
            pieces.append(_rows_at(right, ri)[
                ..., [right_attrs.index(a) for a in extra]])
        pieces.append(left_rows[..., -1:])
        acc_valid = slots[None, :] < n_match[:, None]
        acc = torch.where(acc_valid[..., None], torch.cat(pieces, -1), INVALID)
        acc_attrs = acc_attrs[:-1] + extra + ["__cell__"]
    order = [acc_attrs.index(a) for a in query.attributes]
    return acc[..., order], acc_valid, overflow


# ---------------------------------------------------------------------------
# Executor and session
# ---------------------------------------------------------------------------

class ShardedJoinExecutor:
    """Runs a SkewJoinPlan as n_devices logical servers on one device, or
    over the W ranks of `mesh` (L = n_devices / W of them a rank; see the
    module docstring).

    Holds the static side: routing recipes, the placement (or strategy) and
    the cache of built steps keyed on (shapes, caps, cap_out).  Data lives
    in `ExecutorSession` (see `session()`); `run` is the one-shot wrapper.
    Over a mesh `device` defaults to the rank's (the mesh's device type,
    the current card), and another device type is refused."""

    def __init__(self, plan: SkewJoinPlan, n_devices: int = 8,
                 config: ExecutorConfig = ExecutorConfig(),
                 placement: CellPlacement | None = None,
                 placement_strategy: str = "lpt", device=None, mesh=None):
        self._setup(plan.query, plan.k,
                    {name: _route_specs(rs)
                     for name, rs in _build_routes(plan).items()},
                    n_devices, config, placement, placement_strategy, device,
                    mesh)
        self.plan = plan

    @classmethod
    def from_specs(cls, query: JoinQuery, k: int, route_specs: Mapping,
                   n_devices: int, config: ExecutorConfig = ExecutorConfig(),
                   placement: CellPlacement | None = None,
                   device=None) -> "ShardedJoinExecutor":
        """An executor from a plan's route specs alone (no planner run)."""
        ex = cls.__new__(cls)
        ex._setup(query, k, dict(route_specs), n_devices, config, placement,
                  "lpt", device, None)
        ex.plan = None
        return ex

    def _setup(self, query, k, route_specs, n_devices, config, placement,
               placement_strategy, device, mesh):
        self._setup_mesh(mesh, n_devices)
        check_fold(k, n_devices)
        if placement is not None:
            _check_placement_compat(placement, k, n_devices)
        if mesh is not None and device is None:
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        if mesh is not None and self.device.type != mesh.device_type:
            raise ExecutorError(
                f"device {self.device} is not of the mesh's type "
                f"{mesh.device_type!r}")
        self.query, self.k, self.config = query, k, config
        self.n_devices = n_devices
        self.route_specs = route_specs
        self.has_residuals = any(len(s) for s in route_specs.values())
        self.placement = placement
        self.placement_strategy = placement_strategy
        self._step_cache: dict[tuple, object] = {}
        self.compile_count = 0          # step builds (one per distinct key)
        self.step_hits = 0              # warm step lookups (no build)
        self.evicted_steps = 0          # steps dropped by the LRU bound
        self.captures = 0               # steps captured as CUDA graphs
        self._copy_stream = None        # the chunked exchange's side stream
        self._graph_pool = None         # memory pool of the captured steps
        # BatchResults holding a captured step's outputs: copied before the
        # next replay of any of the executor's graphs (they share a pool).
        self._live_results: weakref.WeakValueDictionary = \
            weakref.WeakValueDictionary()     # id -> BatchResult

    def _setup_mesh(self, mesh, n_devices: int) -> None:
        """The mesh's group, this rank, W and the L local devices (one
        process: no group, rank 0 of 1, L = n_devices)."""
        self.mesh, self.group = mesh, None
        self.world, self.rank = 1, 0
        if mesh is not None:
            if mesh.ndim != 1:
                raise ExecutorError(f"the join mesh is 1-D; got "
                                    f"{mesh.ndim} dimensions")
            self.group = mesh.get_group(0)
            self.world = dist.get_world_size(self.group)
            self.rank = dist.get_rank(self.group)
            if n_devices % self.world:
                raise ValueError(
                    f"{self.world} ranks do not divide n_devices="
                    f"{n_devices}: each rank holds n_devices / W logical "
                    f"devices")
        self.n_local = n_devices // self.world

    # -- control plane ------------------------------------------------------
    def _shard(self, arr: np.ndarray) -> np.ndarray:
        """Pad rows to a device-divisible count with INVALID rows."""
        n_pad = -len(arr) % self.n_devices
        pad = np.full((n_pad, arr.shape[1]), INVALID, arr.dtype)
        return np.concatenate([arr, pad]).astype(np.int32)

    def _upload(self, sharded: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(sharded)).to(self.device)

    def _upload_rows(self, sharded: np.ndarray) -> torch.Tensor:
        """A sharded relation's rows of this rank's sources (all of them in
        one process)."""
        per_rank = len(sharded) // self.world
        return self._upload(
            sharded[self.rank * per_rank:(self.rank + 1) * per_rank])

    def _upload_table(self, placement: CellPlacement) -> torch.Tensor:
        return self._upload(placement.table.astype(np.int32))

    def _all_gather(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's `local` (L, ...) stacked in rank order: (n_dev, ...)
        on every rank."""
        parts = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        return torch.cat(parts)

    def _count_pass(self, args: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each relation's (n_devices, k) routed-copy counts per (source
        shard, wrapped logical cell): the input of LPT placement and of the
        capacity fold.  Over a mesh each rank counts its L sources and one
        `all_gather` gives every rank the whole matrices."""
        cfg = self.config
        out = []
        for rel, a in zip(self.query.relations, args):
            spec = self.route_specs[rel.name]
            if cfg.fuse_map:
                out.append(ops.map_count(a, spec, self.k, self.n_local,
                                         use_kernels=cfg.use_kernels))
            else:
                _, dest = _route_copies(a, spec, self.k, cfg.use_kernels)
                out.append(count_scatter(dest.reshape(-1), a.shape[0],
                                         self.k, self.n_local))
        if self.mesh is None:
            return out
        return list(self._all_gather(torch.stack(out, 1)).unbind(1))

    def _compiled_step(self, shapes: tuple, caps: Mapping[str, int],
                       cap_out: int | None = None):
        """The map -> exchange -> reduce step of one (shapes, caps, cap_out)
        signature, from the LRU step cache or newly built: a `_GraphStep`
        on the card with kernels, else the eager step."""
        cfg = self.config
        cap_out = cfg.out_capacity if cap_out is None else int(cap_out)
        caps_t = tuple(int(caps[r.name]) for r in self.query.relations)
        key = (shapes, caps_t, cap_out)
        f = self._step_cache.pop(key, None)
        if f is not None:
            self._step_cache[key] = f     # re-insert: LRU, not FIFO
            self.step_hits += 1
            return f
        while len(self._step_cache) >= max(int(cfg.max_cached_steps), 1):
            self._step_cache.pop(next(iter(self._step_cache)))
            self.evicted_steps += 1
        if (self.device.type == "cuda" and cfg.use_kernels
                and self.mesh is None):
            f = _GraphStep(self, caps_t, cap_out)
        else:
            def f(ptable: torch.Tensor, *arrs: torch.Tensor):
                return self._step(ptable, arrs, caps_t, cap_out)
        self._step_cache[key] = f
        self.compile_count += 1
        return f

    def _step(self, ptable: torch.Tensor, arrs, caps: tuple[int, ...],
              cap_out: int):
        n_loc, cfg = self.n_local, self.config
        chunks = max(int(cfg.overlap_shuffle), 1)
        frags, overs = {}, []
        recv = torch.zeros(n_loc, dtype=torch.int64, device=ptable.device)
        for rel, a, cap in zip(self.query.relations, arrs, caps):
            rows = a.view(n_loc, -1, a.shape[1])          # source shards
            spec = self.route_specs[rel.name]
            if self.mesh is not None:
                frag, over = self._mesh_exchange(rows, spec, ptable, cap,
                                                 chunks)
            elif chunks == 1:
                buf, over = self._pack(rows, spec, ptable, cap)
                frag = exchange(buf)
            else:
                frag, over = self._chunked_exchange(rows, spec, ptable, cap,
                                                    chunks)
            overs.append(over)
            recv = recv + (frag[..., -1] != INVALID).sum(1)
            frags[rel.name] = frag
        sh_over = torch.stack(overs, 1)                   # (n_src, n_rel)
        out, valid, j_over = _local_join(frags, self.query, cap_out,
                                         cfg.use_kernels, cfg.hash_reduce,
                                         cfg.hash_bits)
        if self.mesh is not None:
            # Every rank's counters, in one all_gather.
            n_rel = sh_over.shape[1]
            both = self._all_gather(torch.cat(
                [sh_over.long(), j_over.long()[:, None], recv[:, None]], 1))
            sh_over = both[:, :n_rel].to(sh_over.dtype)
            j_over = both[:, n_rel].to(j_over.dtype)
            recv = both[:, n_rel + 1]
        return out, valid, sh_over, j_over, recv

    def _pack(self, rows: torch.Tensor, spec, ptable: torch.Tensor, cap: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """The map of source shards rows (n_src, n, w): send buffers
        (n_src, n_dev, cap, w+1) and overflow (n_src,)."""
        cfg, n_dev = self.config, self.n_devices
        if cfg.fuse_map:
            return ops.scatter_pack(rows, spec, ptable, self.k, n_dev, cap,
                                    use_kernels=cfg.use_kernels)
        dest, tagged = _route_relation(rows, spec, self.k, cfg.use_kernels)
        phys = _fold_dests(dest, ptable, cfg.use_kernels)
        return _pack_buckets(phys, tagged, n_dev, cap, cfg.use_kernels)

    def _chunked_exchange(self, rows: torch.Tensor, spec,
                          ptable: torch.Tensor, cap: int, chunks: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """The map and exchange in `chunks` chunks, cut by `chunk_parts`,
        each packed at the per-chunk cap.  Fragments (n_dst,
        chunks·n_src·cap, w+1) arrive chunk-major, then source-major;
        overflow (n_src,) is summed over chunks.  On the card each chunk's copy into its slice of the
        fragments runs on a side stream while the next chunk packs."""
        parts = chunk_parts(rows, chunks)
        _, n_src, _, w = parts.shape
        frag = torch.empty((self.n_devices, chunks * n_src * cap, w + 1),
                           dtype=torch.int32, device=rows.device)
        slices = frag.view(self.n_devices, chunks, n_src, cap, w + 1)
        over = None
        if rows.is_cuda:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device=rows.device)
            cur = torch.cuda.current_stream(rows.device)
            side = self._copy_stream
        for ci in range(chunks):
            buf, o = self._pack(parts[ci], spec, ptable, cap)
            over = o if over is None else over + o
            if not rows.is_cuda:
                slices[:, ci].copy_(buf.transpose(0, 1))
                continue
            side.wait_stream(cur)          # an event after chunk ci's pack
            with torch.cuda.stream(side):
                slices[:, ci].copy_(buf.transpose(0, 1))
            # Not reused before the copy ends.  Under capture the allocator
            # holds the block until the capture ends, so no later chunk of
            # the graph is packed into it either.
            buf.record_stream(side)
        if rows.is_cuda:
            cur.wait_stream(side)          # the reduce reads every slice
        return frag, over

    def _mesh_exchange(self, rows: torch.Tensor, spec, ptable: torch.Tensor,
                       cap: int, chunks: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """The map and exchange over the mesh: this rank's L sources rows
        (L, n_loc, w) packed, serially or in `chunks` chunks cut by
        `chunk_parts`, one `all_to_all_single` a chunk, each started
        (async) before the next chunk packs and all waited for before the
        reduce.  Fragments (L_dst, chunks·n_dev·cap, w+1)
        chunk-major, then in global source order; overflow (L,)."""
        parts = chunk_parts(rows, chunks)
        over, pending = None, []
        for ci in range(chunks):
            buf, o = self._pack(parts[ci], spec, ptable, cap)
            over = o if over is None else over + o
            pending.append(start_mesh_exchange(buf, self.group, self.world,
                                               async_op=True))
        for _, work in pending:
            work.wait()
        return torch.cat([mesh_fragments(recv) for recv, _ in pending],
                         1), over

    # -- data plane ----------------------------------------------------------
    def session(self) -> "ExecutorSession":
        return ExecutorSession(self)

    def run(self, data: Mapping[str, np.ndarray]) -> "BatchResult":
        """prepare + run_batch; over a mesh every rank calls it."""
        return self.session().prepare(data).run_batch()

    def result_rows(self, data: Mapping[str, np.ndarray]) -> np.ndarray:
        """The valid rows of `run(data)` in destination order; raises on
        overflow.  Over a mesh every rank calls it and gets every rank's
        rows."""
        res = self.run(data)
        if res["shuffle_overflow"].sum() or res["join_overflow"].sum():
            raise CapacityOverflowError.from_result(
                res, tuple(r.name for r in self.query.relations))
        if self.mesh is None or not self.has_residuals:
            return res["rows"][res["valid"]]
        out, valid = res.tensors[:2]
        mine = out[valid]
        sizes = self._all_gather(torch.tensor(
            [mine.shape[0]], dtype=torch.int64, device=out.device)).tolist()
        padded = torch.full((max(sizes), mine.shape[1]), INVALID,
                            dtype=mine.dtype, device=mine.device)
        padded[:mine.shape[0]] = mine
        parts = self._all_gather(padded[None])
        return torch.cat([p[:n] for p, n in zip(parts, sizes)]).cpu().numpy()


class _GraphStep:
    """One (shapes, caps, cap_out) step on the card, under the capture
    policy of `graph.CapturedStep`, which binds nothing (the step reads
    the executor's descriptors, kept in `held`) and copies the (k,)
    placement table and each relation's (n, w) rows in.

    The first call runs the step eagerly and returns that run's own
    tensors.  It is the warm-up, where each kernel's first call happens
    (the library's build, its attributes, the route descriptors' uploads,
    the chunked exchange's stream), so a key run once, as most rungs of a
    retry ladder are, is never captured.  The second call captures the
    step into the executor's graph pool and replays it; every later call
    copies its arguments in and replays.  Before either, each live result
    of the executor's graphs gets tensors of its own (copy-on-replay: the
    graphs share a pool, so a replay may write over any of their outputs).
    A capture that fails raises."""

    def __init__(self, ex: "ShardedJoinExecutor", caps: tuple[int, ...],
                 cap_out: int):
        self._ex = weakref.ref(ex)      # the executor's cache holds the step
        self.held = None
        # Partials of weak references: nothing here refers back to the step,
        # so an evicted step frees its graph at once.
        self.compiled = CapturedStep(
            functools.partial(_run_step, self._ex, caps, cap_out), ex.device,
            pool=functools.partial(_graph_pool, self._ex),
            before_graph=functools.partial(_own_results, self._ex))

    def __call__(self, ptable: torch.Tensor, *arrs: torch.Tensor):
        ex = self._ex()
        if self.held is None:
            self.held = [scatter_desc_tensor(spec, ptable.device)
                         if ex.config.fuse_map
                         else _route_tensors(spec, ptable.device)
                         for spec in ex.route_specs.values()]
        captured = self.compiled.captures
        out = self.compiled((), (ptable, *arrs))
        ex.captures += self.compiled.captures - captured
        return out


def _run_step(ex_ref, caps: tuple[int, ...], cap_out: int,
              ptable: torch.Tensor, *arrs: torch.Tensor):
    return ex_ref()._step(ptable, arrs, caps, cap_out)


def _graph_pool(ex_ref):
    """The memory pool that every captured step of the executor allocates
    from."""
    ex = ex_ref()
    if ex._graph_pool is None:
        ex._graph_pool = torch.cuda.graph_pool_handle()
    return ex._graph_pool


def _own_results(ex_ref) -> None:
    """Copy-on-replay: every live result of the executor's graphs gets
    tensors of its own."""
    ex = ex_ref()
    for res in list(ex._live_results.values()):
        res._own_tensors()
    ex._live_results.clear()


class BatchResult(collections.abc.Mapping):
    """Result of one `run_batch`: a read-only Mapping with the keys 'rows',
    'valid', 'shuffle_overflow', 'shuffle_overflow_by_rel', 'join_overflow'
    and 'recv_counts'.  Each value is copied to the host as numpy on first
    access and cached, so a loop that never reads a key never waits for the
    device.  `tensors` keeps the device tensors (rows, valid, shuffle
    overflow by relation, join overflow, received rows).  A result of a
    captured step holds the graph's outputs until the next replay, which
    first gives it copies of its own: read them through `tensors`, not
    from a reference taken earlier.  Over a mesh 'rows' and 'valid' are
    the rank's own, its L destinations' (L·cap_out rows); the counters are
    every rank's, (n_devices, ...), equal on every rank.  No key's access
    runs a collective."""

    _KEYS = ("rows", "valid", "shuffle_overflow", "shuffle_overflow_by_rel",
             "join_overflow", "recv_counts")

    def __init__(self, out, valid, sh_over, j_over, recv):
        self.tensors = (out, valid, sh_over, j_over, recv)
        self._cache: dict = {}

    def __getitem__(self, key):
        if key not in self._KEYS:
            raise KeyError(key)
        if key not in self._cache:
            out, valid, sh_over, j_over, recv = self.tensors
            if key == "rows":
                val = out.reshape(-1, out.shape[-1]).cpu().numpy()
            elif key == "valid":
                val = valid.reshape(-1).cpu().numpy()
            elif key == "shuffle_overflow_by_rel":
                val = sh_over.cpu().numpy().astype(np.int64)
            elif key == "shuffle_overflow":
                val = self["shuffle_overflow_by_rel"].sum(axis=1)
            elif key == "join_overflow":
                val = j_over.cpu().numpy().astype(np.int64)
            else:   # recv_counts
                val = recv.cpu().numpy()
            self._cache[key] = val
        return self._cache[key]

    def _own_tensors(self) -> None:
        self.tensors = tuple(t.clone() for t in self.tensors)

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self):
        return len(self._KEYS)


class ExecutorSession:
    """Device-resident session: upload and size once, run warm many times.

    `prepare(data)` shards and uploads the relations, runs one counting pass
    whose count matrices give the placement (LPT when k > n_devices,
    identity when equal, or `placement=`) and the shuffle capacities (worst
    (source, destination device) count after the fold, times
    `capacity_factor`, quantized to `cap_bucket`, ceil-divided by C under
    `overlap_shuffle = C ≥ 2`; explicit `caps=` are taken as given).
    `run_batch(chunks)` streams same-schema batches through the cached
    step, padding smaller ones to the prepared shapes; `run_with_retry`
    heals overflow; `refold` re-places cells without building a step.

    `stats` holds the session's lifetime fault counters: every attempt of
    every chunk counted once, so a retried chunk keeps the overflow its
    failed attempts saw (the delivered result's own counters are zero).
    run_batch parks each batch's overflow tensors on the device and `stats`
    drains them on access, so a warm loop never waits on the card."""

    # Undrained per-batch overflow pairs before run_batch folds them in
    # itself: an unread streaming session pins no more buffers than this.
    _PENDING_MAX = 64

    def __init__(self, executor: ShardedJoinExecutor):
        self.executor = executor
        self.caps: dict[str, int] = {}
        self.cap_out: int = int(executor.config.out_capacity)
        self.placement: CellPlacement | None = None
        self.count_passes = 0           # routing passes run (prepare + hooks)
        self._prepared = False
        self._device_args: list[torch.Tensor] | None = None
        self._last_args: list[torch.Tensor] | None = None  # last batch run
        self._ptable: torch.Tensor | None = None
        self._shapes: tuple | None = None
        self._count_mats: list[np.ndarray] | None = None
        n_rel = len(executor.query.relations)
        self._stats: dict = {
            "batches": 0,               # run_batch calls (attempts included)
            "retries": 0,               # re-runs forced by overflow
            "escalations": 0,           # capacity bumps applied by retries
            "shuffle_overflow": np.zeros((executor.n_devices, n_rel),
                                         np.int64),
            "join_overflow": np.zeros(executor.n_devices, np.int64),
        }
        self._pending: list[tuple] = []     # undrained (sh_over, j_over)

    def _drain_stats(self) -> None:
        pending, self._pending = self._pending, []
        for sh_over, j_over in pending:
            self._stats["shuffle_overflow"] += sh_over.cpu().numpy()
            self._stats["join_overflow"] += j_over.cpu().numpy()

    @property
    def stats(self) -> dict:
        """Session-lifetime fault counters, pending overflow drained."""
        self._drain_stats()
        return self._stats

    def _check_prepared(self, what: str) -> None:
        if not self._prepared:
            raise RuntimeError(f"ExecutorSession.{what} before prepare()")

    def prepare(self, data: Mapping[str, np.ndarray],
                caps: Mapping[str, int] | None = None,
                placement: CellPlacement | None = None) -> "ExecutorSession":
        """Shard + upload `data`; derive (or accept) placement + capacities."""
        ex = self.executor
        k, n_dev = ex.k, ex.n_devices
        if placement is None:
            placement = ex.placement
        if placement is not None:
            _check_placement_compat(placement, k, n_dev)
        self.cap_out = int(ex.config.out_capacity)
        self._prepared = True
        if not ex.has_residuals:
            # Provably empty join; still expose a trivial placement.
            self.placement = placement or modulo_placement(k, n_dev)
            self._device_args, self._shapes = [], ()
            return self
        sharded = [ex._shard(_validate_relation(r.name, data[r.name],
                                                len(r.attrs)))
                   for r in ex.query.relations]
        self._device_args = [ex._upload_rows(s) for s in sharded]
        self._shapes = tuple(tuple(a.shape) for a in self._device_args)
        counts = None
        if placement is None:
            if k == n_dev:
                placement = modulo_placement(k, n_dev)   # identity
            else:
                counts = self._counts()
                cell_loads = np.sum([c.sum(axis=0) for c in counts], axis=0)
                placement = place_cells(cell_loads, k, n_dev,
                                        ex.placement_strategy)
        self.placement = placement
        self._ptable = ex._upload_table(placement)
        if caps is None:
            counts = counts if counts is not None else self._counts()
            caps = self._derive_caps(counts, placement)
        self.caps = dict(caps)
        self._count_mats = counts       # None when caps + placement given
        return self

    def _counts(self, args: list[torch.Tensor] | None = None
                ) -> list[np.ndarray]:
        """Per-relation (n_devices, k) routed-copy count matrices (host) of
        `args`, by default the prepared relations."""
        args = self._device_args if args is None else args
        if args is None:
            raise RuntimeError("no resident batch to count: prepare(data) or "
                               "run_batch(chunks) first")
        self.count_passes += 1
        return [c.cpu().numpy().astype(np.int64)
                for c in self.executor._count_pass(args)]

    def count_batch(self) -> list[np.ndarray]:
        """Count matrices of the last batch run (the prepared relations
        until a run_batch(chunks)): one more counting pass over tensors
        already on the device.  Column sums are the batch's per-cell
        loads; folded through a placement they give its capacities."""
        self._check_prepared("count_batch")
        if not self.executor.has_residuals:
            return []
        return self._counts(self._last_args)

    def _derive_caps(self, counts: list[np.ndarray],
                     placement: CellPlacement) -> dict[str, int]:
        """Worst per-(source, destination device) routed-copy count after
        folding the count matrices through `placement`, times
        `capacity_factor`, quantized to the cap grid; under
        `overlap_shuffle = C ≥ 2` that serial cap ceil-divided by C (not
        quantized again), so C chunks' buffers hold the serial buffer's
        rows."""
        ex = self.executor
        chunks = max(int(ex.config.overlap_shuffle), 1)
        fold = np.zeros((ex.k, ex.n_devices), np.int64)
        fold[np.arange(ex.k), placement.table] = 1
        caps = {}
        for r, c in zip(ex.query.relations, counts):
            serial = quantize_capacity(
                int(np.ceil(max(int((c @ fold).max()), 1)
                            * ex.config.capacity_factor)),
                ex.config.cap_bucket)
            caps[r.name] = -(-serial // chunks)
        return caps

    def cell_loads(self) -> np.ndarray:
        """Per-logical-cell routed-copy loads (k,) from the prepare-time
        count matrices, the LPT input of a degraded-mode re-fold; one
        counting pass if prepare() never counted."""
        self._check_prepared("cell_loads")
        if self._count_mats is None:
            self._count_mats = self._counts()
        return np.sum([c.sum(axis=0) for c in self._count_mats], axis=0)

    def refold(self, placement: CellPlacement,
               counts: list[np.ndarray] | None = None) -> "ExecutorSession":
        """Re-place logical cells without touching shapes or resident data.

        Uploads the new table (a step argument: no step is built) and
        re-derives capacities from the prepare-time count matrices folded
        through it, or from `counts` (e.g. `count_batch()`'s).  Evicting a
        device is `refold(lpt_placement(cell_loads(), n_devices,
        devices=survivors))`: it keeps its slot and receives no cell, and
        rows stay exact because correctness never depends on placement."""
        ex = self.executor
        self._check_prepared("refold")
        _check_placement_compat(placement, ex.k, ex.n_devices)
        self.placement = placement
        if not ex.has_residuals:
            return self
        self._ptable = ex._upload_table(placement)
        if counts is None:
            if self._count_mats is None:
                self._count_mats = self._counts()
            counts = self._count_mats
        self.caps = self._derive_caps(counts, placement)
        return self

    def run_batch(self, chunks: Mapping[str, np.ndarray] | None = None):
        """Run one batch through the warm step.

        `chunks=None` re-runs the prepared relations; otherwise every
        relation maps to a fresh tuple array, padded up to the session
        shapes when smaller.  A session made by `session_from_numpy` takes
        its shapes from its first batch.  Returns a `BatchResult`."""
        self._check_prepared("run_batch")
        ex = self.executor
        query, n_dev = ex.query, ex.n_devices
        n_rel = len(query.relations)
        if not ex.has_residuals:
            w = len(query.attributes)
            self._stats["batches"] += 1
            return {"rows": np.zeros((0, w), np.int32),
                    "valid": np.zeros((0,), bool),
                    "shuffle_overflow": np.zeros(n_dev, np.int64),
                    "shuffle_overflow_by_rel": np.zeros((n_dev, n_rel),
                                                        np.int64),
                    "join_overflow": np.zeros(n_dev, np.int64),
                    "recv_counts": np.zeros(n_dev, np.int64)}
        if chunks is None:
            if self._device_args is None:
                raise RuntimeError("run_batch() without chunks needs "
                                   "prepare(data) first")
            args = self._device_args
        else:
            targets = self._shapes or (None,) * n_rel
            args = []
            for rel, target in zip(query.relations, targets):
                sh = ex._shard(_validate_relation(rel.name, chunks[rel.name],
                                                  len(rel.attrs)))
                n_target = None if target is None else target[0] * ex.world
                if n_target is not None and sh.shape[0] < n_target:
                    pad = np.full((n_target - sh.shape[0], sh.shape[1]),
                                  INVALID, sh.dtype)
                    sh = np.concatenate([sh, pad])
                args.append(ex._upload_rows(sh))
        self._last_args = args          # count_batch()'s observation target
        shapes = tuple(tuple(a.shape) for a in args)
        if self._shapes is None:
            self._shapes = shapes
        elif shapes != self._shapes:
            warnings.warn(
                f"run_batch chunk shapes {shapes} exceed the prepared "
                f"{self._shapes}: running with frozen prepare-time "
                f"capacities (builds a new step for a new shape); "
                f"re-prepare() to re-derive shapes/placement/capacities",
                UserWarning, stacklevel=2)
        f = ex._compiled_step(shapes, self.caps, self.cap_out)
        res = BatchResult(*f(self._ptable, *args))
        sh_over, j_over = res.tensors[2:4]
        if isinstance(f, _GraphStep) and f.compiled.graph is not None:
            # The next replay overwrites the graph's outputs: the result is
            # copied before it, and the overflow parked for `stats` now.
            ex._live_results[id(res)] = res
            sh_over, j_over = sh_over.clone(), j_over.clone()
        self._stats["batches"] += 1
        self._pending.append((sh_over, j_over))
        if len(self._pending) >= self._PENDING_MAX:
            self._drain_stats()
        return res

    def run_with_retry(self, chunks: Mapping[str, np.ndarray] | None = None,
                       policy: RetryPolicy | None = None):
        """Run one batch, healing capacity overflow by bounded retry.

        Each overflowing attempt escalates exactly the failing capacities
        (the shuffle cap of each relation that dropped copies, `cap_out`
        when the cascade dropped rows) by `policy.escalation`, quantized to
        the config's `cap_bucket` grid, and re-runs the same chunk.  After
        `policy.max_retries` escalations a result that still overflows
        raises `RetryBudgetExceededError` with the last attempt's
        per-device breakdown."""
        policy = policy or RetryPolicy()
        ex = self.executor
        rels = tuple(r.name for r in ex.query.relations)
        res = self.run_batch(chunks)
        attempt = 1
        while res["shuffle_overflow"].sum() or res["join_overflow"].sum():
            if attempt > policy.max_retries:
                base = CapacityOverflowError.from_result(res, rels)
                raise RetryBudgetExceededError(
                    f"retry budget exhausted: {attempt} attempts "
                    f"({policy.max_retries} retries) and the last still "
                    f"overflowed — {base}", base.shuffle_by_rel,
                    base.join_overflow, rels, attempt)
            per_rel = res["shuffle_overflow_by_rel"].sum(axis=0)
            for i, rel in enumerate(rels):
                if per_rel[i]:
                    self.caps[rel] = quantize_capacity(
                        int(np.ceil(self.caps[rel] * policy.escalation)),
                        ex.config.cap_bucket)
                    self._stats["escalations"] += 1
            if res["join_overflow"].sum():
                self.cap_out = quantize_capacity(
                    int(np.ceil(self.cap_out * policy.escalation)),
                    ex.config.cap_bucket)
                self._stats["escalations"] += 1
            self._stats["retries"] += 1
            res = None      # dropped, not copied before the re-run's replay
            res = self.run_batch(chunks)
            attempt += 1
        return res


def session_from_numpy(relations, k: int, n_dev: int, route_specs: Mapping,
                       ptable: np.ndarray, caps: Mapping[str, int],
                       cap_out: int, device=None) -> ExecutorSession:
    """A prepared session from another executor's plan state: the query as
    (name, attrs) tuples, k, the per-relation route specs (nested int
    tuples), the (k,) placement table and the capacities.  Its first
    `run_batch(chunks)` fixes the session shapes."""
    query = JoinQuery(tuple(Relation(name, tuple(attrs))
                            for name, attrs in relations))
    placement = CellPlacement(np.asarray(ptable, np.int32), n_dev)
    ex = ShardedJoinExecutor.from_specs(
        query, k, route_specs, n_dev, ExecutorConfig(out_capacity=cap_out),
        placement=placement, device=device)
    s = ex.session()
    s.placement = placement
    s._ptable = ex._upload_table(placement)
    s.caps = {name: int(c) for name, c in caps.items()}
    s.cap_out = int(cap_out)
    s._prepared = True
    return s
