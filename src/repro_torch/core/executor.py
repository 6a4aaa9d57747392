"""SkewShares execution on one GPU: prepare -> map -> exchange -> reduce.

One card stands for n_dev servers.  n_dev is a leading tensor axis:

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
(`run_lengths`, `searchsorted`).  Every arm gives the same bits.  The
chunked exchange (`overlap_shuffle` ≥ 2) is not ported.  `use_kernels=False`
runs the kernels' plain versions on the same device.  Entry points take
`device=` and default to the card; with no card they raise.
"""
from __future__ import annotations

import collections.abc
import warnings
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from ..kernels import ops
from ..kernels.join_probe import default_bits
from ..kernels.map_pack import count_scatter
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
                    hint: str = "raise capacity_factor/out_capacity"
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
class ExecutorConfig:
    capacity_factor: float = 2.0       # shuffle slack over the max observed load
    out_capacity: int = 4096           # per-device join output rows (static)
    use_kernels: bool = True           # CUDA kernels (else their plain versions)
    fuse_map: bool = True              # fused map (else route -> fold -> pack)
    hash_reduce: bool = True           # hash join (else sort-merge)
    hash_bits: int | None = None       # hash-table bits; None -> ~2·n_r buckets
    cap_bucket: float = 2.0            # grid derived capacities are quantized to
    overlap_shuffle: int = 0           # chunked exchange; not ported (≤ 1 only)
    max_cached_steps: int = 32         # step-cache LRU bound per executor


def _check_config(cfg: ExecutorConfig) -> None:
    if int(cfg.overlap_shuffle) > 1:
        raise NotImplementedError("overlap_shuffle >= 2 is not ported")


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
    the card unless the caller asks for the CPU.  Raises when the card is
    asked for (the default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ExecutorError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run the kernels' plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ExecutorError(f"unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# Staged map (fuse_map=False)
# ---------------------------------------------------------------------------

def _route_copies(rows: torch.Tensor, routes, k: int, use_kernels: bool
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(logical (n, F), dest (n, F)) of rows (n, w) over every route:
    the unwrapped and the wrapped (mod k) logical cell of each copy, -1 on
    non-members; copy columns are routes in order, reps within a route."""
    n = rows.shape[0]
    member_base = rows[:, 0] != INVALID
    logical_cols, dest_cols = [], []
    for hashed, reps, offset, eqs, notins in routes:
        member = member_base
        for col, val in eqs:
            member = member & (rows[:, col] == val)
        for col, vals in notins:
            hh = torch.tensor(vals, dtype=rows.dtype, device=rows.device)
            member = member & ~(rows[:, col][:, None] == hh[None, :]).any(1)
        if hashed:
            base = ops.route_cells(rows, hashed, use_kernels=use_kernels)
        else:
            base = torch.zeros(n, dtype=torch.int32, device=rows.device)
        reps_t = torch.tensor(reps, dtype=torch.int32, device=rows.device)
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


# ---------------------------------------------------------------------------
# Exchange and reduce
# ---------------------------------------------------------------------------

def exchange(buf: torch.Tensor) -> torch.Tensor:
    """The all-to-all: send buffers (n_src, n_dst, cap, w+1) -> received
    fragments (n_dst, n_src·cap, w+1), in source order."""
    s, d, cap, w1 = buf.shape
    return buf.transpose(0, 1).reshape(d, s * cap, w1)


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
        lk = acc[..., lcols].contiguous()
        rk = right[..., rcols].contiguous()
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
        acc = acc[..., [acc_attrs.index(a) for a in query.attributes]]
    return acc, acc_valid, overflow


# ---------------------------------------------------------------------------
# Executor and session
# ---------------------------------------------------------------------------

class ShardedJoinExecutor:
    """Runs a SkewJoinPlan as n_devices logical servers on one device.

    Holds the static side: routing recipes, the placement (or strategy) and
    the cache of built steps keyed on (shapes, caps, cap_out).  Data lives
    in `ExecutorSession` (see `session()`); `run` is the one-shot wrapper."""

    def __init__(self, plan: SkewJoinPlan, n_devices: int = 8,
                 config: ExecutorConfig = ExecutorConfig(),
                 placement: CellPlacement | None = None,
                 placement_strategy: str = "lpt", device=None):
        self._setup(plan.query, plan.k,
                    {name: _route_specs(rs)
                     for name, rs in _build_routes(plan).items()},
                    n_devices, config, placement, placement_strategy, device)
        self.plan = plan

    @classmethod
    def from_specs(cls, query: JoinQuery, k: int, route_specs: Mapping,
                   n_devices: int, config: ExecutorConfig = ExecutorConfig(),
                   placement: CellPlacement | None = None,
                   device=None) -> "ShardedJoinExecutor":
        """An executor from a plan's route specs alone (no planner run)."""
        ex = cls.__new__(cls)
        ex._setup(query, k, dict(route_specs), n_devices, config, placement,
                  "lpt", device)
        ex.plan = None
        return ex

    def _setup(self, query, k, route_specs, n_devices, config, placement,
               placement_strategy, device):
        _check_config(config)
        check_fold(k, n_devices)
        if placement is not None:
            _check_placement_compat(placement, k, n_devices)
        self.device = resolve_device(device)
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

    # -- control plane ------------------------------------------------------
    def _shard(self, arr: np.ndarray) -> np.ndarray:
        """Pad rows to a device-divisible count with INVALID rows."""
        n_pad = -len(arr) % self.n_devices
        pad = np.full((n_pad, arr.shape[1]), INVALID, arr.dtype)
        return np.concatenate([arr, pad]).astype(np.int32)

    def _upload(self, sharded: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(sharded)).to(self.device)

    def _upload_table(self, placement: CellPlacement) -> torch.Tensor:
        return self._upload(placement.table.astype(np.int32))

    def _count_pass(self, args: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each relation's (n_devices, k) routed-copy counts per (source
        shard, wrapped logical cell): the input of LPT placement and of the
        capacity fold."""
        cfg = self.config
        out = []
        for rel, a in zip(self.query.relations, args):
            spec = self.route_specs[rel.name]
            if cfg.fuse_map:
                out.append(ops.map_count(a, spec, self.k, self.n_devices,
                                         use_kernels=cfg.use_kernels))
            else:
                _, dest = _route_copies(a, spec, self.k, cfg.use_kernels)
                out.append(count_scatter(dest.reshape(-1), a.shape[0],
                                         self.k, self.n_devices))
        return out

    def _compiled_step(self, shapes: tuple, caps: Mapping[str, int],
                       cap_out: int | None = None):
        """The map -> exchange -> reduce step of one (shapes, caps, cap_out)
        signature, from the LRU step cache or newly built."""
        cfg = self.config
        cap_out = cfg.out_capacity if cap_out is None else int(cap_out)
        caps_t = tuple(int(caps[r.name]) for r in self.query.relations)
        key = (shapes, caps_t, cap_out)
        f = self._step_cache.pop(key, None)
        if f is not None:
            self._step_cache[key] = f     # re-insert: LRU, not FIFO
            self.step_hits += 1
            return f

        def step(ptable: torch.Tensor, *arrs: torch.Tensor):
            return self._step(ptable, arrs, caps_t, cap_out)

        while len(self._step_cache) >= max(int(cfg.max_cached_steps), 1):
            self._step_cache.pop(next(iter(self._step_cache)))
            self.evicted_steps += 1
        self._step_cache[key] = step
        self.compile_count += 1
        return step

    def _step(self, ptable: torch.Tensor, arrs, caps: tuple[int, ...],
              cap_out: int):
        n_dev, cfg = self.n_devices, self.config
        frags, overs = {}, []
        recv = torch.zeros(n_dev, dtype=torch.int64, device=ptable.device)
        for rel, a, cap in zip(self.query.relations, arrs, caps):
            rows = a.view(n_dev, -1, a.shape[1])          # source shards
            spec = self.route_specs[rel.name]
            if cfg.fuse_map:
                buf, over = ops.scatter_pack(rows, spec, ptable, self.k,
                                             n_dev, cap,
                                             use_kernels=cfg.use_kernels)
            else:
                dest, tagged = _route_relation(rows, spec, self.k,
                                               cfg.use_kernels)
                phys = _fold_dests(dest, ptable, cfg.use_kernels)
                buf, over = _pack_buckets(phys, tagged, n_dev, cap,
                                          cfg.use_kernels)
            frag = exchange(buf)
            overs.append(over)
            recv = recv + (frag[..., -1] != INVALID).sum(1)
            frags[rel.name] = frag
        sh_over = torch.stack(overs, 1)                   # (n_src, n_rel)
        out, valid, j_over = _local_join(frags, self.query, cap_out,
                                         cfg.use_kernels, cfg.hash_reduce,
                                         cfg.hash_bits)
        return out, valid, sh_over, j_over, recv

    # -- data plane ----------------------------------------------------------
    def session(self) -> "ExecutorSession":
        return ExecutorSession(self)

    def run(self, data: Mapping[str, np.ndarray]) -> "BatchResult":
        return self.session().prepare(data).run_batch()

    def result_rows(self, data: Mapping[str, np.ndarray]) -> np.ndarray:
        res = self.run(data)
        if res["shuffle_overflow"].sum() or res["join_overflow"].sum():
            raise CapacityOverflowError.from_result(
                res, tuple(r.name for r in self.query.relations))
        return res["rows"][res["valid"]]


class BatchResult(collections.abc.Mapping):
    """Result of one `run_batch`: a read-only Mapping with the keys 'rows',
    'valid', 'shuffle_overflow', 'shuffle_overflow_by_rel', 'join_overflow'
    and 'recv_counts'.  Each value is copied to the host as numpy on first
    access and cached, so a loop that never reads a key never waits for the
    device.  `tensors` keeps the device tensors (rows, valid, shuffle
    overflow by relation, join overflow, received rows)."""

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
    `capacity_factor`, quantized to `cap_bucket`; explicit `caps=` are
    taken as given).  `run_batch(chunks)` streams same-schema batches
    through the cached step, padding smaller ones to the prepared shapes."""

    def __init__(self, executor: ShardedJoinExecutor):
        self.executor = executor
        self.caps: dict[str, int] = {}
        self.cap_out: int = int(executor.config.out_capacity)
        self.placement: CellPlacement | None = None
        self.count_passes = 0           # routing passes run by prepare
        self._prepared = False
        self._device_args: list[torch.Tensor] | None = None
        self._ptable: torch.Tensor | None = None
        self._shapes: tuple | None = None
        self._count_mats: list[np.ndarray] | None = None

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
        self._device_args = [ex._upload(s) for s in sharded]
        self._shapes = tuple(s.shape for s in sharded)
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
        self._count_mats = counts
        return self

    def _counts(self) -> list[np.ndarray]:
        """Per-relation (n_devices, k) routed-copy count matrices (host)."""
        self.count_passes += 1
        return [c.cpu().numpy().astype(np.int64)
                for c in self.executor._count_pass(self._device_args)]

    def _derive_caps(self, counts: list[np.ndarray],
                     placement: CellPlacement) -> dict[str, int]:
        """Worst per-(source, destination device) routed-copy count after
        folding the count matrices through `placement`, times
        `capacity_factor`, quantized to the cap grid."""
        ex = self.executor
        fold = np.zeros((ex.k, ex.n_devices), np.int64)
        fold[np.arange(ex.k), placement.table] = 1
        return {r.name: quantize_capacity(
                    int(np.ceil(max(int((c @ fold).max()), 1)
                                * ex.config.capacity_factor)),
                    ex.config.cap_bucket)
                for r, c in zip(ex.query.relations, counts)}

    def run_batch(self, chunks: Mapping[str, np.ndarray] | None = None):
        """Run one batch through the warm step.

        `chunks=None` re-runs the prepared relations; otherwise every
        relation maps to a fresh tuple array, padded up to the session
        shapes when smaller.  A session made by `session_from_numpy` takes
        its shapes from its first batch.  Returns a `BatchResult`."""
        if not self._prepared:
            raise RuntimeError("ExecutorSession.run_batch before prepare()")
        ex = self.executor
        query, n_dev = ex.query, ex.n_devices
        n_rel = len(query.relations)
        if not ex.has_residuals:
            w = len(query.attributes)
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
                if target is not None and sh.shape[0] < target[0]:
                    pad = np.full((target[0] - sh.shape[0], sh.shape[1]),
                                  INVALID, sh.dtype)
                    sh = np.concatenate([sh, pad])
                args.append(ex._upload(sh))
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
        return BatchResult(*f(self._ptable, *args))


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
