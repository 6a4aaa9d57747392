#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's join paths and its MoE serving path on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. the card's name and power limit (nvidia-smi);
  2. build the fifteen CUDA kernels from src/repro_torch/kernels/csrc;
  3. the full-size cell end to end on the kernels (fused map + hash
     reduce, the default `ExecutorConfig`): R(A,B) ⋈ S(B,C) with
     2^21 rows per relation, one heavy hitter B = 0 of 12,288 rows, a tail
     of 2^20 values, k = 256 logical cells on n_dev = 8 logical servers.
     Launch counts are zeroed just before `prepare` + the first `run_batch`
     and read just after.  Requires zero overflow, the exact join size
     Σ_v c_R(v)·c_S(v), rows equal to the same step on the plain versions
     (`use_kernels=False`) on the card, and no new step on a second batch;
     a profile of a warm batch that must name build_table's, scatter_pack's
     and probe_tables' kernels and hold no torch row-wise scan
     (`tensor_kernel_scan_innermost_dim`, the plain probe's cumsum);
  4. every kernel against its plain version on the card at the shapes of
     that run, bit for bit, with kernel, plain and bound times; the bound
     counts what this run's data needs (valid rows only, matched rows only
     for the expansion) and is the larger of its bytes and operations times.
     expand_rows is recorded as the main path calls it, with the final
     step's columns (the step's column selection, -1 fill and attribute
     order written by the kernel), and beside it with cols=None (the full
     (B, cap, wl + wr) expansion of the reference kernel), each with its
     own bound and its device time; build_table is recorded with its
     device time, and beside it on the cell's right side with every valid
     row given one heavy-hitter row's keys (one bucket a destination);
     probe_tables likewise on the cell's tables, on that hot bucket and
     at deep-round shapes (1-2 bits, 8,000-20,000 rows), each with its
     device time and each of its kernels' share; map_count on R (the
     entry) and S, each with its device time and its kernels' share;
     scatter_pack is recorded on R (the entry) and S with their device
     times (each of its kernels' share printed), and on R with every
     member copy on one device (a placement table of zeros) at a cap that
     holds them all and at the cell's cap, which must overflow; join_hash
     with its device time;
  4c. the kernel library (the executor does not call it) on that cell's
     data, launch counts zeroed just before and read just after: map_pack
     on R's and S's (8, 2^18, 2) shards, `torch.equal` to scatter_pack,
     with its time beside scatter_pack's and the staged route -> fold ->
     pack's, its device time and each kernel's share (streams, assembly,
     fill), its streams' device time, and a profile of one call that must
     hold no aten scatter, gather, cat or arange; hash_partition on R's B
     column at the tail residual's B share (ids equal to numpy's
     multiply_shift) and at 2^20 buckets;
     match_counts and first_match on the B columns of one tail cell's and
     one heavy cell's routed fragments (Σ counts over the tail cell = the
     cell's Σ_v c_R(v)·c_S(v); every heavy pair matches) and on a random
     16,384 × 4,096 pair; then each against its plain version, as in 4,
     bound by bytes with the nested loop's 2·n_p·n_b operations beside it,
     and each pair's arm (`match_plan`'s), device time and device
     operations a call; then both on the cell's B columns, R's valid rows
     against S's (2^21 × 2^21, the device arm), held against numpy (Σ
     counts = the cell's exact join size; the plain version is not run);
  3b. the same cell on the staged map + sort-merge reduce
     (`fuse_map=False, hash_reduce=False`), counts zeroed just before its
     `prepare` + first `run_batch` and read just after: zero overflow, the
     exact join size, rows `torch.equal` to phase 3's, no new step on a
     second batch, the warm batch time and a profile that must name
     segment_scan's and bucket_pack's kernels;
  4b. the staged arm's kernels (route_cells, fold_cells, bucket_pack,
     segment_scan / run_lengths) against their plain versions at the
     shapes of that run, bit for bit, with kernel, plain, bound and (where
     one PyTorch call computes the function) library times, and the
     device times of route_cells and fold_cells; bucket_pack
     on R (the entry) and S, segment_scan and run_lengths also with their
     device time and each of their kernels' share;
  5. the paper's running example and a 4-way chain at a few thousand rows,
     k ∈ {64, 256}, n_dev = 8, under all four arms (fused | staged map ×
     hash | sort-merge reduce), against the numpy reference join, with the
     exact launch counts of each run checked;
  7. the MoE serving path of the LM scaffold: mixtral-8x22b at its
     published widths with its depth cut from 56 to 4 layers, bf16 weights
     (about 40 GB) drawn from a seeded generator on the card, the join
     phases' memory freed first.  Launch counts are zeroed just before 7a
     and read just after 7b.
     7a. `api.forward` and `build_prefill` on 4 prompts of 2,048 tokens
         (chunked attention, capacity clamping): finite last-position
         logits; the expert loads sum to B·S·K·L and are `torch.equal` to
         the same call with `use_kernels=False`;
     7b. a `ServingEngine` of 8 slots (max_seq 512) serves 24 seeded
         requests (prompts 16-128 tokens, 16-64 new tokens): each completes
         with its max_new_tokens, tokens_out is their sum, and
         segment_histogram launched (model calls) x (layers) times; ticks,
         median tick, decode tokens/s, prefill time, peak memory, the bound
         of a tick and a profile of decode steps;
     7c. segment_histogram against its plain version, bit for bit, on this
         run's decode and prefill inputs (8 bins; one block) and on 2^24
         values at 384 bins (the grid) and 2^22 and 2^16 at 2^16 bins (the
         cluster arm, several clusters and one), with its arm and kernel,
         device, plain, library and bound times; a profile of the decode
         call must show one device operation;
  8. one JSON line of per-kernel results (each with the path its launches
     were counted on), then the last line {"ok": true, "device": {...}}.

Exits non-zero without printing a result when no CUDA device is present or
when the repository's `src/repro_torch` is not beside this script.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate (NVIDIA data sheet)
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet), an
# FMA counted as two operations.  int32 operations issue at a quarter of it
# (64 INT32 lanes an SM): a bound by operations here understates an int32
# loop's floor by up to 4x.
OPS_PER_S = 67e12

FULL = dict(n=1 << 21, hh_rows=12288, tail_domain=1 << 20, k=256, n_dev=8)
MODERATE = [  # (query name, rows per relation, domain, skew)
    ("running_example", 3000, 1 << 16, {"B": 1.5}),
    ("chain4", 3000, 1 << 16, {"X2": 1.5}),
]
FUSED_HASH, STAGED_SORT = "fused+hash", "staged+sort"
LIBRARY = "library"
MOE_SERVE = "moe_serve"
# The config fields of each arm.
ARMS = {FUSED_HASH: {}, "fused+sort": {"hash_reduce": False},
        "staged+hash": {"fuse_map": False}, STAGED_SORT: {"fuse_map": False,
                                                         "hash_reduce": False}}
# Where each ported kernel lives, which TPU kernel (Pallas call) it
# replaces, and the full-size path its launches are read on.
KERNEL_SITES = {
    "map_count": ("src/repro_torch/kernels/csrc/map_pack.cu",
                  "src/repro/kernels/map_pack.py:298", FUSED_HASH),
    "scatter_pack": ("src/repro_torch/kernels/csrc/scatter_pack.cu",
                     "src/repro/kernels/scatter_pack.py:149", FUSED_HASH),
    "join_hash": ("src/repro_torch/kernels/csrc/join_probe.cu",
                  "src/repro/kernels/join_probe.py:195", FUSED_HASH),
    "build_table": ("src/repro_torch/kernels/csrc/join_probe.cu",
                    "src/repro/kernels/join_probe.py:234", FUSED_HASH),
    # XLA in the reference, no pallas_call: `probe_tables` and its
    # while_loop `_chain_probe` (:328).
    "probe_tables": ("src/repro_torch/kernels/csrc/probe_tables.cu",
                     "src/repro/kernels/join_probe.py:426", FUSED_HASH),
    "expand_rows": ("src/repro_torch/kernels/csrc/expand_rows.cu",
                    "src/repro/kernels/scatter_pack.py:246", FUSED_HASH),
    "route_cells": ("src/repro_torch/kernels/csrc/route_cells.cu",
                    "src/repro/kernels/route_cells.py:96", STAGED_SORT),
    "fold_cells": ("src/repro_torch/kernels/csrc/route_cells.cu",
                   "src/repro/kernels/route_cells.py:66", STAGED_SORT),
    "bucket_pack": ("src/repro_torch/kernels/csrc/bucket_pack.cu",
                    "src/repro/kernels/bucket_pack.py:84", STAGED_SORT),
    "segment_scan": ("src/repro_torch/kernels/csrc/build_probe.cu",
                     "src/repro/kernels/build_probe.py:152", STAGED_SORT),
    "map_pack": ("src/repro_torch/kernels/csrc/map_pack.cu",
                 "src/repro/kernels/map_pack.py:225", LIBRARY),
    "hash_partition": ("src/repro_torch/kernels/csrc/hash_partition.cu",
                       "src/repro/kernels/hash_partition.py:90", LIBRARY),
    "match_counts": ("src/repro_torch/kernels/csrc/build_probe.cu",
                     "src/repro/kernels/build_probe.py:99", LIBRARY),
    "first_match": ("src/repro_torch/kernels/csrc/build_probe.cu",
                    "src/repro/kernels/build_probe.py:127", LIBRARY),
    "segment_histogram": ("src/repro_torch/kernels/csrc/segment_histogram.cu",
                          "src/repro/kernels/segment_histogram.py:36",
                          MOE_SERVE),
}
# The CUDA kernels of build_table (csrc/join_probe.cu), scatter_pack
# (csrc/scatter_pack.cu) and probe_tables (csrc/probe_tables.cu), named in
# the fused + hash profile wherever they rank; each must appear there.  The
# plain probe's row-wise cumsum must not.
BUILD_KERNELS = ("digit_tile_kernel", "tile_carry_kernel")
SCATTER_KERNELS = ("scatter_count_kernel", "scatter_rank_kernel",
                   "scatter_fill_kernel")
PROBE_KERNELS = ("probe_starts_kernel", "probe_place_kernel",
                 "probe_walk_kernel", "probe_merge_kernel",
                 "probe_rank_kernel", "probe_perm_kernel",
                 "probe_left_kernel")
TORCH_SCAN = "tensor_kernel_scan_innermost_dim"
# Torch ops that map_pack's card path must not run (the plain assembly's).
BANNED_PACK_OPS = ("scatter", "gather", "cat", "arange")
# The CUDA kernels of segment_scan / run_lengths (csrc/build_probe.cu) and
# of bucket_pack (csrc/bucket_pack.cu; its -1 fill is common.cuh's), each of
# which must appear in the staged + sort profile.
SCAN_KERNELS = ("seg_scan_kernel", "seg_tail_kernel")
BUCKET_KERNELS = ("bucket_count_kernel", "bucket_rank_kernel",
                  "scatter_fill_kernel")
# Phase 7: mixtral-8x22b at its published widths, depth cut to 4 layers;
# weights bf16 from a seeded generator on the card.
MOE = dict(arch="mixtral-8x22b", n_layers=4, seed=0, prefill_batch=4,
           prefill_len=2048, prefill_reps=3, slots=8, max_seq=512,
           n_requests=24, prompt_len=(16, 128), new_tokens=(16, 64),
           profile_ticks=5)
# Phase 7c's larger histograms: (values, bins) — kimi-k2's 384 experts
# (the grid arm), and 2^16 bins (past one block's shared memory: the
# cluster arm, at 2^22 values on several clusters, at 2^16 on one).
HIST_SHAPES = [(1 << 24, 384), (1 << 22, 1 << 16), (1 << 16, 1 << 16)]
# The kernel library phase's random pair: the shape and key range the JAX
# package's `kernel_throughput` table times match_counts at.
RANDOM_PAIR = dict(n_keys=1 << 20, n_probe=1 << 14, n_build=1 << 12,
                   key_range=1 << 30)
# probe_tables' deep-round shapes, timed in phase 4 beside the cell's:
# (B, n_l, n_r, w, n_bits, keys) with 1-2 bits, so a bucket holds
# thousands of keys (the last one past 1,024).
DEEP_PROBES = [(2, 3000, 8000, 2, 1, "wide"), (2, 3000, 8000, 1, 2, "wide"),
               (3, 5000, 20000, 2, 2, "few"), (2, 3000, 20000, 2, 1, "wide")]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of bytes over the memory rate
    and operations over the scalar rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def route_work(rows, spec, k: int) -> tuple[int, int, int]:
    """(bytes read, operations, member copies) that routing every copy of
    `rows` needs: each row read once (a padding row's first column only);
    per copy its membership tests (padding, eq, not-in); per member copy
    five operations per hashed axis (two multiplies, shift, stride multiply,
    add), the replica offset and the wrap mod k."""
    from repro_torch.core.executor import INVALID
    from repro_torch.kernels import map_pack as mp
    flat = rows.reshape(-1, rows.shape[-1])
    n = flat.shape[0]
    n_pad = int((flat[:, 0] == INVALID).sum())
    n_bytes = (n - n_pad) * flat.shape[1] * 4 + n_pad * 4
    _, valid = mp._route_block(flat, spec, k)                 # (n, F)
    members = valid.sum(0).tolist()
    n_ops, j = 0, 0
    for hashed, reps, _, eqs, notins in spec:
        n_hashed = sum(1 for h in hashed if h[2] != 1)
        n_tests = 1 + len(eqs) + sum(len(v) for _, v in notins)
        for _ in reps:
            n_ops += n * n_tests + members[j] * (5 * n_hashed + 2)
            j += 1
    return n_bytes, n_ops, sum(members)


def covered_positions(counts, lo, n_r: int) -> int:
    """Distinct perm positions that the expansion reads: the union over
    left rows with matches of [lo, lo + counts), per batch."""
    b = counts.shape[0]
    m = counts > 0
    base = torch.arange(b, device=counts.device)[:, None] * (n_r + 1)
    diff = torch.zeros(b * (n_r + 1), dtype=torch.int64, device=counts.device)
    diff.index_add_(0, (base + lo.long())[m], torch.ones_like(lo.long()[m]))
    diff.index_add_(0, (base + lo.long() + counts.long())[m],
                    -torch.ones_like(lo.long()[m]))
    return int((torch.cumsum(diff.view(b, n_r + 1), 1) > 0).sum())


def time_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` calls after one warm-up, from
    CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, split: str = "") -> float:
    """Device time per call of `fn`: from torch.profiler's trace of
    `iters` calls after one warm-up, the sum over its CUDA kernels and
    memsets of each one's mean time times its launches per call (its count
    over `iters`, rounded: the profiler can drop a few events, most often
    the last call's).  Unlike `time_ms` it does not count the card waiting
    for the host, which sets the floor of a call that takes microseconds on
    the card.  With `split` (a label), each kernel's device time per call
    is printed too.  A trace that holds no device event is taken again, up
    to three times in all, and then fails."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if "CUDA" in str(getattr(e, "device_type", ""))
                  and e.self_device_time_total > 0]
        if events:
            break
    check(bool(events), "device_ms: three traces held no device event")
    per_call = {e.key: e.self_device_time_total / 1e3 / e.count
                * max(1, round(e.count / iters)) for e in events}
    if split:
        for key, ms in sorted(per_call.items(), key=lambda kv: -kv[1]):
            print(f"[kernel] {split}: {ms:.4f} ms a call, {key[:70]}")
    return sum(per_call.values())


def call_profile(fn, calls: int = 10) -> tuple[set[str], dict[str, int]]:
    """(names of every op, CPU and device; launches of each device operation
    (kernel or memset) by name) in a torch.profiler trace of `calls` warm
    calls of `fn`: several, since the profiler can drop a call's device
    events.  A trace that holds no device event is taken again, up to three
    times in all, and then fails."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        device = {e.key: e.count for e in events
                  if "CUDA" in str(getattr(e, "device_type", ""))
                  and e.self_device_time_total > 0}
        if device:
            return {e.key for e in events}, device
    fail("call_profile: three traces held no device event")


def out_capacity_from_fragments(frag_l, frag_r, lcols, rcols, quantize):
    """Max over destinations of Σ c_L·c_R over equal join keys of the
    received fragments (two-relation cascade), quantized: the exact output
    rows the reduce must hold per destination."""
    worst = 0
    for d in range(frag_l.shape[0]):
        lk = frag_l[d][frag_l[d, :, -1] >= 0][:, lcols].long()
        rk = frag_r[d][frag_r[d, :, -1] >= 0][:, rcols].long()
        if not len(lk) or not len(rk):
            continue
        lkey = (lk[:, 0] << 32) | lk[:, 1]
        rkey = (rk[:, 0] << 32) | rk[:, 1]
        uk, cl = torch.unique(lkey, return_counts=True)
        pos = torch.searchsorted(uk, rkey).clamp(max=len(uk) - 1)
        worst = max(worst, int(cl[pos[uk[pos] == rkey]].sum()))
    return quantize(max(worst, 1))


def profile_calls(fn, label: str, calls: int = 1, top: int = 12,
                  tag: str = "profile", named: tuple[str, ...] = (),
                  banned: tuple[str, ...] = ()) -> set[str]:
    """Where `calls` warm calls of `fn` spend device time: torch.profiler's
    per-kernel sums, and the device-busy share of their wall time; then
    every kernel whose name holds one of `named` or `banned`, in the top or
    not.  A trace that holds no device event, or misses a kernel of `named`
    (the profiler can drop events), is taken again, up to three times in
    all.  Returns the names of `named` and `banned` that some kernel's name
    holds."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                r = fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        del r
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) is not None
                  and "CUDA" in str(e.device_type)]
        if events and all(any(name in e.key for e in events)
                          for name in named):
            break
    busy_us = sum(e.self_device_time_total for e in events)
    if not events or busy_us <= 0:
        print(f"[{tag}] device time not measured (no CUDA events)")
        return set()
    print(f"[{tag}] {label}: wall {wall_us / 1e3:.2f} ms, device "
          f"busy {busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f} %), "
          f"idle share {100 * (1 - busy_us / wall_us):.1f} %")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:90]}")
    found = set()
    for e in events:
        hits = {name for name in named + banned if name in e.key}
        if hits:
            found |= hits
            print(f"[{tag}]   named: {e.self_device_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<4d} {e.key[:90]}")
    return found


def expected_launches(ex, fields) -> dict[str, int]:
    """Kernel launches of one prepare (one counting pass, as k > n_dev) and
    one run_batch under the arm `fields`: the fused map counts and packs
    each relation once; the staged map routes once per (relation, route
    with hashed attributes) in prepare and again in the step, and folds
    and packs each relation once; each cascade step hashes, builds, probes
    and expands once (hash), or scans twice (group ids, run lengths) and
    expands once (sort-merge)."""
    n_rel = len(ex.query.relations)
    steps = n_rel - 1
    want = dict.fromkeys(KERNEL_SITES, 0)
    if fields.get("fuse_map", True):
        want.update(map_count=n_rel, scatter_pack=n_rel)
    else:
        hashed = sum(1 for spec in ex.route_specs.values()
                     for route in spec if route[0])
        want.update(route_cells=2 * hashed, fold_cells=n_rel,
                    bucket_pack=n_rel)
    if fields.get("hash_reduce", True):
        want.update(join_hash=steps, build_table=steps, probe_tables=steps,
                    expand_rows=steps)
    else:
        want.update(segment_scan=2 * steps, expand_rows=steps)
    return want


def warm_batches(ex, s, label: str, exact: int) -> None:
    """No new step on a second batch; the warm run_batch median of 7."""
    compiles = ex.compile_count
    res2 = s.run_batch()
    check(ex.compile_count == compiles, f"{label}: second run_batch built "
          f"a new step")
    del res2
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = s.run_batch()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del r
    t_batch = float(np.median(times))
    print(f"[{label}] warm run_batch median {t_batch * 1e3:.1f} ms of "
          f"{len(times)} ({', '.join(f'{t * 1e3:.1f}' for t in times)}); "
          f"{exact / t_batch:.4g} joined rows/s")


def full_cell(dev):
    """Phase 3: the full-size cell through prepare + run_batch on kernels."""
    from repro_torch.core import plan_skew_join, two_way
    from repro_torch.core.executor import (ExecutorConfig,
                                           ShardedJoinExecutor, exchange,
                                           quantize_capacity, shared_columns)
    from repro_torch.data import drifting_join_batch
    from repro_torch.kernels import ops

    q = two_way()
    t0 = time.perf_counter()
    data = drifting_join_batch(q, FULL["n"], FULL["hh_rows"],
                               FULL["tail_domain"], hot_set=(), hot_bonus=0,
                               seed=0)
    plan = plan_skew_join(q, data, FULL["k"])
    t_plan = time.perf_counter() - t0
    cr = np.bincount(data["R"][:, 1])
    cs = np.bincount(data["S"][:, 0])
    m = min(len(cr), len(cs))
    exact = int((cr[:m].astype(np.int64) * cs[:m]).sum())
    print(f"[cell] two_way n={FULL['n']} per relation, k={FULL['k']}, "
          f"n_dev={FULL['n_dev']}: HH {dict(plan.hhs.per_attr)}, "
          f"{len(plan.residuals)} residuals, planned in {t_plan:.2f} s; "
          f"exact join size {exact}")

    # Size the output capacity from the received fragments (not counted).
    n_dev = FULL["n_dev"]
    sizing = ShardedJoinExecutor(plan, n_dev, ExecutorConfig(), device=dev)
    s0 = sizing.session().prepare(data)
    frags = {}
    for rel, a in zip(q.relations, s0._device_args):
        buf, _ = ops.scatter_pack(a.view(n_dev, -1, a.shape[1]),
                                  sizing.route_specs[rel.name], s0._ptable,
                                  plan.k, n_dev, s0.caps[rel.name])
        frags[rel.name] = exchange(buf)
    lcols, rcols = shared_columns(["A", "B", "__cell__"],
                                  ["B", "C", "__cell__"])
    cap_out = out_capacity_from_fragments(frags["R"], frags["S"], lcols,
                                          rcols, quantize_capacity)
    del frags, sizing, s0
    torch.cuda.empty_cache()
    print(f"[cell] out_capacity per destination {cap_out} "
          f"(exact per-destination max, quantized)")

    # The main path: counts zeroed just before, read just after.
    ex = ShardedJoinExecutor(plan, n_dev,
                             ExecutorConfig(out_capacity=cap_out), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    s = ex.session().prepare(data)
    torch.cuda.synchronize()
    t_prepare = time.perf_counter() - t0
    prepare_launches = dict(ops.LAUNCHES)
    res = s.run_batch()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_launches = {k: launches[k] - prepare_launches[k] for k in launches}
    print(f"[cell] launches on the main path {launches} "
          f"(per run_batch {step_launches})")
    want = expected_launches(ex, ARMS[FUSED_HASH])
    check(launches == want,
          f"main path launches {launches}, expected {want}")
    check(int(res["shuffle_overflow"].sum()) == 0,
          f"shuffle overflow {res['shuffle_overflow_by_rel'].tolist()}")
    check(int(res["join_overflow"].sum()) == 0,
          f"join overflow {res['join_overflow'].tolist()}")
    n_valid = int(res.tensors[1].sum())
    check(n_valid == exact, f"valid rows {n_valid} != exact {exact}")

    caps = dict(s.caps)
    w_out = len(q.attributes)
    held = {
        "relations": sum(nbytes(a) for a in s._device_args),
        "send+recv buffers": sum(2 * n_dev * n_dev * caps[r.name]
                                 * (len(r.attrs) + 1) * 4 for r in q.relations),
        "output rows and valid flags": n_dev * cap_out * (w_out * 4 + 1),
    }
    print(f"[cell] caps {caps}; bytes the step holds (reckoned) "
          f"{held} = {sum(held.values()) / 1e9:.2f} GB; peak allocated "
          f"(measured) {peak / 1e9:.2f} GB")

    print(f"[cell] prepare {t_prepare * 1e3:.1f} ms")
    warm_batches(ex, s, "cell", exact)
    must = BUILD_KERNELS + SCATTER_KERNELS + PROBE_KERNELS
    named = profile_calls(s.run_batch, "warm run_batch", named=must,
                          banned=(TORCH_SCAN,))
    check(named == set(must), f"the warm batch's profile misses "
          f"{set(must) - named} or holds {named - set(must)}")

    # The same step on the plain versions, on the card.
    out_k, valid_k = res.tensors[0], res.tensors[1]
    del res
    ex_plain = ShardedJoinExecutor(
        plan, n_dev, ExecutorConfig(out_capacity=cap_out, use_kernels=False),
        device=dev)
    s_plain = ex_plain.session().prepare(data)
    check(s_plain.caps == caps, "plain prepare derived other caps")
    check(np.array_equal(s_plain.placement.table, s.placement.table),
          "plain prepare derived another placement")
    res_p = s_plain.run_batch()
    check(torch.equal(res_p.tensors[0], out_k)
          and torch.equal(res_p.tensors[1], valid_k),
          "kernel rows differ from the plain path's")
    print("[cell] rows equal the plain path's (torch.equal), zero overflow, "
          "exact join size, no new step on the second batch: ok")
    del res_p, s_plain, ex_plain
    torch.cuda.empty_cache()
    return dict(plan=plan, ex=ex, session=s, launches=launches,
                cap_out=cap_out, exact=exact, data=data, rows=out_k,
                valid=valid_k)


def record(out, name, kern, plain, args, n_bytes, n_ops, iters,
           library=None):
    """Hold `kern` against `plain` on `args` bit for bit and put their
    times, the bound and `library`'s time (one PyTorch call computing the
    same function, or None) in out[name]; returns the kernel's outputs."""
    got, want = kern(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"{name}: shape {g.shape} != {w.shape}")
        if not torch.equal(g, w.to(g.dtype)):
            err = max(err, int((g.long() - w.long()).abs().max()))
    check(err == 0, f"{name}: kernel differs from plain (max {err})")
    ms = time_ms(lambda: kern(*args), iters)
    plain_ms = time_ms(lambda: plain(*args), max(iters // 2, 2))
    library_ms = None if library is None else time_ms(library, iters)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms)
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    print(f"[kernel] {name}: equal to plain; {ms:.4f} ms (plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}: "
          f"{n_bytes} bytes, {n_ops} operations{lib})")
    return got


def deep_probe_inputs(dev, b, n_l, n_r, w, bits, keys, seed):
    """probe_tables' inputs (lk, l_bkt, rk, r_bkt, rank, hist, bits) on the
    card from join_hash's and build_table's plain versions, with keys
    "wide" (30-bit values, mostly distinct) or "few" (31 values a column):
    valid rows 26 % on the right (the cell's share), 80 % on the left, half
    the left rows a right row's keys."""
    from repro_torch.kernels import join_probe as jp
    gen = torch.Generator(device=dev).manual_seed(seed)
    high = 31 if keys == "few" else 1 << 30
    lk = torch.randint(0, high, (b, n_l, w), generator=gen, device=dev,
                       dtype=torch.int32)
    rk = torch.randint(0, high, (b, n_r, w), generator=gen, device=dev,
                       dtype=torch.int32)
    pick = torch.randint(0, n_r, (b, n_l // 2), generator=gen, device=dev)
    lk[:, : n_l // 2] = torch.gather(rk, 1, pick[..., None].expand(-1, -1, w))
    lv = torch.rand((b, n_l), generator=gen, device=dev) < 0.8
    rv = torch.rand((b, n_r), generator=gen, device=dev) < 0.26
    return (lk, jp.join_hash_host(lk, lv, bits), rk,
            *jp.build_table_host(rk, rv, bits), bits)


def deep_probes(dev) -> dict:
    """probe_tables at the DEEP_PROBES shapes: equal to plain, with its
    events, device time and each of its kernels' share."""
    from repro_torch.kernels import join_probe as jp
    deep = {}
    for i, (b, n_l, n_r, w, bits, keys) in enumerate(DEEP_PROBES):
        args = deep_probe_inputs(dev, b, n_l, n_r, w, bits, keys, i)
        label = f"deep {b}x{n_r} w={w} bits={bits} {keys}"
        n_rv = int((args[3] < (1 << bits)).sum())
        n_lv = int((args[1] < (1 << bits)).sum())
        dst = {}
        record(dst, "probe_tables", jp.probe_tables_cuda, jp.probe_tables_host,
               args, 4 * (3 * b * n_r + b * (1 << bits) + n_rv * w
                          + 3 * b * n_l + n_lv * w), (n_rv + n_lv) * w, 5)
        rec = deep[label] = dst["probe_tables"]
        rec["device_ms"] = device_ms(lambda args=args: jp.probe_tables_cuda(
            *args), 5, split=f"probe_tables {label}")
        print(f"[kernel] probe_tables {label}: device "
              f"{rec['device_ms']:.4f} ms")
    return deep


def kernel_checks(cell):
    """Phase 4: each kernel against its plain version at the cell's shapes."""
    from repro_torch.core.executor import (INVALID, exchange, shared_columns,
                                           step_columns)
    from repro_torch.kernels import join_probe as jp
    from repro_torch.kernels import map_pack as mp
    from repro_torch.kernels import scatter_pack as sp

    ex, s, plan = cell["ex"], cell["session"], cell["plan"]
    n_dev, k = ex.n_devices, ex.k
    rows_r, rows_s = s._device_args
    spec_r, spec_s = ex.route_specs["R"], ex.route_specs["S"]
    out = {}

    # map_count and scatter_pack on both relations; the row kept for each
    # is R's (fanout 17).  Bytes: the rows, the (k,) table, the outputs in
    # full (the pack buffer's -1 padding is output).  Operations: routing,
    # plus one histogram add per member copy.
    # Each with its device time and each of its kernels' share.
    counted = {}
    for name, rows, spec in (("S", rows_s, spec_s), ("R", rows_r, spec_r)):
        r_bytes, r_ops, members = route_work(rows, spec, k)
        dst = {}
        record(dst, "map_count", mp.map_count_cuda, mp.map_count_host,
               (rows, spec, k, n_dev), r_bytes + n_dev * k * 4,
               r_ops + members, 10)
        rec = counted[name] = dst["map_count"]
        rec["device_ms"] = device_ms(
            lambda rows=rows, spec=spec: mp.map_count_cuda(rows, spec, k,
                                                           n_dev), 10,
            split=f"map_count {name}")
        print(f"[kernel] map_count {name}: device {rec['device_ms']:.4f} ms "
              f"(bound {rec['bound_ms']:.4f} ms)")
    out["map_count"] = dict(counted["R"], S=counted["S"])
    # scatter_pack's entry is R's, with S's and R's on one device (every
    # member copy through a placement table of zeros, at a cap that holds
    # them all and at the cell's cap, which overflows) beside it; each with
    # its device time.
    frags, packs = {}, {}

    def pack(label, rows3, spec, ptable, cap):
        r_bytes, r_ops, members = route_work(rows3, spec, k)
        dst = {}
        buf, over = record(dst, "scatter_pack", sp.scatter_pack_cuda,
                           sp.scatter_pack_host,
                           (rows3, spec, ptable, k, n_dev, cap),
                           r_bytes + nbytes(ptable) + 4 * n_dev
                           + n_dev * n_dev * cap * (rows3.shape[2] + 1) * 4,
                           r_ops + members, 10)
        rec = packs[label] = dst["scatter_pack"]
        rec["device_ms"] = device_ms(lambda: sp.scatter_pack_cuda(
            rows3, spec, ptable, k, n_dev, cap), 10,
            split=f"scatter_pack {label}")
        print(f"[kernel] scatter_pack {label}: device {rec['device_ms']:.4f} "
              f"ms, cap {cap}, overflow {int(over.sum())}")
        return buf, over

    for name, rows, spec in (("S", rows_s, spec_s), ("R", rows_r, spec_r)):
        rows3 = rows.view(n_dev, -1, rows.shape[1])
        buf, _ = pack(name, rows3, spec, s._ptable, s.caps[name])
        frags[name] = exchange(buf)
    rows3 = rows_r.view(n_dev, -1, rows_r.shape[1])
    zeros = torch.zeros_like(s._ptable)
    per_src = int(mp._route_block(rows3, spec_r, k)[1].sum((1, 2)).max())
    check(per_src > s.caps["R"], "scatter_pack: the cell's cap holds R's "
          "copies on one device")
    _, over = pack("R one device, cap fits", rows3, spec_r, zeros, per_src)
    check(int(over.sum()) == 0, "scatter_pack one device: overflow at a cap "
          "that fits")
    _, over = pack("R one device, cap overflows", rows3, spec_r, zeros,
                   s.caps["R"])
    check(int(over.sum()) > 0, "scatter_pack one device: no overflow")
    out["scatter_pack"] = dict(packs["R"], S=packs["S"], one_device={
        "fits": packs["R one device, cap fits"],
        "overflow": packs["R one device, cap overflows"]})
    acc, right = frags["R"], frags["S"]
    lcols, rcols = shared_columns(["A", "B", "__cell__"],
                                  ["B", "C", "__cell__"])
    lk = acc[..., lcols].contiguous()
    rk = right[..., rcols].contiguous()
    lv, rv = acc[..., -1] != INVALID, right[..., -1] != INVALID
    bits = jp.default_bits(rk.shape[1])
    # The hashes read a row's keys only when its valid flag is set: bytes
    # are the flags, the valid rows' keys and the outputs; operations are
    # w multiplies, w - 1 adds, the MULT multiply and the shift per valid
    # row, plus one rank add per row for the build.
    w_key = lk.shape[2]
    n_lv, n_rv = int(lv.sum()), int(rv.sum())
    (bl,) = record(out, "join_hash", jp.join_hash_cuda, jp.join_hash_host,
                   (lk, lv, bits), lv.numel() + n_lv * w_key * 4
                   + lv.numel() * 4, n_lv * (2 * w_key + 1), 20)
    out["join_hash"]["device_ms"] = device_ms(
        lambda: jp.join_hash_cuda(lk, lv, bits))
    print(f"[kernel] join_hash: device {out['join_hash']['device_ms']:.4f} "
          f"ms (bound {out['join_hash']['bound_ms']:.4f} ms)")
    build_bytes = (rv.numel() + n_rv * w_key * 4 + 2 * rv.numel() * 4
                   + n_dev * (1 << bits) * 4)
    build_ops = n_rv * (2 * w_key + 1) + rv.numel()
    br, rank, hist = record(out, "build_table", jp.build_table_cuda,
                            jp.build_table_host, (rk, rv, bits), build_bytes,
                            build_ops, 10)
    # The heavy hitter's shape: every valid row of a destination carries
    # the keys of one B = 0 row, so all of them land in one bucket.  Same
    # bytes and operations as the cell's input.
    hh_rows = rv & (rk[..., 0] == 0)
    check(bool(hh_rows.any()), "build_table: no heavy-hitter row on the right")
    rk_one = torch.where(rv[..., None], rk[hh_rows][0], rk).contiguous()
    one = {}
    table_one = record(one, "build_table", jp.build_table_cuda,
                       jp.build_table_host, (rk_one, rv, bits), build_bytes,
                       build_ops, 10)
    for dst, keys, label in ((out, rk, "cell"), (one, rk_one, "one bucket")):
        dst["build_table"]["device_ms"] = device_ms(
            lambda keys=keys: jp.build_table_cuda(keys, rv, bits), 10)
        print(f"[kernel] build_table {label}: device "
              f"{dst['build_table']['device_ms']:.4f} ms")
    out["build_table"]["one_bucket"] = one["build_table"]
    # probe_tables on the cell's tables (the main path's call) and on the
    # hot bucket's (the cell's left side against rk_one: ~270K rows of one
    # key a destination).  Bytes: r_bkt, rank, hist, the valid right keys,
    # l_bkt and the valid left keys read once; perm, counts and lo written.
    # Operations: a compare per key column of each valid row on either side.
    probe_bytes = 4 * (3 * rv.numel() + hist.numel() + n_rv * w_key
                       + 3 * lv.numel() + n_lv * w_key)
    probe_ops = (n_rv + n_lv) * w_key
    for dst, args, label in (
            (out, (lk, bl, rk, br, rank, hist, bits), "cell"),
            (one, (lk, bl, rk_one, *table_one, bits), "hot bucket")):
        got = record(dst, "probe_tables", jp.probe_tables_cuda,
                     jp.probe_tables_host, args, probe_bytes, probe_ops, 10)
        rec = dst["probe_tables"]
        rec["device_ms"] = device_ms(
            lambda args=args: jp.probe_tables_cuda(*args), 10,
            split=f"probe_tables {label}")
        print(f"[kernel] probe_tables {label}: device {rec['device_ms']:.4f} "
              f"ms (bound {rec['bound_ms']:.4f} ms), max count "
              f"{int(got[0].max())}")
        if label == "cell":
            counts, lo, perm = got
    out["probe_tables"]["hot_bucket"] = one["probe_tables"]
    out["probe_tables"]["deep_rounds"] = deep_probes(lk.device)
    del rk_one, one, hh_rows, table_one, got
    cap_out = cell["cap_out"]
    del frags, bl, br, rank, hist, lk, rk
    torch.cuda.empty_cache()
    # The expansion reads counts in full, lo and the used left columns of
    # every row with matches, and the perm entries and used right columns
    # of matched windows; it writes the whole (B, cap, n_cols) output and
    # the valid flags.  Operations: the scan of counts, and per item of
    # each destination's merge (its rows and its slots up to the total or
    # cap) a compare and an add.  The main path's call takes the final
    # step's columns; the full expansion (cols=None) is kept beside it.
    n_b, n_l, wl = acc.shape
    wr = right.shape[2]
    n_hit = int((counts > 0).sum())
    n_cov = covered_positions(counts, lo, right.shape[1])
    slots = int(torch.clamp(counts.sum(1, dtype=torch.int64), max=cap_out)
                .sum())
    n_ops = n_b * n_l + 2 * (n_b * n_l + slots)
    q = cell["plan"].query
    cols, _ = step_columns(list(q.relations[0].attrs) + ["__cell__"],
                           list(q.relations[1].attrs) + ["__cell__"],
                           q.attributes)
    args = (acc, right, counts, lo, perm, cap_out)
    full = {}
    for dst, c in ((full, None), (out, tuple(cols))):
        used = list(range(wl + wr)) if c is None else c
        n_lc = len({x for x in used if x < wl})
        n_rc = len({x for x in used if x >= wl})
        record(dst, "expand_rows",
               lambda *a, c=c: sp.expand_rows_cuda(*a, cols=c),
               lambda *a, c=c: sp.expand_rows_host(*a, cols=c), args,
               counts.numel() * 4 + n_hit * (n_lc + 1) * 4
               + n_cov * (n_rc + 1) * 4 + n_b * cap_out * (len(used) * 4 + 1),
               n_ops, 4)
        dst["expand_rows"]["device_ms"] = device_ms(
            lambda c=c: sp.expand_rows_cuda(*args, cols=c), 4)
        print(f"[kernel] expand_rows cols={c}: device "
              f"{dst['expand_rows']['device_ms']:.4f} ms")
    out["expand_rows"]["full_expansion"] = full["expand_rows"]
    return out


def library_checks(cell):
    """Phase 4c: the kernel library on the cell's data through `ops`, then
    each kernel against its plain version."""
    from repro_torch.core import executor as exm
    from repro_torch.core.executor import exchange
    from repro_torch.core.hypercube import multiply_shift
    from repro_torch.kernels import build_probe as bpr
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import map_pack as mp
    from repro_torch.kernels import ops
    from repro_torch.kernels import scatter_pack as sp

    ex, s = cell["ex"], cell["session"]
    n_dev, k = ex.n_devices, ex.k
    rows_r, rows_s = s._device_args
    specs = ex.route_specs
    # The tail residual hashes R's B (column 1) to its share.
    (seed, nb_tail), = {(h[1], h[2]) for route in specs["R"]
                        for h in route[0] if h[0] == 1 and h[2] > 1}
    rng = np.random.default_rng(0)
    keys = rng.integers(0, RANDOM_PAIR["key_range"], RANDOM_PAIR["n_keys"])
    rand_probe = torch.from_numpy(
        keys[:RANDOM_PAIR["n_probe"]].astype(np.int32)).to(rows_r.device)
    rand_build = torch.from_numpy(
        keys[:RANDOM_PAIR["n_build"]].astype(np.int32)).to(rows_r.device)
    shards = {"S": rows_s.view(n_dev, -1, rows_s.shape[1]),
              "R": rows_r.view(n_dev, -1, rows_r.shape[1])}
    b_keys = rows_r[:, 1].contiguous()

    # The library path: counts zeroed just before, read just after.
    torch.cuda.synchronize()
    ops.reset_launches()
    packed = {name: ops.map_pack(rows3, specs[name], s._ptable, k, n_dev,
                                 s.caps[name])
              for name, rows3 in shards.items()}
    flat = {name: exchange(buf).reshape(-1, buf.shape[-1])
            for name, (buf, _) in packed.items()}
    tag_r, b_r = flat["R"][:, -1], flat["R"][:, 1]
    cells = {"tail": int(tag_r[(tag_r >= 0) & (b_r != 0)][0]),
             "heavy": int(tag_r[(tag_r >= 0) & (b_r == 0)][0])}
    pairs = {label: (flat["R"][flat["R"][:, -1] == c][:, 1].contiguous(),
                     flat["S"][flat["S"][:, -1] == c][:, 0].contiguous())
             for label, c in cells.items()}
    pairs["random"] = (rand_probe, rand_build)
    hashed = {nb: ops.hash_partition(b_keys, seed, nb)
              for nb in (1 << 20, nb_tail)}
    matched = {label: (ops.match_counts(*pair), ops.first_match(*pair))
               for label, pair in pairs.items()}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    want = dict.fromkeys(KERNEL_SITES, 0)
    want.update(map_pack=2, hash_partition=2, match_counts=3, first_match=3)
    check(launches == want, f"library launches {launches}, expected {want}")
    print(f"[library] launches {launches}")

    # What came out: the pack equals scatter_pack's; the ids the planner's
    # hash; the tail cell's matches its exact join size; every heavy pair
    # matches; the random pair's counts and first indices numpy's.
    for name, rows3 in shards.items():
        buf, over = packed[name]
        want_buf, want_over = ops.scatter_pack(rows3, specs[name], s._ptable,
                                               k, n_dev, s.caps[name])
        check(torch.equal(buf, want_buf) and torch.equal(over, want_over),
              f"map_pack on {name} differs from scatter_pack")
        check(int(over.sum()) == 0, f"map_pack on {name} overflowed")
    ids = hashed[nb_tail][0].cpu().numpy()
    check(np.array_equal(ids, multiply_shift(b_keys.cpu().numpy(), seed,
                                             nb_tail)),
          "hash_partition ids differ from multiply_shift")
    for _, hist in hashed.values():
        check(int(hist.sum()) == b_keys.shape[0], "hash_partition histogram")
    probe, build = (x.cpu().numpy() for x in pairs["tail"])
    cr, cs = np.bincount(probe), np.bincount(build)
    m = min(len(cr), len(cs))
    tail_exact = int((cr[:m].astype(np.int64) * cs[:m]).sum())
    check(int(matched["tail"][0].sum()) == tail_exact,
          f"tail cell Σ match_counts != {tail_exact}")
    counts_h, first_h = matched["heavy"]
    check(bool((counts_h == pairs["heavy"][1].shape[0]).all())
          and bool((first_h == 0).all()), "heavy cell: not every pair matched")
    probe, build = (x.cpu().numpy() for x in pairs["random"])
    uniq, first_idx, cnt = np.unique(build, return_index=True,
                                     return_counts=True)
    pos = np.clip(np.searchsorted(uniq, probe), 0, len(uniq) - 1)
    hit = uniq[pos] == probe
    check(np.array_equal(matched["random"][0].cpu().numpy(),
                         np.where(hit, cnt[pos], 0))
          and np.array_equal(matched["random"][1].cpu().numpy(),
                             np.where(hit, first_idx[pos], -1)),
          "random pair: matches differ from numpy's")
    sizes = {label: tuple(x.shape[0] for x in pair)
             for label, pair in pairs.items()}
    print(f"[library] map_pack == scatter_pack on R and S, zero overflow; "
          f"hash_partition ids == multiply_shift at nb={nb_tail}; pairs "
          f"(probe, build) {sizes} of cells {cells}; tail Σ counts = "
          f"{tail_exact}; every heavy pair matches; random pair == numpy")
    del packed, flat, hashed

    # Each kernel against its plain version; the kept row of each is
    # map_pack on R, hash_partition at the tail share, match_counts and
    # first_match on the tail cell (the heavy, random and B-column pairs
    # under it).
    out, extra, packs = {}, {}, {}
    for name, rows3 in shards.items():
        spec, cap = specs[name], s.caps[name]
        args = (rows3, spec, s._ptable, k, n_dev, cap)
        r_bytes, r_ops, members = route_work(rows3, spec, k)
        record(out, "map_pack", mp.map_pack_cuda, mp.map_pack_host, args,
               r_bytes + nbytes(s._ptable) + 4 * n_dev
               + n_dev * n_dev * cap * (rows3.shape[2] + 1) * 4,
               r_ops + members, 10)

        def staged():
            dest, tagged = exm._route_relation(rows3, spec, k, True)
            phys = exm._fold_dests(dest, s._ptable, True)
            return exm._pack_buckets(phys, tagged, n_dev, cap, True)
        t_scatter = time_ms(lambda: sp.scatter_pack_cuda(*args), 10)
        t_staged = time_ms(staged, 5)
        # The card path's device time, each kernel's share (streams:
        # pack_count, scan, pack_rank; assembly: pack_assemble; fill:
        # scatter_fill; overflow), and its streams alone.
        rec = dict(out["map_pack"])
        rec["device_ms"] = device_ms(lambda: mp.map_pack_cuda(*args), 5,
                                     split=f"map_pack {name}")
        rec["streams_device_ms"] = device_ms(
            lambda: mp.map_pack_streams_cuda(*args[:5]), 5)
        names, device = call_profile(lambda: mp.map_pack_cuda(*args), 1)
        torch_ops = sorted(n for n in names if any(
            n.startswith(f"aten::{op}") for op in BANNED_PACK_OPS))
        check(not torch_ops, f"map_pack on {name}: torch ops {torch_ops} on "
              f"the card path")
        packs[name] = rec
        print(f"[library] {name}: map_pack {rec['ms']:.4f} ms, device "
              f"{rec['device_ms']:.4f} ms in {len(device)} device operations "
              f"(streams {rec['streams_device_ms']:.4f} ms; no aten "
              f"{'/'.join(BANNED_PACK_OPS)}), scatter_pack {t_scatter:.4f} "
              f"ms, staged route -> fold -> pack {t_staged:.4f} ms")
    out["map_pack"] = dict(packs["R"], S=packs["S"])
    # The small kernels' event times sit near the host's per-call floor;
    # their device times are printed beside them.
    n = b_keys.shape[0]
    for nb, dst in ((1 << 20, extra), (nb_tail, out)):
        args = (b_keys, seed, nb)
        record(dst, "hash_partition", hp.hash_partition_cuda,
               hp.hash_partition_host, args, 8 * n + 4 * nb, 4 * n, 20)
        print(f"[library] hash_partition nb={nb}: device "
              f"{device_ms(lambda: hp.hash_partition_cuda(*args)):.4f} ms")
    recs = {}
    for label in ("heavy", "random", "tail"):
        probe, build = pairs[label]
        n_p, n_b = probe.shape[0], build.shape[0]
        print(f"[library] {label} pair: {n_p} x {n_b}")
        dst = recs[label] = {}
        for name, kern, plain in (
                ("match_counts", bpr.match_counts_cuda, bpr.match_counts_host),
                ("first_match", bpr.first_match_cuda, bpr.first_match_host)):
            record(dst, name, kern, plain, (probe, build),
                   *match_work(n_p, n_b), 20)
            dst[name].update(match_device(name, kern, probe, build, label))
    b_cols = b_column_pair(rows_r, rows_s, cell["exact"])
    for name in ("match_counts", "first_match"):
        out[name] = dict(recs["tail"][name], heavy=recs["heavy"][name],
                         random=recs["random"][name],
                         b_columns=b_cols[name])
    return out, launches


def match_work(n_p: int, n_b: int) -> tuple[int, int]:
    """(bytes, operations) of match_counts / first_match: each key read
    once and each output written once; a hash (two multiplies, a shift)
    and a compare a key."""
    return 4 * (2 * n_p + n_b), 4 * (n_p + n_b)


def match_device(name, kern, probe, build, label) -> dict:
    """The match kernel's arm (match_plan's), its device time and device
    operations a call, and the nested loop's 2 n_p n_b operations (the
    first version's work) beside them."""
    from repro_torch.kernels import build_probe as bpr
    n_p, n_b = probe.shape[0], build.shape[0]
    arm, slots, pbits, blocks = bpr.match_plan(n_p, n_b)
    arm = "shared" if arm == bpr.MATCH_SHARED else "device"
    ms = device_ms(lambda: kern(probe, build), split=f"{name} {label}")
    _, device = call_profile(lambda: kern(probe, build), 10)
    # Launches a call of each device operation, rounded as in device_ms.
    ops_a_call = {key[:40]: max(1, round(count / 10))
                  for key, count in device.items()}
    n_ops = sum(ops_a_call.values())
    print(f"[library] {label} pair: {name} arm {arm} ({slots} slots, "
          f"{1 << pbits} partitions, {blocks} blocks), device {ms:.4f} ms "
          f"in {n_ops} device operations a call {ops_a_call}; nested loop "
          f"{2 * n_p * n_b} operations")
    return dict(arm=arm, slots=slots, partitions=1 << pbits, device_ms=ms,
                device_ops=n_ops, nested_ops=2 * n_p * n_b)


def b_column_pair(rows_r, rows_s, exact: int) -> dict:
    """match_counts and first_match on the cell's B columns, R's valid rows
    against S's (the device arm), held against numpy: Σ counts must be the
    cell's exact join size.  The plain version's (n_p, n_b) equality tiles
    would take hours here, so it is neither run nor timed."""
    from repro_torch.core.executor import INVALID
    from repro_torch.kernels import build_probe as bpr
    probe = rows_r[rows_r[:, 0] != INVALID][:, 1].contiguous()
    build = rows_s[rows_s[:, 0] != INVALID][:, 0].contiguous()
    n_p, n_b = probe.shape[0], build.shape[0]
    counts = bpr.match_counts_cuda(probe, build)
    first = bpr.first_match_cuda(probe, build)
    check(int(counts.long().sum()) == exact,
          f"B columns: Σ match_counts {int(counts.long().sum())} != {exact}")
    p, b = probe.cpu().numpy(), build.cpu().numpy()
    uniq, first_idx, cnt = np.unique(b, return_index=True, return_counts=True)
    pos = np.clip(np.searchsorted(uniq, p), 0, len(uniq) - 1)
    hit = uniq[pos] == p
    check(np.array_equal(counts.cpu().numpy(), np.where(hit, cnt[pos], 0))
          and np.array_equal(first.cpu().numpy(),
                             np.where(hit, first_idx[pos], -1)),
          "B columns: matches differ from numpy's")
    print(f"[library] B columns pair: {n_p} x {n_b}, Σ counts = {exact} "
          f"(the exact join size), counts and first indices == numpy")
    n_bytes, n_ops = match_work(n_p, n_b)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    res = {}
    for name, kern in (("match_counts", bpr.match_counts_cuda),
                       ("first_match", bpr.first_match_cuda)):
        ms = time_ms(lambda: kern(probe, build), 10)
        res[name] = dict(n_p=n_p, n_b=n_b, ms=ms, bound_ms=bound_ms,
                         bound_by=bound_by,
                         **match_device(name, kern, probe, build,
                                        "B columns"))
        print(f"[kernel] {name} B columns: {ms:.4f} ms (device "
              f"{res[name]['device_ms']:.4f} ms; bound {bound_ms:.4f} ms by "
              f"{bound_by}: {n_bytes} bytes, {n_ops} operations; plain not "
              f"run)")
    return res


def staged_cell(dev, cell):
    """Phase 3b: the full-size cell on the staged map + sort-merge reduce,
    held against phase 3's rows."""
    from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
    from repro_torch.kernels import ops

    n_dev, exact = FULL["n_dev"], cell["exact"]
    fields = ARMS[STAGED_SORT]
    ex = ShardedJoinExecutor(cell["plan"], n_dev,
                             ExecutorConfig(out_capacity=cell["cap_out"],
                                            **fields), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    s = ex.session().prepare(cell["data"])
    torch.cuda.synchronize()
    t_prepare = time.perf_counter() - t0
    res = s.run_batch()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[staged] {STAGED_SORT} launches {launches}")
    want = expected_launches(ex, fields)
    check(launches == want, f"{STAGED_SORT} launches {launches}, "
          f"expected {want}")
    check(s.caps == cell["caps"], f"{STAGED_SORT} caps {s.caps} != "
          f"{cell['caps']}")
    check(np.array_equal(s.placement.table, cell["table"]),
          f"{STAGED_SORT} derived another placement")
    check(int(res["shuffle_overflow"].sum()) == 0,
          f"{STAGED_SORT} shuffle overflow "
          f"{res['shuffle_overflow_by_rel'].tolist()}")
    check(int(res["join_overflow"].sum()) == 0,
          f"{STAGED_SORT} join overflow {res['join_overflow'].tolist()}")
    n_valid = int(res.tensors[1].sum())
    check(n_valid == exact, f"{STAGED_SORT} valid rows {n_valid} != exact "
          f"{exact}")
    check(torch.equal(res.tensors[0], cell["rows"])
          and torch.equal(res.tensors[1], cell["valid"]),
          f"{STAGED_SORT} rows differ from {FUSED_HASH}'s")
    del res
    print(f"[staged] rows torch.equal to {FUSED_HASH}'s, zero overflow, "
          f"{n_valid} valid rows; prepare {t_prepare * 1e3:.1f} ms; peak "
          f"allocated (measured, {FUSED_HASH} rows held) {peak / 1e9:.2f} GB")
    warm_batches(ex, s, "staged", exact)
    named = profile_calls(s.run_batch, "warm run_batch",
                          named=SCAN_KERNELS + BUCKET_KERNELS)
    check(named == set(SCAN_KERNELS + BUCKET_KERNELS),
          f"kernels missing from the {STAGED_SORT} warm batch's profile: "
          f"{set(SCAN_KERNELS + BUCKET_KERNELS) - named}")
    return dict(ex=ex, session=s, launches=launches)


def staged_kernel_checks(cell):
    """Phase 4b: the staged arm's kernels against their plain versions at
    the staged cell's shapes (R's where a kernel runs on both relations)."""
    from repro_torch.core import executor as exm
    from repro_torch.core.executor import INVALID, exchange, shared_columns
    from repro_torch.kernels import bucket_pack as bp
    from repro_torch.kernels import build_probe as bpr
    from repro_torch.kernels import route_cells as rc

    ex, s = cell["ex"], cell["session"]
    n_dev, k = ex.n_devices, ex.k
    rows_r, rows_s = s._device_args
    out, extra = {}, {}

    # route_cells on R's rows (all sources, as the step calls it), for the
    # route with the most hashed axes.  Bytes: the hashed columns and the
    # cells; operations: five per row and axis.
    recipe = max((route[0] for route in ex.route_specs["R"] if route[0]),
                 key=lambda h: sum(1 for x in h if x[2] != 1))
    axes = [x for x in recipe if x[2] != 1]
    n = rows_r.shape[0]
    record(out, "route_cells", rc.route_cells_cuda, rc.route_cells_host,
           (rows_r, recipe), n * len({x[0] for x in axes}) * 4 + n * 4,
           n * 5 * len(axes), 20)
    out["route_cells"]["device_ms"] = device_ms(
        lambda: rc.route_cells_cuda(rows_r, recipe))
    print(f"[kernel] route_cells: device "
          f"{out['route_cells']['device_ms']:.4f} ms")
    # fold_cells and bucket_pack on the staged map's copies.  fold: bytes
    # the dests in and out and the table, one select per copy; library:
    # table[dest] on clamped dests (leaves out the -1 pass-through).  pack:
    # bytes the dests, the valid copies' rows, the whole buffer and the
    # overflow; two operations per copy (bin, rank add).  bucket_pack's
    # entry is R's, S's beside it, each with its device time.
    frags, packs = {}, {}
    for name, rows in (("S", rows_s), ("R", rows_r)):
        rows3 = rows.view(n_dev, -1, rows.shape[1])
        dest, tagged = exm._route_relation(rows3, ex.route_specs[name], k,
                                           True)
        m = dest.numel()
        clamped = dest.clamp(min=0).long()
        (phys,) = record(out, "fold_cells", rc.fold_cells_cuda,
                         rc.fold_cells_host, (dest, s._ptable),
                         2 * m * 4 + k * 4, m, 20,
                         library=lambda: s._ptable[clamped])
        out["fold_cells"]["device_ms"] = device_ms(
            lambda: rc.fold_cells_cuda(dest, s._ptable))
        print(f"[kernel] fold_cells {name}: device "
              f"{out['fold_cells']['device_ms']:.4f} ms")
        del clamped, dest
        cap, w1 = s.caps[name], tagged.shape[2]
        n_kept = int(((phys >= 0) & (phys < n_dev)).sum())
        dst = {}
        args = (phys, tagged, n_dev, cap)
        buf, _ = record(dst, "bucket_pack", bp.bucket_pack_cuda,
                        bp.bucket_pack_host, args,
                        m * 4 + n_kept * w1 * 4
                        + n_dev * n_dev * cap * w1 * 4 + n_dev * 4,
                        2 * m, 10)
        rec = packs[name] = dst["bucket_pack"]
        rec["device_ms"] = device_ms(lambda: bp.bucket_pack_cuda(*args), 10,
                                     split=f"bucket_pack {name}")
        print(f"[kernel] bucket_pack {name}: device {rec['device_ms']:.4f} "
              f"ms (bound {rec['bound_ms']:.4f} ms), {n_kept} of {m} copies "
              f"members, cap {cap}")
        frags[name] = exchange(buf)
        del tagged, phys, buf, args
    out["bucket_pack"] = dict(packs["R"], S=packs["S"])
    # segment_scan over the sort-merge step's sorted union of keys, and
    # run_lengths over the sorted right group ids.  Bytes: the keys, the
    # outputs; operations: w compares and one scan add per row.  Library:
    # torch.unique_consecutive over the rows with the batch axis flattened
    # (leaves out the batch boundaries and the run starts).
    acc, right = frags["R"], frags["S"]
    lcols, rcols = shared_columns(["A", "B", "__cell__"],
                                  ["B", "C", "__cell__"])
    lv, rv = acc[..., -1] != INVALID, right[..., -1] != INVALID
    lks = torch.where(lv[..., None], acc[..., lcols], -2)
    rks = torch.where(rv[..., None], right[..., rcols], -3)
    comb = torch.cat([lks, rks], 1)
    perm = exm._lexsort_rows(comb)
    keys = exm._rows_at(comb, perm)
    del frags, acc, right, lks, rks, comb
    b, n_k, w = keys.shape
    flat = keys.reshape(-1, w)
    seg, _ = record(out, "segment_scan", bpr.segment_scan_cuda,
                    bpr.segment_scan_host, (keys,),
                    b * n_k * w * 4 + 2 * b * n_k * 4, b * n_k * (w + 1), 10,
                    library=lambda: torch.unique_consecutive(
                        flat, dim=0, return_inverse=True, return_counts=True))
    g_r = torch.empty_like(seg).scatter_(1, perm, seg)[:, lv.shape[1]:]
    sg_r = torch.sort(g_r, dim=1, stable=True).values[..., None].contiguous()
    n_r = sg_r.shape[1]
    record(extra, "run_lengths", bpr.run_lengths_cuda, bpr.run_lengths_host,
           (sg_r,), b * n_r * 4 + 3 * b * n_r * 4, 2 * b * n_r, 10,
           library=lambda: torch.unique_consecutive(
               sg_r.reshape(-1), return_inverse=True, return_counts=True))
    for dst, name, fn, args in (
            (out, "segment_scan", bpr.segment_scan_cuda, (keys,)),
            (extra, "run_lengths", bpr.run_lengths_cuda, (sg_r,))):
        dst[name]["device_ms"] = device_ms(lambda: fn(*args), 10, split=name)
        print(f"[kernel] {name}: device {dst[name]['device_ms']:.4f} ms "
              f"(bound {dst[name]['bound_ms']:.4f} ms)")
    out["segment_scan"]["run_lengths"] = extra["run_lengths"]
    return out


def moderate_checks(dev):
    """Phase 5: moderate queries on the kernels vs the reference join."""
    from repro_torch.core import (JoinQuery, canonical, plan_skew_join,
                                  reference_join, running_example)
    from repro_torch.core.executor import (ExecutorConfig,
                                           ShardedJoinExecutor,
                                           quantize_capacity)
    from repro_torch.data import chain_query, skewed_join_dataset
    from repro_torch.kernels import ops

    queries = {"running_example": running_example(), "chain4": chain_query(4)}
    for name, n, domain, skew in MODERATE:
        q = queries[name]
        data = skewed_join_dataset(q, n, domain, skew=skew, seed=7)
        ref = reference_join(q, data)
        rels = q.relations
        biggest = max(len(reference_join(JoinQuery(rels[:i]), data))
                      for i in range(2, len(rels) + 1))
        for k in (64, 256):
            plan = plan_skew_join(q, data, k)
            for arm, fields in ARMS.items():
                cfg = ExecutorConfig(out_capacity=quantize_capacity(biggest),
                                     **fields)
                ex = ShardedJoinExecutor(plan, 8, cfg, device=dev)
                # Counts zeroed just before prepare + run_batch, read just
                # after.
                ops.reset_launches()
                res = ex.session().prepare(data).run_batch()
                launches = dict(ops.LAUNCHES)
                want = expected_launches(ex, fields)
                check(launches == want, f"{name} k={k} {arm}: launches "
                      f"{launches}, expected {want}")
                check(int(res["shuffle_overflow"].sum()) == 0
                      and int(res["join_overflow"].sum()) == 0,
                      f"{name} k={k} {arm}: overflow")
                got = canonical(res["rows"][res["valid"]])
                check(np.array_equal(got, ref),
                      f"{name} k={k} {arm}: rows differ from reference_join")
                print(f"[moderate] {name} n={n} k={k} {arm}: {len(ref)} rows "
                      f"equal reference_join ({len(plan.residuals)} "
                      f"residuals); launches "
                      f"{ {kn: v for kn, v in launches.items() if v} }")


def moe_serve(dev):
    """Phase 7a + 7b: the MoE serving path of the LM scaffold at full width
    (depth cut), through `api.forward`, `build_prefill` and the
    `ServingEngine`.  Launch counts are zeroed just before 7a and read just
    after 7b; the values each `segment_histogram` call gets are kept (one
    per size) for phase 7c."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.common import count_params
    from repro_torch.serve import ServingEngine, build_prefill

    full = ARCHS[MOE["arch"]]
    cfg = dataclasses.replace(full, n_layers=MOE["n_layers"])
    K, L, d, f = cfg.topk, cfg.n_layers, cfg.d_model, cfg.d_ff
    print(f"[moe] {cfg.name}: d_model {d}, {cfg.n_heads} heads, "
          f"{cfg.n_kv_heads} KV heads, head_dim {cfg.hd()}, d_ff {f}, vocab "
          f"{cfg.vocab}, {cfg.n_experts} experts top-{K} on {cfg.n_slots()} "
          f"slots, window {cfg.sliding_window}, attn_chunk "
          f"{cfg.attn_chunk}, rope theta {cfg.rope_theta:g}; reduced: "
          f"n_layers {full.n_layers} -> {L}")

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = api.init_model(cfg, torch.Generator(device=dev).manual_seed(
        MOE["seed"]), device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = count_params(api.layout(cfg))
    expert_bytes = L * 3 * cfg.n_slots() * d * f * 2
    print(f"[moe] weights: {n_params} bf16 parameters = "
          f"{n_params * 2 / 1e9:.2f} GB reckoned (experts "
          f"{expert_bytes / L / 1e9:.2f} GB a layer), "
          f"{(torch.cuda.memory_allocated() - base) / 1e9:.2f} GB allocated "
          f"(measured), drawn from a seeded generator on the card in "
          f"{t_init:.2f} s")

    # Keep the first input of each size that the histogram is given.
    captured = {}
    launch_hist = ops.segment_histogram

    def keep_input(values, n_bins, **kw):
        captured.setdefault(values.numel(), values.detach().clone())
        return launch_hist(values, n_bins, **kw)

    rng = np.random.default_rng(MOE["seed"])
    B, S = MOE["prefill_batch"], MOE["prefill_len"]
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32)).to(dev)
    lens = rng.integers(MOE["prompt_len"][0], MOE["prompt_len"][1] + 1,
                        MOE["n_requests"])
    news = rng.integers(MOE["new_tokens"][0], MOE["new_tokens"][1] + 1,
                        MOE["n_requests"])
    requests = [(rng.integers(0, cfg.vocab, n).tolist(), int(m))
                for n, m in zip(lens, news)]

    # The path: counts zeroed just before, read just after.
    ops.segment_histogram = keep_input
    torch.cuda.synchronize()
    ops.reset_launches()
    model_calls = 0
    # 7a. forward and prefill.
    lg, aux = api.forward(model, cfg, {"tokens": prompts}, last_only=True)
    model_calls += 1
    load = aux["expert_load"]
    check(int(load.sum()) == B * S * K * L,
          f"expert_load sums to {int(load.sum())}, not B·S·K·L = "
          f"{B * S * K * L}")
    model.use_kernels = False
    _, aux_plain = api.forward(model, cfg, {"tokens": prompts},
                               last_only=True)
    model.use_kernels = True
    check(torch.equal(load, aux_plain["expert_load"]),
          f"expert_load {load.tolist()} != plain "
          f"{aux_plain['expert_load'].tolist()}")
    check(bool(torch.isfinite(lg).all()), "forward logits not finite")
    fns = build_prefill(cfg, device=dev)
    prefill_s = []
    for _ in range(MOE["prefill_reps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = fns.prefill(model, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        model_calls += 1
    check(last.shape == (B, cfg.padded_vocab())
          and bool(torch.isfinite(last).all()),
          f"prefill logits {tuple(last.shape)} not finite or misshaped")
    t_prefill = float(np.median(prefill_s))
    print(f"[moe] 7a forward: expert_load {load.tolist()} sums to "
          f"{int(load.sum())} = B·S·K·L and equals the plain version's "
          f"(torch.equal); prefill of {B} x {S} tokens median "
          f"{t_prefill * 1e3:.1f} ms of {len(prefill_s)} "
          f"({', '.join(f'{t * 1e3:.1f}' for t in prefill_s)}), "
          f"{B * S / t_prefill:.0f} prompt tokens/s; logits finite")

    # 7b. serving.
    eng = ServingEngine(cfg, MOE["slots"], MOE["max_seq"], model, device=dev)
    reqs = [eng.submit(p, m) for p, m in requests]
    tick_s = []
    tick = eng._tick

    def timed_tick():
        t = time.perf_counter()
        tick()                       # ends in the next tokens' copy to host
        tick_s.append(time.perf_counter() - t)

    eng._tick = timed_tick
    t0 = time.perf_counter()
    eng.run()
    t_run = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    ops.segment_histogram = launch_hist
    peak = torch.cuda.max_memory_allocated()
    model_calls += eng.ticks

    check(all(r.done and len(r.out) == m for r, (_, m) in zip(reqs, requests)),
          "a request did not complete with its max_new_tokens")
    want_out = sum(m for _, m in requests)
    check(eng.tokens_out == want_out,
          f"tokens_out {eng.tokens_out} != {want_out}")
    want = dict.fromkeys(KERNEL_SITES, 0)
    want["segment_histogram"] = model_calls * L
    check(launches == want, f"moe_serve launches {launches}, expected {want}")
    check(16 in captured and B * S * K in captured,
          f"histogram inputs of sizes {sorted(captured)}")
    tick_ms = float(np.median(tick_s)) * 1e3
    print(f"[moe] 7b serving: {len(reqs)} requests (prompts "
          f"{int(lens.min())}-{int(lens.max())}, new tokens "
          f"{int(news.min())}-{int(news.max())}) on {MOE['slots']} slots, "
          f"max_seq {MOE['max_seq']}: all complete, tokens_out "
          f"{eng.tokens_out}; {eng.ticks} ticks, median tick {tick_ms:.2f} ms "
          f"(p90 {np.percentile(tick_s, 90) * 1e3:.2f}, max "
          f"{max(tick_s) * 1e3:.2f}); run {t_run:.2f} s, "
          f"{eng.tokens_out / t_run:.1f} decode tokens/s; bound of a tick "
          f"(reading every slot's expert weights once, "
          f"{expert_bytes / 1e9:.2f} GB / {HBM_BYTES_PER_S / 1e12:.2f} TB/s) "
          f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms")
    print(f"[moe] segment_histogram launches {launches['segment_histogram']}"
          f" = ({model_calls} model calls: 1 forward + "
          f"{MOE['prefill_reps']} prefills + {eng.ticks} ticks) x {L} "
          f"layers; the plain forward launched none; peak allocated "
          f"(measured) {peak / 1e9:.2f} GB")

    # Where a tick's time goes (not counted): the decode step alone.
    toks = torch.from_numpy(eng.next_tok[:, None].copy())
    pos = torch.from_numpy(np.minimum(eng.pos, MOE["max_seq"] - 1))
    profile_calls(lambda: eng.fns.decode(model, eng.cache, toks, pos),
                  f"{MOE['profile_ticks']} decode steps (B={MOE['slots']})",
                  MOE["profile_ticks"], tag="moe")
    del eng, model, lg, last
    torch.cuda.empty_cache()
    return dict(launches=launches, captured=captured, n_bins=cfg.n_experts)


def histogram_checks(dev, serve):
    """Phase 7c: segment_histogram against its plain version at this run's
    shapes (decode, prefill) and two larger ones, with kernel (events),
    device (profiler), plain, library and bound times."""
    from repro_torch.kernels import segment_histogram as sh

    n_bins = serve["n_bins"]
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [("decode", serve["captured"][16], n_bins),
             ("prefill", serve["captured"][max(serve["captured"])], n_bins)]
    for n, bins in HIST_SHAPES:
        cases.append((f"2^{n.bit_length() - 1} values",
                      torch.randint(-2, bins + 2, (n,), generator=gen,
                                    device=dev, dtype=torch.int32), bins))
    out, extra = {}, {}
    arms = {sh.SH_ONE: "one block", sh.SH_GRID: "grid",
            sh.SH_CLUSTER: "cluster", sh.SH_GLOBAL: "device atomics"}
    for label, vals, bins in cases:
        n = vals.numel()
        n_valid = int(((vals >= 0) & (vals < bins)).sum())
        plan = sh.histogram_plan(n, bins)
        print(f"[histogram] {label}: {n} values, {bins} bins, "
              f"{arms[plan[0]]} arm {plan}")
        if label == "decode":
            _, device = call_profile(
                lambda: sh.segment_histogram_cuda(vals, bins))
            check(len(device) == 1 and max(device.values()) <= 10,
                  f"segment_histogram decode call: device operations "
                  f"{device} in 10 calls, not one a call")
            print(f"[histogram] decode: one device operation a call "
                  f"({device} in 10 calls)")

        def library(vals=vals, bins=bins):   # two calls: a mask, a bincount
            return torch.bincount(vals[(vals >= 0) & (vals < bins)],
                                  minlength=bins)

        # Bytes: the values read once, the bins written once; operations:
        # one compare per value and one add per value in range.
        record(out if label == "prefill" else extra, "segment_histogram",
               sh.segment_histogram_cuda, sh.segment_histogram_host,
               (vals, bins), 4 * n + 4 * bins, n + n_valid, 20,
               library=library)
        dst = out if label == "prefill" else extra
        dst["segment_histogram"]["device_ms"] = device_ms(
            lambda: sh.segment_histogram_cuda(vals, bins))
        print(f"[histogram] {label}: device "
              f"{dst['segment_histogram']['device_ms']:.4f} ms")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.lib()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")

    cell = full_cell(dev)
    results = kernel_checks(cell)
    library, library_launches = library_checks(cell)
    results.update(library)
    s = cell.pop("session")
    cell["caps"], cell["table"] = dict(s.caps), s.placement.table.copy()
    del s, cell["ex"]
    torch.cuda.empty_cache()
    staged = staged_cell(dev, cell)
    del cell["rows"], cell["valid"]
    torch.cuda.empty_cache()
    results.update(staged_kernel_checks(staged))
    path_launches = {FUSED_HASH: cell["launches"],
                     STAGED_SORT: staged["launches"],
                     LIBRARY: library_launches}
    del staged
    torch.cuda.empty_cache()
    moderate_checks(dev)
    del cell
    torch.cuda.empty_cache()
    print(f"[moe] join phases freed: {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB still allocated")
    t7 = time.perf_counter()
    serve = moe_serve(dev)
    results.update(histogram_checks(dev, serve))
    path_launches[MOE_SERVE] = serve["launches"]
    t_end = time.perf_counter()

    kernels = []
    for name in ops.KERNELS:
        source, replaces, path = KERNEL_SITES[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, path=path,
                            launches=path_launches[path][name],
                            **results[name]))
    check(all(kn["launches"] > 0 for kn in kernels), "a kernel never launched")
    print(f"[done] all phases passed in {t_end - t_start:.1f} s (phase 7 "
          f"{t_end - t7:.1f} s)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
