#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's join paths, its MoE serving path and its
training path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. the card's name and power limit (nvidia-smi);
  2. build the fifteen CUDA kernels from src/repro_torch/kernels/csrc;
  3. the full-size cell end to end on the kernels (fused map + hash
     reduce, the default `ExecutorConfig`): R(A,B) ⋈ S(B,C) with
     2^21 rows per relation, one heavy hitter B = 0 of 12,288 rows, a tail
     of 2^20 values, k = 256 logical cells on n_dev = 8 logical servers.
     The first `run_batch` runs the step eagerly (the graph's warm-up),
     the second captures it as a CUDA graph and replays it, every later
     one replays.  Launch counts are zeroed just before `prepare` + the
     first `run_batch` and read just after: the counting pass and the
     eager step once each.  Requires zero overflow, the exact join size
     Σ_v c_R(v)·c_S(v), rows equal to the same step on the plain versions
     (`use_kernels=False`, eager) on the card, no new step on a second
     batch, that batch's capture launching each step kernel once more and
     the 7 warm replays none from the host; the cold first batch, the
     capture batch, the warm median of 7, the graph's memory, a
     device-only trace of a warm batch (its busy time against that
     unprofiled median), and a profile
     of a warm batch that must name build_table's, scatter_pack's and
     probe_tables' kernels and hold no torch row-wise scan
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
  3c. the same cell on the fused map + sort-merge reduce (`hash_reduce=
     False`), then 3b. on the staged map + sort-merge reduce (`fuse_map=
     False, hash_reduce=False`), each with counts zeroed just before its
     `prepare` + first `run_batch` and read just after (as in 3): zero
     overflow, the exact join size, rows `torch.equal` to phase 3's, no new
     step on a second batch (its capture launching the step's kernels once
     more), no host launch in the warm replays, the cold first batch, the
     capture batch, the warm median, the peak, the graph's memory, a
     device-only trace and a
     profile that must name scatter_pack's and segment_scan's kernels
     (3c) or segment_scan's and bucket_pack's (3b); the three arms'
     numbers on a {"join_arms": ...} JSON line;
  3m. after 3c, phase 3's cell (same plan, data and cap_out, fused +
     hash) over a mesh of ranks, each a process spawned with the spawn
     start method and joined with a deadline: W = 4 gloo ranks sharing
     the card, then W = 1 over NCCL (one card: NCCL across cards runs only
     where there are several).  In each rank counts are zeroed just before
     its prepare + first run_batch and read just after (phase 3's counts,
     its L = 2 or 8 destinations batched); its rows and valid flags
     `torch.equal` to phase 3's for its destinations (shared through CUDA
     IPC), zero overflow, the ranks' valid rows summing to the exact join
     size, no new step at the second batch, 5 eager warm batches (each
     the step's launches); per rank: prepare, first batch, the warm
     median, the exchange alone on each relation's send buffer (wall
     median of 3), the bytes it sends to other ranks (from the buffer's
     shape) and the valid copies among them (count matrices folded
     through the placement), valid copies received (recv_counts), the
     peak; a {"mesh": ...} JSON line;
  4b. the staged arm's kernels (route_cells, fold_cells, bucket_pack,
     segment_scan / run_lengths) against their plain versions at the
     shapes of that run, bit for bit, with kernel, plain, bound and (where
     one PyTorch call computes the function) library times, and the
     device times of route_cells and fold_cells; bucket_pack
     on R (the entry) and S, segment_scan and run_lengths also with their
     device time and each of their kernels' share;
  6. self-healing on the full-size cell (fused + hash), each sub-phase
     held to the exact join size and to phase 3's rows as a multiset
     (sorted int64 words A·2^42 + B·2^21 + C, compared on the card):
     6a. the chunked exchange, `overlap_shuffle = 4`: per-chunk caps
         ⌈phase 3's / 4⌉, zero overflow, launches of prepare + the first
         batch zeroed just before and read just after (scatter_pack 8,
         the rest as phase 3's), no new step on a second batch (its
         capture launching the step's kernels once more), the warm median
         beside phase 3's; a profile of one eager step whose Chrome trace
         must show the exchange's copies on a stream that runs no
         scatter_pack kernel (device time summed and busy); the step
         captured once more with CUDA's graph kept and written as DOT,
         which must hold the 8 packs in one chain and exactly 8 exchange
         copies, each after its own chunk's pack and no later one, every
         one but a relation's last beside the next pack; and a profile of
         one warm replay: its streams and how long the copies run beside
         another stream's operations;
     6b. overflow: a `SelfHealingSession` with caps squeezed to an eighth
         (`ChaosInjector.squeeze_caps`) heals by retry (retries ≥ 1, the
         failed attempts' dropped copies in `stats`), its wall time (the
         time to recover) beside a clean warm batch's; a second session
         walks the ladder with no step built; `max_retries=0` raises
         `RetryBudgetExceededError` naming a device; the peak over 6b and
         the graphs and memory held after it;
     6c. device loss: device 3's heartbeats dropped (timeouts 2.5 s and
         1.5 s on the injector's clock, 1 s a batch): evicted within 16
         batches, one re-fold, then nothing received by device 3 and
         something by every survivor, no step built beyond what
         `refold_compiles` counts, the degraded warm median;
     6d. a straggler: device 5 reports 30 s more a step, evicted after 2
         strikes, then receives nothing;
     6e. drift adaptation (`SelfHealingSession(adapt=AdaptPolicy(...))`,
         Misra-Gries sketches of 1,024 counters): on phase 3's data a warm
         batch, `force_replace`, a batch, `force_replan` (the sketches
         holding B = 0 first), a batch, each batch's rows phase 3's, no
         step built, the plan cache hit, the counters folded across the
         retired session; organic mild drift on a stream whose 128 hot
         tail values (+512 rows each, picked by the cell slice they route
         to) move in part to the other half of the slices: re-placed (the
         table changes), never re-planned, no step built, in 8 batches;
         a new heavy hitter (value 1, +65,536 rows in R) on a fresh
         session: re-planned cold onto a new executor whose plan holds it,
         the build counted; every batch exact; the observation's host time
         a batch (count_batch, observe_values, assess), the warm and cold
         re-plans' walls beside clean batches', and each detector history;
  5. the paper's running example and a 4-way chain at a few thousand rows,
     k ∈ {64, 256}, n_dev = 8, under all four arms (fused | staged map ×
     hash | sort-merge reduce) and, with `overlap_shuffle = 3`, on fused +
     hash and staged + sort, against the numpy reference join, with the
     exact launch counts of each run checked;
  7. the MoE serving path of the LM scaffold: mixtral-8x22b at its
     published widths with its depth cut from 56 to 4 layers, bf16 weights
     (about 40 GB) drawn from a seeded generator on the card, the join
     phases' memory freed first.  Launch counts are zeroed just before 7a
     and read just after 7b.
     7a. `api.forward` and `build_prefill` on 4 prompts of 2,048 tokens
         (chunked attention, capacity clamping): finite last-position
         logits; the expert loads sum to B·S·K·L and are `torch.equal` to
         the same call with `use_kernels=False`; the median of 3
         `build_prefill` calls (eager);
     7b. 24 seeded requests (prompts 16-128 tokens, 16-64 new tokens) on
         a `ServingEngine` of 8 slots (max_seq 512) on the eager decode
         step of the plain versions (`use_kernels=False`, the reference),
         then on one on the graph (a tick eager, a capture, replays): each
         request completes with its max_new_tokens, tokens_out is their
         sum, and every request's tokens are equal on both engines;
         segment_histogram launched (host passes) x (layers) times, a host
         pass being a model call with kernels that runs eagerly or is
         captured (a replay launches nothing from the host); each engine's
         ticks, median tick and decode tokens/s, the graph's captures and
         the memory its capturing tick pins, the bound of a tick, the
         peak, and a profile of 5 decode steps eager (plain) and replayed;
     7c. segment_histogram against its plain version, bit for bit, on this
         run's decode and prefill inputs (8 bins; one block) and on 2^24
         values at 384 bins (the grid) and 2^22 and 2^16 at 2^16 bins (the
         cluster arm, several clusters and one), with its arm and kernel,
         device, plain, library and bound times; a profile of the decode
         call must show one device operation;
  8. multi-tenant join serving (`JoinServingEngine`), after phase 6 while
     phase 3's plan and data are alive:
     8a. mixed_workload's three tenants (pairs, chain3, chain4, two row
         buckets each) on an engine at k = n_devices, and a tenant `full`
         sending phase 3's cell on an engine at k = 256: `full`'s first
         request walks cap_out from 4,096 to phase 3's in its escalations
         (time to its first exact result), its second builds and retries
         nothing; after a warmup of 12 mixed requests, 24 steady mixed and
         2 full requests build no step at a hit rate of 1.0; small
         requests canonically equal `reference_join`, full ones phase 3's
         rows (multiset, on the card); per-tenant stats sum to each
         engine's; requests/s, p50 / p99, full's warm latency split into
         the run and the rows' copy to the host, peak memory, and the
         graphs and memory the engines hold after the drains;
     8b. an engine with a hair-trigger `adapt=` policy: `full` sends 4
         full-size batches whose hot set moves (re-placed at least once),
         `calm` one small request; each detector windows only its own
         tenant's batches; every request exact;
  6m. after 8, phase 6's cell (overlap_shuffle = 4, caps squeezed to an
     eighth) over a mesh of ranks, four gloo ranks sharing the card, then
     one NCCL rank, spawned as phase 3m's: one adaptive
     `SelfHealingSession` walks the retry ladder, evicts device 3 on its
     dropped heartbeats, loses the last rank's devices 6 and 7 in one
     re-fold (`evict_rank(3)` at W = 4; by hand at W = 1), runs 3 degraded
     batches, a forced re-place and a warm re-plan; then a
     `JoinServingEngine` over the mesh serves 24 of mixed_workload's
     requests (k = 8) and one full-size request (k = 256, cap_out's ladder
     from 4,096).  The one-process session and engines on the card run the
     same schedule first: every checkpoint batch's rows and valid flags
     of each rank `torch.equal` to theirs for its destinations (shared
     through CUDA IPC), each request's rows at the rank's offset equal to
     theirs, every counter (retries, escalations, refolds, refold_compiles,
     re-placements, re-plans and their builds, alive, evicted, placement,
     caps, step builds, cache hits, misses and builds) equal on every rank
     and to theirs; launches zeroed in each rank before its schedule and
     read after it; the healed batch's wall, the degraded median and
     requests/s;
  9. the training path, after phase 7 (its memory freed):
     9a. mixtral-8x22b at its published widths with its depth cut from 56
         to 1 layer (at 2 a step peaks past 76 GB),
         remat "full", 8-bit AdamW states: `build_train_step` takes 5
         steps on one `TokenPipeline` batch of 4 x 2,048 tokens (warmup 1
         step).  Launch counts are zeroed just before the first step and
         read just after the fifth.  Every loss finite and the last below
         the first; the optimizer's step 5; every step's expert_load sums
         to B·S·K·L and the first step's is `torch.equal` to the same
         forward on the plain versions.  The step is a CUDA graph: the
         first runs eagerly, the second captures it (its capture time and
         the memory it pins printed), steps 3-5 replay; segment_histogram
         launched 2·L by each host pass that launches kernels (the eager
         step and the capture: the forward and its recompute) and equal
         to plain on the step's input.  Prints the losses, the cold first
         step, the capturing step, the warm median of the replays
         (steps 3-5), tokens/s, the peak and a profile of a sixth step, a
         replay (device-busy share, top device operations);
     9b. the training driver (`repro_torch.launch.train`'s main) on
         qwen2-0.5b at its full size on the card, into a temporary
         directory: 12 steps of 8 x 512 tokens, checkpoints every 4, a
         simulated node failure at step 6 (re-mesh, restore), then
         `--resume --steps 15`.  The FT lines printed, the loss descends,
         the latest committed step is 15; the step is a graph, captured
         anew after each restore (3 captures, each one's time and pinned
         memory printed); prints the warm step median (the replays) and
         the final blocking save's wall time;
     9m. the train step over a (data, model) mesh of ranks (`build_train_step
         (mesh=)`), spawned after 9b, each rank against the one-process
         eager step from the same seed-made parameters and batch
         (`mesh_training`, MESH_TRAIN): "a" one NCCL rank on a (1, 1)
         mesh, qwen2-0.5b at its full size, 3 steps of 8 x 512, losses,
         grad_norm and every parameter bit for bit; "b" one gloo rank,
         reduced mixtral-8x22b with 8-bit states, within rtol 1e-5,
         expert_load equal, segment_histogram launched on the rank's rows
         (counts zeroed just before the mesh steps, read just after) and
         equal to its plain version there.  Prints each rank's resident,
         peak and predicted memory (parameters, gradients and states over
         the shards their placements give);
     7m. serving over a (data, model) mesh of ranks (`ServingEngine(mesh=)`,
         `build_prefill(mesh=)`), spawned after 9m, each rank against the
         one-process engines on its card (eager on the plain versions and
         on the graph) from the same seed-made weights and 16 seeded
         requests on 8 slots, max_seq 512 (`mesh_serving`, MESH_SERVE):
         "a" full-size qwen2-0.5b on one NCCL rank, (1, 1): every
         request's tokens and the first tick's logits bit for bit the
         one-process engine's, and a 4 x 2,048 prefill's logits the
         one-process prefill's; "b" mixtral-8x22b at its published widths,
         depth 2, on one NCCL rank: the same, segment_histogram launched
         (ticks x layers, counts zeroed just before the mesh engine's run,
         read just after) on the rank's rows and equal to its plain
         version there.  Prints the mesh tick's median (eager) beside the
         one-process eager and graph ticks, each rank's resident and
         predicted params + cache, its peak, the launches and the wall;
 10. the ssm, hybrid, encdec and vlm families at their published widths,
     after phase 9 (its memory freed), each through `api.prefill` /
     `api.decode_step`, a `ServingEngine` (eager on the plain versions
     and on its CUDA graph) and `build_train_step`, bf16 weights from a
     seeded generator on the card, depth cut only where the card cannot
     hold a step and each cut printed: 10a mamba2-370m at full size (and
     its duality check: the float32 model's forward on 4 x 512 tokens
     against `decode_step` replayed over them), 10b zamba2-7b (serving at
     full depth, 81 applications), 10c seamless-m4t-medium at full size
     (prefill over frames of 4 x 512 x 1,024), 10d llama-3.2-vision-90b
     cut to one group (4 self-attention blocks and a gated
     cross-attention block, gate set to 0.5).  Each: its parameter
     count; the median of 3 prefills of 4 x 2,048 tokens, then 16 decode
     steps from the prefilled cache; 24 seeded requests on 8 slots on an
     eager engine and on a graph one (as 7b: the same tokens; median
     tick, decode tokens/s, captures, pinned memory); 4-5 train steps
     on one `TokenPipeline` batch of 4 x 2,048 (stub frontends from the
     driver's `make_batch`; remat "full", lr 1e-4, warmup 1) through the
     train step's graph: the cold (eager) step, the capturing one (its
     capture time and pinned memory), the warm median of the replays and
     tokens/s; the peaks (under 76 GB); a profile of one more warm step,
     a replay (device-busy share, top device operations).  Every logit
     finite; caches keep their keys, shapes and dtypes through decode;
     every loss and grad_norm finite, the last loss below the first; the
     optimizer's step the steps taken; no custom kernel launched (no TPU
     kernel lies on this path);
 11. the dry run (`repro_torch.launch.dryrun`) against the card, after
     phase 10 (its memory freed); its predictions are traced on fake
     tensors in a child process (no card) while phases 3-10 run:
     11a. the predicted peak of each training step of phases 9 and 10
         (the same config cut, batch, remat and state bits) beside its
         measured `max_memory_allocated` over the phase's start, and the
         ratio (printed, not gated);
     11b. qwen2-0.5b x decode_32k at its published widths and full depth
         (24 layers): 128 slots, a 32,768-position cache (51.54 GB of
         bf16 keys and values), bf16 weights from a seeded generator,
         through `build_decode_step`: 8 ticks of the plain versions'
         eager step at positions 32,760-32,767 (attention reads the
         whole cache), the last position's logits finite, then the graph
         over the same positions and tokens twice (eager, capture, 14
         replays), its next tokens equal to the eager step's at every
         position; the dry run's total_per_device within ±10 % of the
         measured peak over the weights, the cache and the first eager
         tick; prints the ticks, the graph's warm median, decode tokens/s,
         the dry run's bound_s, dominant term and roofline_fraction, and
         the graph's pinned memory;
     11c. mamba2-370m x long_500k (B 1, ticks at positions 524,284-
         524,287), the same checks, its peak beside the prediction
         (printed, not gated);
     11m. the dry run over a mesh (`run_cell(..., mesh_kind)`), traced in
         the same child process: phase 9m "a" (full-size qwen2-0.5b, 8 x
         512, bf16, float32 states) and phase 10m's three serving engines
         (8 slots, max_seq 512, 10m's depths) over a `1x1` mesh; each
         prediction beside the measured peak (9m "a") or params + cache
         resident (10m) of the rank, with the ratio (printed); the `1x1`
         records' memory must equal the one-card records' to the byte,
         and 10m's resident bytes the `1x1` prediction's (checked);
 12. one JSON line each of phases 3 / 3b / 3c, 3m, 6, 6e, 8, 9, 9m, 7m, 7, 10
     and 11's numbers, one JSON line of per-kernel results (each with the
     path its launches were counted on: segment_histogram's is phase 9a's,
     its phase 7 count, host passes x layers, beside it as
     `serve_launches`, phase 9m's mesh ranks' as `mesh_train_launches`,
     phase 7m's as `mesh_serve_launches`),
     then the last line {"ok": true, "device": {...}}.

Exits non-zero without printing a result when no CUDA device is present or
when the repository's `src/repro_torch` is not beside this script.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
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
# Phase 6 on the full-size cell: the chunked exchange's C, the cap squeeze
# of the overflow fault, the device whose heartbeats stop and the
# straggler.
HEALING = dict(chunks=4, squeeze=0.125, dead=3, slow=5)
# Phase 6e's drifting stream on the full-size cell (`drifting_join_batch`
# at the cell's n, hh_rows and tail_domain): n_hot tail values, picked by
# the cell slice they route to, carry `bonus` rows each in R and S (far
# under the 2^21 / 256 = 8,192-row HH threshold); the mild drift moves
# `moved` of them to the other half of the slices.  The new heavy hitter:
# value 1 with `extra_hh` rows in R (8x the threshold; in R only, as in
# both relations its join alone would be extra_hh^2 = 2^32 rows).  The
# Misra-Gries sketches keep m = sketch_counters counters: at m = 1,024 a
# batch's error N/m = 2,048 rows leaves value 0 at least 10,240 of its
# 12,288, over the threshold.
ADAPT = dict(n_hot=128, bonus=512, moved=96, extra_hh=1 << 16,
             sketch_counters=1024, warm_batches=2, mild_batches=6,
             hh_batches=6)
# The policy of 6e: the mild drift's TV (~0.02 a batch, diluted by the
# window) arms a re-placement and stays under the re-plan threshold.
ADAPT_POLICY = dict(replace_threshold=0.005, replan_threshold=0.05,
                    window=4, patience=2, min_batches=2, replace_cooldown=2,
                    replan_cooldown=6, sketch_counters=ADAPT["sketch_counters"])
# Phase 8b's hair-trigger policy (tests/test_join_engine.py's), with
# sketches sized for the full-size cell.
HAIR_TRIGGER = dict(replace_threshold=0.001, replan_threshold=0.99, window=2,
                    patience=1, min_batches=1, replace_cooldown=1,
                    replan_cooldown=99,
                    sketch_counters=ADAPT["sketch_counters"])
# Phase 8: the mixed tenants' warmup ((requests, seed) of mixed_workload:
# seed 1's window holds a chain3 request whose output outgrows its bucket's
# caps, one escalation and one step built) and steady windows (seeds 2, 3,
# ...), the full-size tenant's requests in each, and the retry budget of
# the engines (the full-size tenant walks cap_out from 4,096 to the cell's
# 2^25).
SERVE = dict(warm=((12, 0), (480, 1)), steady=480, windows=3, full_warm=2,
             full_steady=2, max_retries=16, drift_batches=4)
# Phase 3m: phase 3's cell over a mesh of ranks, (backend, W): four gloo
# ranks sharing the card, then one NCCL rank; each run's deadline.
MESH_RUNS = (("gloo", 4), ("nccl", 1))
MESH_DEADLINE_S = 240
# Phase 6m: phase 6's cell and fault schedule over the mesh runs of 3m:
# the devices of the rank lost (W = 4's rank 3; W = 1 evicts them by
# hand), the degraded batches timed, the mixed requests served, each run's
# deadline and its collectives' timeout; device 3's heartbeats time out
# after 0.5 s of the injector's clock (1 s a batch), so it is evicted at
# the second batch without them.
MESH_HEAL = dict(lost=(6, 7), degraded=3, requests=24, deadline_s=300,
                 timeout_s=120, heartbeat_timeout_s=0.5,
                 suspect_timeout_s=0.25)
# The fused + hash path's kernels, each launched by every mesh rank.
MESH_KERNELS = ("map_count", "scatter_pack", "join_hash", "build_table",
                "probe_tables", "expand_rows")
# Phase 5's chunked exchange (overlap_shuffle) on fused + hash and
# staged + sort.
MODERATE_CHUNKS = 3
FUSED_HASH, STAGED_SORT = "fused+hash", "staged+sort"
LIBRARY = "library"
MOE_SERVE = "moe_serve"
MOE_TRAIN = "moe_train"
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
                          MOE_TRAIN),
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
# Phase 9m: the train step over a (data, model) mesh of ranks, spawned,
# each run against the one-process eager step from the same seed-made
# parameters and batch.  "a": one NCCL rank, a (1, 1) mesh: qwen2-0.5b at
# its full size (9b's model, bf16), 8 x 512 tokens, 3 steps, bit for bit.
# "b": reduced mixtral-8x22b in float32 with 8-bit states, 3 steps, at the
# CPU tests' tolerance (rtol 1e-5 on loss, zloss, grad_norm; expert_load
# equal), segment_histogram launched by each rank on its own rows.  "b"
# runs on one gloo rank: over gloo, DTensor's collectives on CUDA tensors
# (its functional all_gather, the first a step issues) end the rank with
# SIGSEGV at two ranks on (1, 2), (2, 1) and (2, 2) (torch 2.11.0+cu128),
# where gloo's own all_reduce, its max and all_gather_into_tensor on the
# same tensors pass; NCCL takes one rank a card.  The (2, 2) mesh over
# NCCL runs on four cards: scripts/mesh_train_cards.py.  A warmup of one
# step, so steps 2 and 3 update.
MESH_TRAIN = dict(
    a=dict(arch="qwen2-0.5b", reduced=False, dtype="bfloat16", bits=32,
           batch=8, seq=512, steps=3, lr=3e-3, shape=(1, 1),
           backend="nccl", exact=True, one=True),
    b=dict(arch="mixtral-8x22b", reduced=True, dtype="float32", bits=8,
           batch=8, seq=64, steps=3, lr=1e-2, shape=(1, 1),
           backend="gloo", exact=False, one=True))
MESH_TRAIN_DEADLINE_S = 300
MESH_TRAIN_RTOL = 1e-5
# Phase 7m: serving over a (data, model) mesh of ranks, spawned as 9m is,
# each run against the one-process engines (eager on the plain versions
# and on the graph) in the same rank, from the same seed-made weights and
# requests.  "a": full-size qwen2-0.5b on one NCCL rank, (1, 1), 16
# requests on 8 slots, max_seq 512, and a 4 x 2,048 `build_prefill(mesh=)`;
# "b": mixtral-8x22b at its published widths, depth 2, on one NCCL rank,
# segment_histogram launched on the rank's rows.  On one rank every
# placement replicates, so tokens and logits are held bit for bit; the
# sharded branches run on four cards (scripts/mesh_serve_cards.py), held
# to `MESH_SERVE_LOGIT_RTOL`: the first tick's logits within 2^-4 of the
# row's largest logit of the one-process engine's (bf16 through every
# layer, summed in other orders over the ranks).
MESH_SERVE = dict(
    a=dict(arch="qwen2-0.5b", layers=None, shape=(1, 1), slots=8,
           max_seq=512, n_requests=16, prompt_len=(8, 32),
           new_tokens=(8, 24), prefill=(4, 2048), exact=True),
    b=dict(arch="mixtral-8x22b", layers=2, shape=(1, 1), slots=8,
           max_seq=512, n_requests=16, prompt_len=(8, 32),
           new_tokens=(8, 24), prefill=None, exact=True))
MESH_SERVE_DEADLINE_S = 300
MESH_SERVE_LOGIT_RTOL = 2.0 ** -4
# Phase 10m: the hybrid, enc-dec and VLM families trained and served over
# a (data, model) mesh, every run of one NCCL rank spawned once at (1, 1)
# (`mesh_family_rank` / `mesh_families`), each family at its published
# widths in bf16 from seed 0, the depth cut as phase 10 cuts it (zamba2 to
# 16 layers: 2 groups of 6 Mamba2 blocks and the shared block, then 2 tail
# blocks; the VLM to 5: 4 self-attention blocks and one gated
# cross-attention block, its gate at 0.5).  Training: 3 steps of 4 x 512
# tokens with the frontend's input from the seed (frames (4, 128, 1,024),
# vision embeddings (4, 1,601, 1,280)), against the one-process eager step
# (and beside its graph's times).  Serving: `ServingEngine(mesh=)` on 16
# requests and 8 slots, max_seq 512, against the one-process engines.
# "b" and "c": a 4 x 2,048 `api.prefill` over the mesh filling `enc_out`
# or `vis`, then 8 ticks from that cache; "a": 8 ticks at positions
# 4,092-4,099 of a max_seq 8,192 cache seeded non-zero, across the
# 4,096-slot ring's wrap.  On one rank every placement replicates, so
# everything is held bit for bit (`exact`); scripts/mesh_train_cards.py
# and scripts/mesh_serve_cards.py run the (2, 2) mesh on four cards,
# within MESH_TRAIN_RTOL / MESH_SERVE_LOGIT_RTOL.
MESH_FAMILY = dict(
    a=dict(arch="zamba2-7b", layers=16, reduced=False, dtype="bfloat16",
           bits=8, shape=(1, 1), exact=True, train=True, serve=True,
           prefill=None, ring=(4092, 8192)),
    b=dict(arch="seamless-m4t-medium", layers=None, reduced=False,
           dtype="bfloat16", bits=32, shape=(1, 1), exact=True, train=True,
           serve=True, prefill=(4, 2048), ring=None),
    c=dict(arch="llama-3.2-vision-90b", layers=5, gate=0.5, reduced=False,
           dtype="bfloat16", bits=8, shape=(1, 1), exact=True, train=True,
           serve=True, prefill=(4, 2048), ring=None))
MESH_FAMILY_RUN = dict(seed=0, batch=4, seq=512, steps=3, lr=1e-4, slots=8,
                       max_seq=512, n_requests=16, prompt_len=(8, 32),
                       new_tokens=(8, 24), ticks=8, ring_batch=4)
MESH_FAMILY_DEADLINE_S = 420
MOE = dict(arch="mixtral-8x22b", n_layers=4, seed=0, prefill_batch=4,
           prefill_len=2048, prefill_reps=3, slots=8, max_seq=512,
           n_requests=24, prompt_len=(16, 128), new_tokens=(16, 64),
           profile_ticks=5)
# Phase 9a: mixtral-8x22b trained at its published widths, depth cut to 1
# layer, 8-bit AdamW states (the reference's choice for this model), remat
# "full"; one TokenPipeline batch of 4 x 2,048 tokens repeated for 5 steps,
# a warmup of one step (the first step's lr_scale is 0).  At 2 layers a
# step peaks at 78.7 GB of the H100's 85 GB, past the 76 GB this phase keeps
# under: 61.5 GB of weights, int8 states and gradients, and ~17 GB for a
# layer's recompute (its chunked attention's float32 probabilities) and
# the loss.
TRAIN = dict(arch="mixtral-8x22b", n_layers=1, seed=0, batch=4, seq=2048,
             steps=5, lr=1e-4, warmup=1, state_bits=8)
# Phase 9b: the training driver on qwen2-0.5b at its full size, through a
# simulated node failure, then resumed; the reference's driver test's lr
# (its warmup of 200 steps keeps every step here far below it).
DRIVER = dict(arch="qwen2-0.5b", batch=8, seq=512, steps=12, fail_at=6,
              ckpt_every=4, resume_steps=15, lr=3e-3)
# Phase 10: the ssm, hybrid, encdec and vlm families at their published
# widths (src/repro_torch/configs/).  `layers` cuts a cell's depth (serving
# and training), `train_layers` the training model's alone; `duality` is
# the prompt length of 10a's float32 duality check, `duality_tol` its
# bound on |forward's last logits - the decode replay's|: on the CPU at
# full width (4 x 512 tokens, weights from torch.Generator seed 0) the two
# forms differ by at most 7.4e-6, with logits up to 1.46 and the same
# argmax; the card sums in other orders, so the bound leaves 13x that.
FAMILIES = (
    dict(tag="10a", arch="mamba2-370m", state_bits=32, steps=5,
         duality=512, duality_tol=1e-4),
    dict(tag="10b", arch="zamba2-7b", state_bits=8, steps=4),
    dict(tag="10c", arch="seamless-m4t-medium", state_bits=32, steps=4),
    dict(tag="10d", arch="llama-3.2-vision-90b", layers=5, gate=0.5,
         state_bits=8, steps=4),
)
FAMILY_RUN = dict(seed=0, batch=4, seq=2048, prefill_reps=3,
                  decode_steps=16, slots=8, max_seq=128, n_requests=24,
                  prompt_len=(8, 32), new_tokens=(8, 24), lr=1e-4,
                  warmup=1, peak_gb=76.0)
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
# Phase 11: `SHAPES` cells run on the card against the dry run's
# prediction (`repro_torch.launch.dryrun`), full depth, bf16 weights from a
# seeded generator: `ticks` decode steps at the cache's last positions, on
# the plain versions' eager step and then on the graph (`graph_passes`
# passes over the same positions and tokens); `peak_tol` bounds |the dry
# run's total_per_device / the measured peak - 1| over the weights, the
# cache and the first eager tick (None: printed, not gated).
DECODE_CELLS = (
    dict(tag="11b", arch="qwen2-0.5b", shape="decode_32k", seed=0, ticks=8,
         graph_passes=2, peak_tol=0.10),
    dict(tag="11c", arch="mamba2-370m", shape="long_500k", seed=0, ticks=4,
         graph_passes=2, peak_tol=None),
)


def mesh_prediction(arch: str, cell, mesh_kind: str | None, *,
                    layers: int | None = None, dtype: str | None = None,
                    bits: int = 32) -> dict:
    """The dry run's record (`run_cell`) of `arch` at `cell` (a
    ShapeCell) over `mesh_kind` (None: one card), the depth cut to
    `layers`, the parameters in `dtype`, one microbatch, `bits`-bit
    states; traced on fake tensors, no card (phase 11m and the four-card
    scripts' predictions)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    over = {k: v for k, v in (("n_layers", layers), ("param_dtype", dtype))
            if v is not None}
    rec = dryrun.run_cell(arch, cell, mesh_kind, n_micro=1, opt_bits=bits,
                          cfg_overrides=over or None)
    check(rec["status"] == "ok", f"the dry run of {arch} at {cell} over "
          f"{mesh_kind}: {rec.get('error')}")
    return rec


def mesh_predictions(mesh_kind: str) -> dict:
    """11m's (and the four-card scripts') predictions over `mesh_kind`:
    phase 9m "a"'s train step (also on one card, `card`) and phase 10m's
    three serving engines (also on one card), each a `mesh_prediction`
    record."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeCell
    a = MESH_TRAIN["a"]
    train = ShapeCell("9m-a", a["seq"], a["batch"], "train")
    out = {"9m-a": {mk or "card": mesh_prediction(
        a["arch"], train, mk, dtype=a["dtype"], bits=a["bits"])
        for mk in (None, mesh_kind)}}
    R = MESH_FAMILY_RUN
    for run, spec in MESH_FAMILY.items():
        cell = ShapeCell(f"10m-{run}", R["max_seq"], R["slots"], "decode")
        out[f"10m-{run}"] = {mk or "card": mesh_prediction(
            spec["arch"], cell, mk, layers=spec["layers"],
            dtype=spec["dtype"]) for mk in (None, mesh_kind)}
    return out


def resident(rec) -> int:
    """A serving record's params + cache bytes (its arguments but the
    tokens and positions)."""
    parts = rec["memory"]["argument_parts"]
    return parts["params"] + parts["state"]


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


class captures_watched:
    """Within the block, each `graph.CapturedStep` capture's host time and
    the card memory it pins: allocated and reserved after it less before
    it (the allocator's cache emptied first, as `torch.cuda.graph` empties
    it on entry).  `self.seen` lists them in order."""

    def __enter__(self):
        from repro_torch.graph import CapturedStep
        self.cls, self.real, self.seen = CapturedStep, CapturedStep.capture, []
        real, seen = self.real, self.seen

        def capture(step, bound, inputs):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            a0 = torch.cuda.memory_allocated()
            r0 = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            real(step, bound, inputs)
            torch.cuda.synchronize()
            seen.append(dict(
                capture_ms=(time.perf_counter() - t0) * 1e3,
                pinned_allocated_gb=(torch.cuda.memory_allocated() - a0) / 1e9,
                pinned_reserved_gb=(torch.cuda.memory_reserved() - r0) / 1e9))

        CapturedStep.capture = capture
        return self

    def __exit__(self, *exc):
        self.cls.capture = self.real
        return False


def capture_line(seen: list[dict]) -> str:
    return "; ".join(f"capture {c['capture_ms']:.1f} ms, pins "
                     f"{c['pinned_allocated_gb']:.3f} GB allocated, "
                     f"{c['pinned_reserved_gb']:.3f} GB reserved"
                     for c in seen)


def device_ms(fn, iters: int = 20, split: str = "") -> float:
    """Device time per call of `fn`: from torch.profiler's trace of
    `iters` calls after one warm-up, the sum over its CUDA kernels and
    memsets of each one's mean time times its launches per call (its count
    over `iters`, rounded: the profiler can drop a few events, most often
    the last call's).  Unlike `time_ms` it does not count the card waiting
    for the host, which sets the floor of a call that takes microseconds on
    the card.  With `split` (a label), each kernel's device time per call
    is printed too.  A trace that holds no device event (the profiler
    drops a short window's now and then) is taken again, up to eight
    times in all, and then fails."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(8):
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
    check(bool(events), "device_ms: eight traces held no device event")
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
    times in all, and then fails; each such trace is reported (its events,
    and those on the device whatever their time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        on_device = [e for e in events
                     if "CUDA" in str(getattr(e, "device_type", ""))]
        device = {e.key: e.count for e in on_device
                  if e.self_device_time_total > 0}
        if device:
            return {e.key for e in events}, device
        print(f"[profile] trace {attempt + 1} of {calls} calls held no "
              f"device event with a time: {len(events)} events, "
              f"{[(e.key[:40], e.count) for e in on_device]} on the device")
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


def cell_out_capacity(dev, plan, data) -> int:
    """The full-size two-way cell's output capacity: the exact
    per-destination maximum of its received fragments, quantized (a map
    and exchange on the kernels, outside any counted run)."""
    from repro_torch.core.executor import (ExecutorConfig,
                                           ShardedJoinExecutor, exchange,
                                           quantize_capacity, shared_columns)
    from repro_torch.kernels import ops
    n_dev = FULL["n_dev"]
    sizing = ShardedJoinExecutor(plan, n_dev, ExecutorConfig(), device=dev)
    s0 = sizing.session().prepare(data)
    frags = {}
    for rel, a in zip(plan.query.relations, s0._device_args):
        buf, _ = ops.scatter_pack(a.view(n_dev, -1, a.shape[1]),
                                  sizing.route_specs[rel.name], s0._ptable,
                                  plan.k, n_dev, s0.caps[rel.name])
        frags[rel.name] = exchange(buf)
    lcols, rcols = shared_columns(["A", "B", "__cell__"],
                                  ["B", "C", "__cell__"])
    return out_capacity_from_fragments(frags["R"], frags["S"], lcols, rcols,
                                       quantize_capacity)


def profile_calls(fn, label: str, calls: int = 1, top: int = 12,
                  tag: str = "profile", named: tuple[str, ...] = (),
                  banned: tuple[str, ...] = (),
                  sink: dict | None = None, cpu: bool = True) -> set[str]:
    """Where `calls` warm calls of `fn` spend device time: torch.profiler's
    per-kernel sums, and the device-busy share of their wall time; then
    every kernel whose name holds one of `named` or `banned`, in the top or
    not.  A trace that holds no device event, or misses a kernel of `named`
    (the profiler can drop events), is taken again, up to three times in
    all.  Returns the names of `named` and `banned` that some kernel's name
    holds; `sink` gets the wall, busy ms, busy share and top operations.
    `cpu=False` traces the device alone: a step of some 10^5 small
    launches traced with its CPU ops takes minutes to summarise."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
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
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    for e in ranked:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:90]}")
    if sink is not None:
        sink.update(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                    busy_share=busy_us / wall_us,
                    top=[[e.key[:60], e.self_device_time_total / 1e3]
                         for e in ranked[:5]])
    found = set()
    for e in events:
        hits = {name for name in named + banned if name in e.key}
        if hits:
            found |= hits
            print(f"[{tag}]   named: {e.self_device_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<4d} {e.key[:90]}")
    return found


def expected_launches(ex, fields, chunks: int = 1, prepare: bool = True
                      ) -> dict[str, int]:
    """Kernel launches of one prepare (one counting pass, as k > n_dev) and
    one run_batch under the arm `fields`: the fused map counts each
    relation once and packs it once a chunk; the staged map routes once
    per (relation, route with hashed attributes) in prepare and again in
    each chunk of the step, and folds and packs each relation once a
    chunk; each cascade step hashes, builds, probes and expands once
    (hash), or scans twice (group ids, run lengths) and expands once
    (sort-merge).  A key's first run_batch runs the step eagerly (the
    graph's warm-up), so this is that batch's count; with `prepare=False`
    it is one pass through the step alone, which the key's second
    run_batch makes when it captures the graph.  A replay launches nothing
    from the host."""
    n_rel = len(ex.query.relations)
    steps = n_rel - 1
    counted = 1 if prepare else 0
    want = dict.fromkeys(KERNEL_SITES, 0)
    if fields.get("fuse_map", True):
        want.update(map_count=counted * n_rel, scatter_pack=chunks * n_rel)
    else:
        hashed = sum(1 for spec in ex.route_specs.values()
                     for route in spec if route[0])
        want.update(route_cells=(counted + chunks) * hashed,
                    fold_cells=chunks * n_rel, bucket_pack=chunks * n_rel)
    if fields.get("hash_reduce", True):
        want.update(join_hash=steps, build_table=steps, probe_tables=steps,
                    expand_rows=steps)
    else:
        want.update(segment_scan=2 * steps, expand_rows=steps)
    return want


def warm_batches(ex, s, label: str, exact: int, step: dict[str, int],
                 captures: bool | None = True) -> tuple[float, float]:
    """No new step on a second batch, and that batch's launches: `step`
    (one pass through the step, as `expected_launches(prepare=False)`
    counts it) where it captures the step's graph, none where the graph
    exists already (`captures`: whether it must capture, None: either);
    then the warm run_batch median of 7, replays that launch no
    hand-written kernel from the host.  Returns (the median, the second
    batch's time) in s."""
    from repro_torch.kernels import ops
    compiles, before = ex.compile_count, ex.captures
    launches = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2 = s.run_batch()
    torch.cuda.synchronize()
    t_second = time.perf_counter() - t0
    check(ex.compile_count == compiles, f"{label}: second run_batch built "
          f"a new step")
    captured = ex.captures - before
    moved = {k: ops.LAUNCHES[k] - launches[k] for k in launches}
    want = step if captured else dict.fromkeys(launches, 0)
    check(captured in (0, 1) and (captures is None
                                  or captured == int(captures))
          and moved == want, f"{label}: the second run_batch captured "
          f"{captured} graphs (expected {captures}) and launched {moved}, "
          f"expected {want}")
    del res2
    launches = dict(ops.LAUNCHES)
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = s.run_batch()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del r
    check(dict(ops.LAUNCHES) == launches, f"{label}: a warm replay launched "
          f"kernels from the host: {launches} -> {dict(ops.LAUNCHES)}")
    t_batch = float(np.median(times))
    what = "capture + replay" if captured else "replay"
    print(f"[{label}] second run_batch ({what}) {t_second * 1e3:.2f} ms; "
          f"warm run_batch median {t_batch * 1e3:.2f} ms of {len(times)} "
          f"({', '.join(f'{t * 1e3:.2f}' for t in times)}); "
          f"{exact / t_batch:.4g} joined rows/s; no host launch in the 7 "
          f"warm replays")
    return t_batch, t_second


def graph_memory(ex, label: str) -> dict:
    """What the executor's captured steps hold on the card once the
    results are dropped: the graphs, the bytes allocated (static inputs
    and outputs, every live tensor) and reserved (the graph pool's
    segments too), after the allocator's free blocks are returned."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    got = dict(graphs=ex.captures,
               allocated_gb=torch.cuda.memory_allocated() / 1e9,
               reserved_gb=torch.cuda.memory_reserved() / 1e9)
    print(f"[{label}] {got['graphs']} graphs held; allocated "
          f"{got['allocated_gb']:.2f} GB, reserved {got['reserved_gb']:.2f} "
          f"GB")
    return got


def device_busy(s, label: str, t_warm: float) -> dict:
    """A device-only trace (no CPU ops) of one warm run_batch: its device
    busy time against the unprofiled warm median `t_warm` (s), the share
    of a plain warm loop the card is busy."""
    prof = {}
    profile_calls(s.run_batch, f"{label} warm run_batch, device only", 1,
                  top=8, sink=prof, cpu=False)
    prof["warm_ms"] = t_warm * 1e3
    prof["busy_of_warm"] = prof.get("busy_ms", float("nan")) / prof["warm_ms"]
    print(f"[profile] {label}: device busy {prof.get('busy_ms', 0):.3f} ms "
          f"of the unprofiled warm median {prof['warm_ms']:.3f} ms: busy "
          f"{100 * prof['busy_of_warm']:.1f} %, idle "
          f"{100 * (1 - prof['busy_of_warm']):.1f} %")
    return prof


def join_size(data) -> int:
    """The exact size of R(A,B) ⋈ S(B,C): Σ_v c_R(v)·c_S(v)."""
    cr = np.bincount(data["R"][:, 1])
    cs = np.bincount(data["S"][:, 0])
    m = min(len(cr), len(cs))
    return int((cr[:m].astype(np.int64) * cs[:m]).sum())


def full_cell(dev):
    """Phase 3: the full-size cell through prepare + run_batch on kernels."""
    from repro_torch.core import plan_skew_join, two_way
    from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
    from repro_torch.data import drifting_join_batch
    from repro_torch.kernels import ops

    q = two_way()
    t0 = time.perf_counter()
    data = drifting_join_batch(q, FULL["n"], FULL["hh_rows"],
                               FULL["tail_domain"], hot_set=(), hot_bonus=0,
                               seed=0)
    plan = plan_skew_join(q, data, FULL["k"])
    t_plan = time.perf_counter() - t0
    exact = join_size(data)
    print(f"[cell] two_way n={FULL['n']} per relation, k={FULL['k']}, "
          f"n_dev={FULL['n_dev']}: HH {dict(plan.hhs.per_attr)}, "
          f"{len(plan.residuals)} residuals, planned in {t_plan:.2f} s; "
          f"exact join size {exact}")

    # Size the output capacity from the received fragments (not counted).
    n_dev = FULL["n_dev"]
    cap_out = cell_out_capacity(dev, plan, data)
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
    t0 = time.perf_counter()
    res = s.run_batch()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_launches = {k: launches[k] - prepare_launches[k] for k in launches}
    print(f"[cell] launches on the main path {launches} "
          f"(the first run_batch's, the step run eagerly: {step_launches})")
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

    print(f"[cell] prepare {t_prepare * 1e3:.1f} ms; cold first run_batch "
          f"(eager: the graph's warm-up) {t_first * 1e3:.1f} ms")
    t_warm, t_second = warm_batches(
        ex, s, "cell", exact,
        expected_launches(ex, ARMS[FUSED_HASH], prepare=False))
    pins = graph_memory(ex, "cell")
    busy = device_busy(s, FUSED_HASH, t_warm)
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
                valid=valid_k, t_warm=t_warm, arms={FUSED_HASH: dict(
                    warm_ms=t_warm * 1e3, first_ms=t_first * 1e3,
                    second_ms=t_second * 1e3, peak_gb=peak / 1e9, **pins,
                    device_only=busy)})


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


def arm_cell(dev, cell, arm: str, named: tuple[str, ...]):
    """Phases 3b / 3c: the full-size cell on another arm (`ARMS[arm]`),
    held against phase 3's rows; a warm batch's profile must name each of
    `named`."""
    from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
    from repro_torch.kernels import ops

    n_dev, exact = FULL["n_dev"], cell["exact"]
    fields = ARMS[arm]
    tag = "staged" if arm == STAGED_SORT else "fused-sort"
    ex = ShardedJoinExecutor(cell["plan"], n_dev,
                             ExecutorConfig(out_capacity=cell["cap_out"],
                                            **fields), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launches()
    t0 = time.perf_counter()
    s = ex.session().prepare(cell["data"])
    torch.cuda.synchronize()
    t_prepare = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = s.run_batch()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {arm} launches {launches}")
    want = expected_launches(ex, fields)
    check(launches == want, f"{arm} launches {launches}, expected {want}")
    check(s.caps == cell["caps"], f"{arm} caps {s.caps} != {cell['caps']}")
    check(np.array_equal(s.placement.table, cell["table"]),
          f"{arm} derived another placement")
    check(int(res["shuffle_overflow"].sum()) == 0,
          f"{arm} shuffle overflow {res['shuffle_overflow_by_rel'].tolist()}")
    check(int(res["join_overflow"].sum()) == 0,
          f"{arm} join overflow {res['join_overflow'].tolist()}")
    n_valid = int(res.tensors[1].sum())
    check(n_valid == exact, f"{arm} valid rows {n_valid} != exact {exact}")
    check(torch.equal(res.tensors[0], cell["rows"])
          and torch.equal(res.tensors[1], cell["valid"]),
          f"{arm} rows differ from {FUSED_HASH}'s")
    del res
    print(f"[{tag}] rows torch.equal to {FUSED_HASH}'s, zero overflow, "
          f"{n_valid} valid rows; prepare {t_prepare * 1e3:.1f} ms; cold "
          f"first run_batch (eager: the graph's warm-up) "
          f"{t_first * 1e3:.1f} ms; peak allocated (measured) "
          f"{peak / 1e9:.2f} GB, {(peak - held) / 1e9:.2f} GB over the "
          f"{held / 1e9:.2f} GB held before (phase 3's rows)")
    t_warm, t_second = warm_batches(
        ex, s, tag, exact, expected_launches(ex, fields, prepare=False))
    pins = graph_memory(ex, tag)
    busy = device_busy(s, arm, t_warm)
    found = profile_calls(s.run_batch, "warm run_batch", named=named)
    check(found == set(named), f"kernels missing from the {arm} warm "
          f"batch's profile: {set(named) - found}")
    return dict(ex=ex, session=s, launches=launches, summary=dict(
        warm_ms=t_warm * 1e3, first_ms=t_first * 1e3,
        second_ms=t_second * 1e3, peak_gb=peak / 1e9,
        peak_over_held_gb=(peak - held) / 1e9, **pins, device_only=busy))


def mesh_rank(rank: int, world: int, backend: str, out_dir: str,
              cap_out: int, shared: dict) -> None:
    """One rank of phase 3m (a spawned process): phase 3's plan and data
    (pickled in `out_dir`) over a mesh of `world` ranks on `backend` (gloo
    ranks share card 0), fused + hash.  `shared` holds phase 3's outputs
    `rows` and `valid`, shared from the parent through CUDA IPC: this
    rank's destinations' must equal its own, bit for bit; the rank empties
    it when it is done, which releases its hold on them.  Writes what it
    measured to rank<r>.json in `out_dir`."""
    import pickle

    import torch.distributed as dist
    from repro_torch.core.executor import (ExecutorConfig,
                                           ShardedJoinExecutor,
                                           start_mesh_exchange)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_join_mesh

    with open(Path(out_dir) / "cell.pkl", "rb") as f:
        plan, data = pickle.load(f)
    t0 = time.perf_counter()
    mesh = make_join_mesh(backend, device="cuda:0" if backend == "gloo"
                          else None, init_method=f"file://{out_dir}/store",
                          rank=rank, world_size=world, timeout_s=300)
    t_mesh = time.perf_counter() - t0
    try:
        n_dev = FULL["n_dev"]
        ex = ShardedJoinExecutor(plan, n_dev,
                                 ExecutorConfig(out_capacity=cap_out),
                                 mesh=mesh)
        label = f"3m {backend} rank {rank} of {world}"
        # The mesh path: counts zeroed just before, read just after.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        s = ex.session().prepare(data)
        torch.cuda.synchronize()
        t_prepare = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = s.run_batch()
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        want = expected_launches(ex, ARMS[FUSED_HASH])
        check(launches == want, f"{label}: launches {launches}, expected "
              f"{want}")
        check(int(res["shuffle_overflow"].sum()) == 0
              and int(res["join_overflow"].sum()) == 0,
              f"{label}: overflow {res['shuffle_overflow_by_rel'].tolist()} "
              f"{res['join_overflow'].tolist()}")
        per = n_dev // world
        mine = slice(rank * per, (rank + 1) * per)
        check(torch.equal(res.tensors[0], shared["rows"][mine])
              and torch.equal(res.tensors[1], shared["valid"][mine]),
              f"{label}: rows differ from phase 3's for destinations "
              f"{mine.start}..{mine.stop - 1}")
        n_valid = int(res.tensors[1].sum())
        recv_valid = int(res["recv_counts"][mine].sum())
        del res
        # Warm batches: no new step; each runs the step eagerly.
        compiles = ex.compile_count
        step = expected_launches(ex, ARMS[FUSED_HASH], prepare=False)
        ops.reset_launches()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = s.run_batch()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del r
        check(ex.compile_count == compiles == 1 and ex.step_hits == 5,
              f"{label}: {ex.compile_count} steps built, {ex.step_hits} hits")
        check(dict(ops.LAUNCHES) == {k: 5 * v for k, v in step.items()},
              f"{label}: warm batches launched {dict(ops.LAUNCHES)}")
        # The exchange alone on each relation's send buffer: its wall
        # time, the bytes it sends to other ranks (the buffer's rows for
        # other ranks' destinations, -1 padding included) and the valid
        # copies among them (the count matrices folded through the
        # placement, summed over this rank's sources and the other
        # ranks' destinations).
        fold = np.zeros((ex.k, n_dev), np.int64)
        fold[np.arange(ex.k), s.placement.table] = 1
        others = np.ones(n_dev, bool)
        others[mine] = False
        exchange = {}
        for rel, a, counts in zip(ex.query.relations, s._device_args,
                                  s._count_mats):
            cap = s.caps[rel.name]
            buf, _ = ex._pack(a.view(per, -1, a.shape[1]),
                              ex.route_specs[rel.name], s._ptable, cap)
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start_mesh_exchange(buf, ex.group, world)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            sent = (counts @ fold)[mine][:, others]
            exchange[rel.name] = dict(
                wall_ms=float(np.median(walls)) * 1e3,
                walls_ms=[t * 1e3 for t in walls],
                bytes_off_rank=per * (n_dev - per) * cap * buf.shape[-1] * 4,
                valid_copies_off_rank=int(sent.sum()))
            del buf
        got = dict(rank=rank, world=world,
                   backend=dist.get_backend(ex.group), device=str(ex.device),
                   mesh_s=t_mesh, prepare_ms=t_prepare * 1e3,
                   first_ms=t_first * 1e3,
                   warm_ms=float(np.median(times)) * 1e3,
                   warm_all_ms=[t * 1e3 for t in times], exchange=exchange,
                   recv_valid=recv_valid, n_valid=n_valid,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=launches)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(got))
    finally:
        shared.clear()
        dist.destroy_process_group()


def mesh_cell(cell) -> dict:
    """Phase 3m: phase 3's cell over a mesh of ranks, spawned processes
    (`mesh_rank`), each run joined with a deadline and its ranks' rows
    held to phase 3's."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    runs = {}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    for backend, world in MESH_RUNS:
        # The ranks' hold on phase 3's rows and flags (CUDA IPC) ends when
        # each rank empties its copy of this dict and this one is emptied.
        shared = {"rows": cell["rows"], "valid": cell["valid"]}
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            # Through a file: a start's arguments travel on a pipe that
            # blocks past its buffer until the rank has imported, which
            # would start the ranks one after another.
            with open(Path(tmp) / "cell.pkl", "wb") as f:
                pickle.dump((cell["plan"], cell["data"]), f)
            ctx = mp.start_processes(
                mesh_rank, args=(world, backend, tmp, cell["cap_out"],
                                 shared),
                nprocs=world, join=False, start_method="spawn")
            deadline = time.monotonic() + MESH_DEADLINE_S
            try:
                while not ctx.join(timeout=5):
                    check(time.monotonic() < deadline, f"3m {backend} W="
                          f"{world}: ranks still running at the deadline")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
                del ctx
                shared.clear()
                gc.collect()
                torch.cuda.ipc_collect()
            ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                     for r in range(world)]
            wall = time.perf_counter() - t0
        total = sum(r["n_valid"] for r in ranks)
        check(total == cell["exact"], f"3m {backend} W={world}: the ranks' "
              f"valid rows sum to {total}, not {cell['exact']}")
        for r in ranks:
            ex_ms = ", ".join(
                f"{rel} {e['wall_ms']:.2f} ms, {e['bytes_off_rank']} B off "
                f"rank ({e['valid_copies_off_rank']} valid copies)"
                for rel, e in r["exchange"].items())
            print(f"[mesh] {backend} W={world} rank {r['rank']} on "
                  f"{r['device']}, exchange path: CUDA tensors to "
                  f"{r['backend']}'s all_to_all_single: rendezvous and "
                  f"mesh {r['mesh_s']:.2f} s; prepare {r['prepare_ms']:.1f} ms; "
                  f"first run_batch {r['first_ms']:.1f} ms; warm run_batch "
                  f"median {r['warm_ms']:.2f} ms of 5 (eager); exchange "
                  f"alone: {ex_ms}; {r['recv_valid']} valid copies "
                  f"received (recv_counts); {r['n_valid']} valid rows; peak "
                  f"allocated {r['peak_gb']:.2f} GB")
        print(f"[mesh] {backend} W={world}: every rank's rows torch.equal to "
              f"phase 3's for its destinations, zero overflow, {total} valid "
              f"rows, no new step at the second batch; {wall:.1f} s with "
              f"the spawn")
        runs[f"{backend}_w{world}"] = dict(ranks=ranks, wall_s=wall)
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated()
    print(f"[mesh] allocated {held / 1e9:.2f} GB before the phase (phase "
          f"3's rows and flags among them), {left / 1e9:.2f} GB after it")
    check(left <= held + (1 << 28), f"3m: {(left - held) / 1e9:.2f} GB "
          f"still held after the phase")
    return runs


def heal_schedule(ex, data, lose, checkpoint) -> tuple[object, dict]:
    """Phase 6m's schedule on executor `ex` (one process, or a rank of a
    mesh): an adaptive SelfHealingSession with caps squeezed to an eighth
    (the retry ladder), device 3's heartbeats dropped until it is evicted,
    `lose(eng)` (the last rank's devices), degraded warm batches, a forced
    re-place and a warm re-plan.  `checkpoint(label, result)` is given the
    healed batch, the batch that evicted device 3, the last degraded batch
    and the batches after each forced action.  Returns the session and the
    walls of the healed batch and of the degraded ones."""
    from repro_torch.core import AdaptPolicy
    from repro_torch.ft import ChaosInjector
    from repro_torch.serve import SelfHealingSession

    dead = HEALING["dead"]
    chaos = ChaosInjector(FULL["n_dev"], seed=0)
    chaos.squeeze_caps(HEALING["squeeze"])
    eng = SelfHealingSession(
        ex, chaos=chaos, heartbeat_timeout_s=MESH_HEAL["heartbeat_timeout_s"],
        suspect_timeout_s=MESH_HEAL["suspect_timeout_s"], step_seconds=1.0,
        adapt=AdaptPolicy(**ADAPT_POLICY)).prepare(data)
    res, healed = synced_ms(eng.run_batch)
    checkpoint("healed", res)
    chaos.drop_heartbeats(dead)
    while dead not in eng.evicted and eng.stats["batches"] < 16:
        res = None
        res = eng.run_batch()
    checkpoint("dead", res)
    chaos.restore_heartbeats(dead)
    lose(eng)
    degraded = []
    for _ in range(MESH_HEAL["degraded"]):
        res = None
        res, ms = synced_ms(eng.run_batch)
        degraded.append(ms)
    checkpoint("degraded", res)
    res = None
    eng.force_replace()
    checkpoint("replaced", eng.run_batch())
    eng.force_replan()
    checkpoint("replanned", eng.run_batch())
    return eng, dict(healed_ms=healed, degraded_ms=float(np.median(degraded)),
                     degraded_all_ms=degraded)


def heal_counters(eng) -> dict:
    """What every rank and the one-process session must agree on after the
    schedule."""
    st = eng.stats
    return dict(
        {k: st[k] for k in ("batches", "retries", "escalations", "refolds",
                            "refold_compiles", "replacements",
                            "replace_compiles", "replans", "replan_compiles")},
        shuffle_overflow=np.asarray(st["shuffle_overflow"]).tolist(),
        join_overflow=np.asarray(st["join_overflow"]).tolist(),
        alive=list(eng.alive), evicted=list(eng.evicted),
        table=np.asarray(eng.session.placement.table).tolist(),
        caps=dict(eng.session.caps), cap_out=int(eng.session.cap_out),
        compiles=int(eng.executor.compile_count),
        plan_hhs={a: [int(x) for x in v]
                  for a, v in eng.executor.plan.hhs.per_attr.items()})


def serve_schedule(data, mesh, dev):
    """Phase 6m's serving: MESH_HEAL's mixed_workload requests on an
    engine at k = n_devices, then the full-size cell as one request on an
    engine at k = 256, over `mesh` (or on `dev`).  Returns the mixed
    requests, the full request, each engine's stats and the figures."""
    from repro_torch.core import two_way
    from repro_torch.core.executor import RetryPolicy
    from repro_torch.data import mixed_workload
    from repro_torch.serve import JoinServingEngine

    where = dict(mesh=mesh) if mesh is not None else dict(device=dev)
    retry = RetryPolicy(max_retries=SERVE["max_retries"])
    small = JoinServingEngine(FULL["n_dev"], retry=retry, **where)
    reqs = [small.submit(t, q, d) for t, q, d in
            mixed_workload(MESH_HEAL["requests"], seed=0)]
    _, wall = synced_ms(small.run)
    full = JoinServingEngine(FULL["n_dev"], k=FULL["k"], retry=retry,
                             **where)
    req = full.submit("full", two_way(), data)
    _, full_ms = synced_ms(full.run)
    return reqs, req, dict(small=small.stats, full=full.stats), dict(
        requests_per_s=len(reqs) / (wall / 1e3), mixed_wall_ms=wall,
        full_ms=full_ms)


def rank_part(rows, want, label: str) -> None:
    """A mesh rank's rows of a request: at the rank's offset (the earlier
    ranks' row counts, one all_gather) equal to the one-process rows
    `want` (numpy, or a tensor on the card); the ranks' counts sum to
    len(want)."""
    import torch.distributed as dist
    n = torch.tensor([len(rows)], dtype=torch.int64,
                     device=torch.device("cuda", torch.cuda.current_device()))
    parts = [torch.empty_like(n) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, n)
    counts = [int(p) for p in parts]
    off = sum(counts[:dist.get_rank()])
    check(sum(counts) == len(want), f"{label}: the ranks hold "
          f"{sum(counts)} rows, not {len(want)}")
    if isinstance(want, torch.Tensor):
        same = torch.equal(torch.from_numpy(rows).to(want.device),
                           want[off:off + len(rows)])
    else:
        same = np.array_equal(rows, want[off:off + len(rows)])
    check(same, f"{label}: rows differ from the one-process rows at "
          f"{off}..{off + len(rows)}")


def mesh_heal_rank(rank: int, world: int, backend: str, out_dir: str,
                   cap_out: int, refs: dict) -> None:
    """One rank of phase 6m (a spawned process): the schedule and the
    serving over a mesh of `world` ranks on `backend` (gloo ranks share
    card 0), each checkpoint and request held to the one-process run's
    (`refs`: checkpoint tensors through CUDA IPC; the mixed requests' rows
    and the plan and data in out_dir's pickle).  Writes its counters,
    figures and launches to rank<r>.json."""
    import pickle

    import torch.distributed as dist
    from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_join_mesh

    with open(Path(out_dir) / "cell.pkl", "rb") as f:
        plan, data, mixed_rows = pickle.load(f)
    mesh = make_join_mesh(backend, device="cuda:0" if backend == "gloo"
                          else None, init_method=f"file://{out_dir}/store",
                          rank=rank, world_size=world,
                          timeout_s=MESH_HEAL["timeout_s"])
    try:
        n_dev = FULL["n_dev"]
        per = n_dev // world
        mine = slice(rank * per, (rank + 1) * per)
        label = f"6m {backend} rank {rank} of {world}"
        ex = ShardedJoinExecutor(plan, n_dev, ExecutorConfig(
            out_capacity=cap_out, overlap_shuffle=HEALING["chunks"]),
            mesh=mesh)
        lost = list(MESH_HEAL["lost"])

        def lose(eng):
            if world == 1:
                eng.evict_devices(lost)
            else:
                check(list(range(n_dev - per, n_dev)) == lost,
                      f"{label}: the last rank holds other devices")
                eng.evict_rank(world - 1)

        def checkpoint(name, res):
            rows, valid = refs[name]
            check(torch.equal(res.tensors[0], rows[mine])
                  and torch.equal(res.tensors[1], valid[mine]),
                  f"{label}: {name} batch's rows differ from the one-process"
                  f" session's for destinations {mine.start}..{mine.stop - 1}")

        # The mesh path: counts zeroed just before, read just after.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        eng, figures = heal_schedule(ex, data, lose, checkpoint)
        counters = heal_counters(eng)
        del eng, ex
        reqs, req, engines, serving = serve_schedule(data, mesh, None)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        for i, (r, want) in enumerate(zip(reqs, mixed_rows)):
            rank_part(r.rows, want, f"{label}: mixed request {i}")
        rank_part(req.rows, refs["full"], f"{label}: the full request")
        del reqs, req
        got = dict(rank=rank, world=world, device=str(torch.device(
            "cuda", torch.cuda.current_device())), counters=counters,
            engines=engines, figures=figures, serving=serving,
            launches=launches,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(got))
    finally:
        # The shared tensors are the parent's until every rank has freed
        # them: the spawn's arguments still hold this dict, so empty it.
        refs.clear()
        gc.collect()
        dist.destroy_process_group()


def mesh_healing(dev, cell, card: str) -> dict:
    """Phase 6m: phase 6's healing, 6e's forced adaptation and phase 8's
    serving over a mesh of ranks, held to the same schedule run in this
    process first (see the module docstring)."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp
    from repro_torch.core import canonical, reference_join
    from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
    from repro_torch.data import mixed_workload

    n_dev, data, plan = FULL["n_dev"], cell["data"], cell["plan"]
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    refs = {}

    def keep(name, res):
        same_rows(res, cell, f"6m one process, {name}")
        # A copy of its own: a later replay of the one-process graphs
        # would write over the result's tensors.
        refs[name] = tuple(t.clone() for t in res.tensors[:2])

    ex = ShardedJoinExecutor(plan, n_dev, ExecutorConfig(
        out_capacity=cell["cap_out"], overlap_shuffle=HEALING["chunks"]),
        device=dev)
    lost = list(MESH_HEAL["lost"])
    eng, figures = heal_schedule(ex, data,
                                 lambda e: e.evict_devices(lost), keep)
    want = heal_counters(eng)
    check(want["retries"] >= 1 and want["evicted"] == [HEALING["dead"]] + lost
          and want["refolds"] == 2 and want["replacements"] == 1
          and want["replans"] == 1 and want["replan_compiles"] == 0,
          f"6m one process: the schedule's counters {want}")
    del eng, ex
    reqs, req, engines, serving = serve_schedule(data, None, dev)
    for r, (_, q, d) in zip(reqs, mixed_workload(MESH_HEAL["requests"],
                                                 seed=0)):
        check(np.array_equal(canonical(r.rows), canonical(reference_join(q, d))),
              f"6m one process: mixed request {r.rid} not exact")
    check(len(req.rows) == cell["exact"], f"6m one process: the full "
          f"request has {len(req.rows)} rows")
    refs["full"] = torch.from_numpy(req.rows).to(dev)
    check(torch.equal(packed_rows(refs["full"], torch.ones(
        len(req.rows), dtype=torch.bool, device=dev)), cell["sorted"]),
        "6m one process: the full request's rows differ from phase 3's")
    mixed_rows = [r.rows for r in reqs]
    del reqs, req
    gc.collect()
    torch.cuda.empty_cache()
    t_one = time.perf_counter() - t0
    print(f"[mesh-heal] {card}: one process (the reference) took "
          f"{t_one:.1f} s: healed batch {figures['healed_ms']:.1f} ms, "
          f"degraded median {figures['degraded_ms']:.1f} ms, "
          f"{serving['requests_per_s']:.1f} requests/s, full request "
          f"{serving['full_ms']:.1f} ms; counters {json.dumps(want)}")

    out = dict(one_process=dict(counters=want, figures=figures,
                                serving=serving, wall_s=t_one))
    for backend, world in MESH_RUNS:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            with open(Path(tmp) / "cell.pkl", "wb") as f:
                pickle.dump((plan, data, mixed_rows), f)
            ctx = mp.start_processes(
                mesh_heal_rank, args=(world, backend, tmp, cell["cap_out"],
                                      refs),
                nprocs=world, join=False, start_method="spawn")
            deadline = time.monotonic() + MESH_HEAL["deadline_s"]
            try:
                while not ctx.join(timeout=5):
                    check(time.monotonic() < deadline, f"6m {backend} W="
                          f"{world}: ranks still running at the deadline")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
                torch.cuda.ipc_collect()
            ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                     for r in range(world)]
            wall = time.perf_counter() - t0
        for r in ranks:
            label = f"6m {backend} W={world} rank {r['rank']}"
            check(r["counters"] == json.loads(json.dumps(want)),
                  f"{label}: counters {r['counters']} differ from the "
                  f"one-process session's {want}")
            check(r["engines"] == json.loads(json.dumps(engines)),
                  f"{label}: engine stats differ from the one-process "
                  f"engines'")
            missing = [k for k in MESH_KERNELS if not r["launches"][k]]
            check(not missing, f"{label}: {missing} never launched")
        r0 = ranks[0]
        print(f"[mesh-heal] {card}: {backend} W={world}: every rank's rows "
              f"torch.equal to the one-process session's at each "
              f"checkpoint (healed, dead, degraded, replaced, replanned) and "
              f"to its engines' at the rank's offset, every counter equal on "
              f"every rank and to the one-process run's; rank 0: healed "
              f"batch {r0['figures']['healed_ms']:.1f} ms, degraded median "
              f"{r0['figures']['degraded_ms']:.1f} ms of "
              f"{MESH_HEAL['degraded']} on {n_dev - 3} survivors, "
              f"{r0['serving']['requests_per_s']:.1f} requests/s over "
              f"{MESH_HEAL['requests']} mixed requests, full request "
              f"{r0['serving']['full_ms']:.1f} ms; launches "
              f"{ {k: r0['launches'][k] for k in MESH_KERNELS} }; peak "
              f"allocated {max(r['peak_gb'] for r in ranks):.2f} GB a rank; "
              f"{wall:.1f} s with the spawn")
        out[f"{backend}_w{world}"] = dict(
            wall_s=wall, ranks=[{k: r[k] for k in (
                "rank", "device", "figures", "serving", "launches",
                "peak_gb")} for r in ranks])
    # The spawned processes' arguments hold this dict too: emptying it
    # frees the shared tensors once CUDA IPC has collected them.
    refs.clear()
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"[mesh-heal] allocated {held / 1e9:.2f} GB before the phase, "
          f"{left / 1e9:.2f} GB after it")
    check(left <= held + (1 << 28), f"6m: {(left - held) / 1e9:.2f} GB "
          f"still held after the phase")
    return out


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


def packed_rows(rows, valid):
    """The valid rows (A, B, C) of a result as sorted int64 words
    A·2^42 + B·2^21 + C, on the card: a multiset that `torch.equal`
    compares (each value must be < 2^21)."""
    r = rows[valid].long()
    check(int(r.min()) >= 0 and int(r.max()) < 1 << 21,
          "a joined value outside [0, 2^21): the packed multiset would alias")
    return torch.sort((r[:, 0] << 42) | (r[:, 1] << 21) | r[:, 2]).values


def same_rows(res, cell, label: str) -> None:
    """The exact join size, no delivered overflow, and phase 3's rows as a
    multiset."""
    check(int(res["shuffle_overflow"].sum()) == 0
          and int(res["join_overflow"].sum()) == 0,
          f"{label}: delivered overflow")
    n_valid = int(res.tensors[1].sum())
    check(n_valid == cell["exact"], f"{label}: valid rows {n_valid} != "
          f"exact {cell['exact']}")
    check(torch.equal(packed_rows(res.tensors[0], res.tensors[1]),
                      cell["sorted"]),
          f"{label}: rows differ from phase 3's as a multiset")


def device_events(fn, done) -> list[dict]:
    """The device operations (kernels, copies, memsets) of one warm call
    of `fn` under torch.profiler, read from its Chrome trace, each with its
    stream; the trace is retaken up to three times until `done(events)`
    (the profiler drops device events at times)."""
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r = fn()
            torch.cuda.synchronize()
        del r
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        device = [e for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and "stream" in e.get("args", {})]
        if done(device):
            break
    return device


def _streams(device: list[dict]) -> tuple[set, dict]:
    """(the streams scatter_pack's kernels ran on, copy kernels a
    stream)."""
    pack = {e["args"]["stream"] for e in device
            if any(name in e["name"] for name in SCATTER_KERNELS)}
    copies: dict = {}
    for e in device:
        if "copy" in e["name"]:
            st = e["args"]["stream"]
            copies[st] = copies.get(st, 0) + 1
    return pack, copies


def _busy(device: list[dict]) -> tuple[float, float]:
    """(device time summed over operations, device busy time: the union
    of their intervals, less than the sum where streams overlap), in us."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in device)
    busy, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return sum(t1 - t0 for t0, t1 in spans), busy


def stream_trace(fn, n_rel: int, chunks: int) -> dict:
    """One warm call of `fn`, an eager chunked step, under torch.profiler:
    the chunked exchange's copies must run on a stream that runs no
    scatter_pack kernel (`n_rel` x `chunks` of them a call).  Returns the
    device time summed over operations and the device busy time, in ms."""
    def done(device):
        pack, copies = _streams(device)
        return bool(pack) and any(st not in pack for st in copies)

    device = device_events(fn, done)
    pack, copies = _streams(device)
    side = {st: n for st, n in copies.items() if st not in pack}
    check(bool(pack) and bool(side), f"chunked exchange: no copy on a stream "
          f"other than scatter_pack's (scatter_pack on {pack}, copies "
          f"{copies})")
    check(sorted(side.values()) == [n_rel * chunks],
          f"chunked exchange: copies a stream {side}, expected one side "
          f"stream with {n_rel * chunks}")
    total, busy = _busy(device)
    print(f"[healing] 6a eager step's streams: scatter_pack's kernels on "
          f"{sorted(pack)}, the exchange's {n_rel * chunks} copies on side "
          f"stream {sorted(side)}; device time {total / 1e3:.2f} ms summed "
          f"over {len(device)} operations, busy {busy / 1e3:.2f} ms (union)")
    return dict(device_sum_ms=total / 1e3, device_busy_ms=busy / 1e3,
                copies_on_side=n_rel * chunks)


def replay_streams(fn) -> dict:
    """One warm replay of the chunked step's graph (`fn`) under
    torch.profiler: which streams CUDA gave its operations, the copy
    kernels a stream, its device time summed and busy, and how long the
    copies ran beside another stream's operations (ms): whether the
    replay overlaps the exchange's copies with the packs."""
    device = device_events(fn, lambda device: bool(_streams(device)[0]))
    pack, copies = _streams(device)
    check(bool(pack), "6a: the replay's trace holds no scatter_pack kernel")

    def span(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    overlap = sum(max(0.0, min(c1, e1) - max(c0, e0))
                  for c in device if "copy" in c["name"]
                  for c0, c1 in [span(c)]
                  for e in device if e["args"]["stream"] != c["args"]["stream"]
                  for e0, e1 in [span(e)])
    streams = sorted({e["args"]["stream"] for e in device})
    total, busy = _busy(device)
    print(f"[healing] 6a replay's streams: its operations on {streams}, "
          f"scatter_pack's kernels on {sorted(pack)}, copy kernels a stream "
          f"{copies}; device time {total / 1e3:.3f} ms summed over "
          f"{len(device)} operations, busy {busy / 1e3:.3f} ms (union); "
          f"copies beside another stream's operations {overlap / 1e3:.3f} ms")
    return dict(replay_streams=len(streams), replay_copies=copies,
                replay_device_sum_ms=total / 1e3,
                replay_device_busy_ms=busy / 1e3,
                replay_copy_overlap_ms=overlap / 1e3)


def graph_nodes(dot: str) -> tuple[dict[str, str], list[tuple[str, str]]]:
    """({node: its DOT text}, [(from, to), ...]) of a CUDA graph written
    by `cudaGraphDebugDotPrint`."""
    import re
    nodes, edges = {}, []
    starts = [m for m in re.finditer(r'"([^"]+)"\s*\[', dot)
              if not dot[:m.start()].rstrip().endswith("->")]
    for m, nxt in zip(starts, starts[1:] + [None]):
        nodes[m.group(1)] = dot[m.end():nxt.start() if nxt else len(dot)]
    edges = re.findall(r'"([^"]+)"(?::\w+)?\s*->\s*"([^"]+)"', dot)
    return nodes, edges


def exchange_graph(ex, s, n_rel: int, chunks: int) -> dict:
    """The chunked step captured once more through the executor's own
    capture (`_GraphStep`), CUDA's graph kept (`keep_graph=True`) and
    written as DOT, then its exchange read from the nodes and edges.  P_j,
    the pack of chunk j (j = 0 .. n_rel·chunks - 1, relation-major), is
    the graph's j-th scatter_rank_kernel node in dependency order; X_j, its
    exchange copy, a copy kernel whose latest pack ancestor is P_j.  For
    every chunk but the last of a relation there must be exactly one such
    copy that P_{j+1} neither waits for nor precedes: the copy forked off
    beside the next pack.  The last chunk's copy is the one copy kernel
    after X_{j-1} with P_j its latest pack that precedes every other such
    copy (the side stream's chain; nothing is left to overlap with).  So
    exactly n_rel x chunks exchange copies, each after its own pack and no
    later one.  A step captured on one stream fails."""
    import os
    import tempfile
    from repro_torch.core.executor import _GraphStep
    cfg = ex.config
    caps = tuple(int(s.caps[r.name]) for r in ex.query.relations)
    cap_out = cfg.out_capacity if s.cap_out is None else int(s.cap_out)
    step = _GraphStep(ex, caps, cap_out)
    real = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = lambda: real(keep_graph=True)
    try:
        step.compiled.capture((), (s._ptable, *s._device_args))
    finally:
        torch.cuda.CUDAGraph = real
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "step.dot")
        step.compiled.graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    del step
    nodes, edges = graph_nodes(dot)
    names = list(nodes)
    index = {n: i for i, n in enumerate(names)}
    parents = [[] for _ in names]
    for a, b in edges:
        if a in index and b in index:
            parents[index[b]].append(index[a])
    anc = [None] * len(names)            # bitset of each node's ancestors

    def ancestors(i):
        stack = [i]
        while stack:
            j = stack[-1]
            todo = [p for p in parents[j] if anc[p] is None]
            if todo:
                stack.extend(todo)
                continue
            stack.pop()
            if anc[j] is None:
                bits = 0
                for p in parents[j]:
                    bits |= anc[p] | (1 << p)
                anc[j] = bits
        return anc[i]

    for i in range(len(names)):
        ancestors(i)
    packs = [i for i, n in enumerate(names)
             if "scatter_rank_kernel" in nodes[n]]
    packs.sort(key=lambda i: bin(anc[i]).count("1"))
    copy_nodes = [i for i, n in enumerate(names)
                  if "copy" in nodes[n].lower()
                  and not any(k in nodes[n] for k in SCATTER_KERNELS)]
    total = n_rel * chunks

    def diagnose(msg):
        print(dot[:4000])
        fail(f"6a graph: {msg} ({len(names)} nodes, {len(edges)} edges, "
             f"{len(packs)} packs, {len(copy_nodes)} copy kernels)")

    if len(packs) != total or any(not anc[b] >> a & 1
                                  for a, b in zip(packs, packs[1:])):
        diagnose(f"expected {total} scatter_rank_kernel nodes in one chain")

    def latest_pack(c):
        got = [j for j, p in enumerate(packs) if anc[c] >> p & 1]
        return max(got) if got else -1

    last = {c: latest_pack(c) for c in copy_nodes}
    exchange = []
    for j in range(total):
        own = [c for c in copy_nodes if last[c] == j]
        if (j + 1) % chunks:
            nxt = packs[j + 1]
            x = [c for c in own if not anc[nxt] >> c & 1
                 and not anc[c] >> nxt & 1]
        else:
            after = [c for c in own if anc[c] >> exchange[-1] & 1]
            x = [c for c in after
                 if all(anc[o] >> c & 1 for o in after if o != c)]
        if len(x) != 1:
            diagnose(f"chunk {j}: {len(x)} exchange copies, expected 1")
        exchange.append(x[0])
    print(f"[healing] 6a graph: {len(names)} nodes, {len(edges)} edges; "
          f"{total} packs in one chain and exactly {total} exchange copies, "
          f"each after its own chunk's pack and before no later one; every "
          f"copy but a relation's last runs beside the next pack "
          f"(neither waits for the other)")
    return dict(graph_nodes=len(names), graph_exchange_copies=len(exchange))


def self_healing(dev, cell):
    """Phase 6: the chunked exchange and the self-healing loop on the
    full-size cell (fused + hash), each sub-phase held to the exact join
    size and phase 3's rows as a multiset."""
    from repro_torch.core.executor import (ExecutorConfig,
                                           RetryBudgetExceededError,
                                           RetryPolicy, ShardedJoinExecutor)
    from repro_torch.ft import ChaosInjector
    from repro_torch.kernels import ops
    from repro_torch.serve import SelfHealingSession

    n_dev, data, plan = FULL["n_dev"], cell["data"], cell["plan"]
    chunks = HEALING["chunks"]
    out = {}

    # 6a. The chunked exchange: counts zeroed just before prepare + the
    # first batch, read just after.
    ex = ShardedJoinExecutor(plan, n_dev, ExecutorConfig(
        out_capacity=cell["cap_out"], overlap_shuffle=chunks), device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    s = ex.session().prepare(data)
    res = s.run_batch()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    want = expected_launches(ex, ARMS[FUSED_HASH], chunks)
    check(launches == want, f"6a launches {launches}, expected {want}")
    serial_caps = cell["caps"]
    check(s.caps == {r: -(-c // chunks) for r, c in serial_caps.items()},
          f"6a caps {s.caps} are not ⌈{serial_caps} / {chunks}⌉")
    same_rows(res, cell, "6a")
    del res
    t_chunked, _ = warm_batches(
        ex, s, "healing 6a", cell["exact"],
        expected_launches(ex, ARMS[FUSED_HASH], chunks, prepare=False))
    n_rel = len(plan.query.relations)
    caps_t = tuple(int(s.caps[r.name]) for r in plan.query.relations)
    cap_out = cell["cap_out"] if s.cap_out is None else int(s.cap_out)
    trace = stream_trace(lambda: ex._step(s._ptable, s._device_args, caps_t,
                                          cap_out), n_rel, chunks)
    trace.update(replay_streams(s.run_batch))
    trace.update(exchange_graph(ex, s, n_rel, chunks))
    out["chunked"] = dict(chunks=chunks, caps=s.caps, launches={
        k: v for k, v in launches.items() if v},
        median_ms=t_chunked * 1e3, serial_median_ms=cell["t_warm"] * 1e3,
        **trace)
    print(f"[healing] 6a overlap_shuffle={chunks}: caps {s.caps} = "
          f"⌈{serial_caps} / {chunks}⌉, scatter_pack launched "
          f"{launches['scatter_pack']} times, rows == phase 3's (multiset), "
          f"zero overflow; warm median {t_chunked * 1e3:.1f} ms against the "
          f"serial {cell['t_warm'] * 1e3:.1f} ms of phase 3")
    del s, ex
    torch.cuda.empty_cache()

    # 6b. Overflow: caps squeezed to an eighth heal by bounded retry.
    ex = ShardedJoinExecutor(plan, n_dev, ExecutorConfig(
        out_capacity=cell["cap_out"]), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clean = ex.session().prepare(data)
    for _ in range(2):                 # the eager warm-up, the capture
        clean.run_batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = clean.run_batch()
    torch.cuda.synchronize()
    t_clean = time.perf_counter() - t0
    del r, clean

    def squeezed(**kw):
        chaos = ChaosInjector(n_dev, seed=0)
        chaos.squeeze_caps(HEALING["squeeze"])
        return SelfHealingSession(ex, chaos=chaos, **kw).prepare(data)

    eng = squeezed()
    caps = dict(eng.session.caps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run_batch()
    torch.cuda.synchronize()
    t_healed = time.perf_counter() - t0
    st = eng.stats
    check(st["retries"] >= 1 and int(st["shuffle_overflow"].sum()) > 0,
          f"6b: squeezed caps {caps} did not overflow (stats {st})")
    same_rows(res, cell, "6b")
    del res
    compiles = ex.compile_count
    again = squeezed()
    res = again.run_batch()
    check(ex.compile_count == compiles, "6b: a second session walking the "
          "same ladder built a step")
    check(again.stats["retries"] == st["retries"]
          and int(res.tensors[1].sum()) == cell["exact"],
          "6b: the second session's ladder or rows differ")
    del res, again
    try:
        squeezed(retry=RetryPolicy(max_retries=0)).run_batch()
        fail("6b: max_retries=0 did not raise RetryBudgetExceededError")
    except RetryBudgetExceededError as err:
        check("retry budget exhausted" in str(err) and "dev " in str(err),
              f"6b: the budget error names no device: {err}")
    peak = torch.cuda.max_memory_allocated()
    pins = graph_memory(ex, "healing 6b")
    out["overflow"] = dict(squeeze=HEALING["squeeze"], caps=caps,
                           healed_caps=dict(eng.session.caps),
                           retries=st["retries"],
                           escalations=st["escalations"],
                           dropped_copies=int(st["shuffle_overflow"].sum()),
                           healed_ms=t_healed * 1e3, clean_ms=t_clean * 1e3,
                           builds=ex.compile_count, peak_gb=peak / 1e9,
                           **pins)
    print(f"[healing] 6b caps squeezed x{HEALING['squeeze']} {caps} -> "
          f"{dict(eng.session.caps)}: {st['retries']} retries, "
          f"{st['escalations']} escalations, "
          f"{int(st['shuffle_overflow'].sum())} copies dropped by the failed "
          f"attempts, rows == phase 3's; time to recover (the healed batch) "
          f"{t_healed * 1e3:.1f} ms against a clean warm batch's "
          f"{t_clean * 1e3:.1f} ms; a second session walked the ladder with "
          f"no step built; max_retries=0 raised RetryBudgetExceededError; "
          f"{ex.compile_count} steps built, peak allocated over 6b "
          f"{peak / 1e9:.2f} GB")
    del eng
    torch.cuda.empty_cache()

    # 6c. Device loss: device 3's heartbeats stop.
    dead = HEALING["dead"]
    chaos = ChaosInjector(n_dev, seed=0)
    chaos.drop_heartbeats(dead)
    eng = SelfHealingSession(ex, chaos=chaos, heartbeat_timeout_s=2.5,
                             suspect_timeout_s=1.5,
                             step_seconds=1.0).prepare(data)
    while eng.evicted == [] and eng.session.stats["batches"] < 16:
        res = eng.run_batch()
        check(int(res.tensors[1].sum()) == cell["exact"],
              "6c: a batch before the eviction is not exact")
        del res
    check(eng.evicted == [dead] and eng.refolds == 1,
          f"6c: evicted {eng.evicted}, refolds {eng.refolds}")
    batches = eng.session.stats["batches"]
    compiles = ex.compile_count
    res = eng.run_batch()
    check(ex.compile_count == compiles + eng.refold_compiles,
          "6c: the degraded batch built a step the re-fold did not count")
    recv = res["recv_counts"]
    live = np.delete(recv, dead)
    check(recv[dead] == 0 and (live > 0).all(),
          f"6c: recv_counts {recv.tolist()}")
    same_rows(res, cell, "6c")
    del res
    t_degraded, _ = warm_batches(
        ex, eng.session, "healing 6c", cell["exact"],
        expected_launches(ex, ARMS[FUSED_HASH], prepare=False), None)
    out["device_loss"] = dict(
        evicted=list(eng.evicted), batches_to_evict=batches,
        refolds=eng.refolds, refold_compiles=eng.refold_compiles,
        median_ms=t_degraded * 1e3, recv_counts=recv.tolist(),
        survivors_max_over_mean=float(live.max() / live.mean()))
    print(f"[healing] 6c device {dead} evicted after {batches} batches, "
          f"{eng.refolds} re-fold, refold_compiles {eng.refold_compiles}; "
          f"degraded batch rows == phase 3's, recv_counts {recv.tolist()} "
          f"(survivors max / mean {live.max() / live.mean():.3f}); degraded "
          f"warm median {t_degraded * 1e3:.1f} ms on 7 survivors")
    del eng
    torch.cuda.empty_cache()

    # 6d. A straggler: device 5 reports 30 s more a step.
    slow = HEALING["slow"]
    chaos = ChaosInjector(n_dev, seed=0)
    chaos.delay_device(slow, 30.0)
    eng = SelfHealingSession(ex, chaos=chaos, evict_after=2).prepare(data)
    while eng.evicted == [] and eng.session.stats["batches"] < 8:
        eng.run_batch()
    check(eng.evicted == [slow], f"6d: evicted {eng.evicted}")
    res = eng.run_batch()
    check(res["recv_counts"][slow] == 0,
          f"6d: recv_counts {res['recv_counts'].tolist()}")
    same_rows(res, cell, "6d")
    out["straggler"] = dict(evicted=list(eng.evicted),
                            batches_to_evict=eng.session.stats["batches"] - 1,
                            recv_counts=res["recv_counts"].tolist())
    print(f"[healing] 6d device {slow} evicted as a straggler after "
          f"{out['straggler']['batches_to_evict']} batches; rows == phase "
          f"3's, it received nothing")
    del res, eng, ex
    torch.cuda.empty_cache()
    return out


def hot_sets(plan, n_hot: int) -> tuple[list[int], list[int]]:
    """Two hot sets of tail values (value - 2, as `drifting_join_batch`
    takes them) grouped by the cell slice R's copies route to: hot_a from
    the first half of the slices, hot_b from the second, a few values a
    slice, so moving values from one set to the other provably moves cell
    load (hash collisions could otherwise cancel the drift)."""
    from collections import defaultdict
    vals = np.arange(2, FULL["tail_domain"] + 2, dtype=np.int64)
    ridx, dest = plan.route_relation(
        "R", np.stack([np.zeros_like(vals), vals], axis=1))
    per_val = defaultdict(set)
    for r, d in zip(ridx.tolist(), dest.tolist()):
        per_val[r].add(d)
    by_slice = defaultdict(list)
    for r, ds in sorted(per_val.items()):
        by_slice[tuple(sorted(ds))].append(int(vals[r]) - 2)
    slices = [vs for _, vs in sorted(by_slice.items())]
    half = len(slices) // 2
    take = -(-n_hot // half)
    hot_a = [v for vs in slices[:half] for v in vs[:take]][:n_hot]
    hot_b = [v for vs in slices[half:] for v in vs[:take]][:n_hot]
    check(len(hot_a) == len(hot_b) == n_hot,
          f"6e: {len(slices)} cell slices hold no {n_hot} hot values a half")
    return hot_a, hot_b


def exact_batch(res, data, label: str) -> int:
    """The batch's exact join size and no delivered overflow."""
    check(int(res["shuffle_overflow"].sum()) == 0
          and int(res["join_overflow"].sum()) == 0,
          f"{label}: delivered overflow")
    want = join_size(data)
    n_valid = int(res.tensors[1].sum())
    check(n_valid == want, f"{label}: valid rows {n_valid} != exact {want}")
    return want


def same_as_plain(rows, valid, plain, data, label: str) -> None:
    """`rows[valid]` equal, as a multiset, the rows of `data` run through
    `plain`: a session, on an executor of its own, that never adapts."""
    from repro_torch.core.executor import RetryPolicy
    ref = plain.run_with_retry(data, RetryPolicy(
        max_retries=SERVE["max_retries"]))
    check(torch.equal(packed_rows(rows, valid),
                      packed_rows(ref.tensors[0], ref.tensors[1])),
          f"{label}: rows differ, as a multiset, from those of a session "
          f"that never adapts")


def timed(obj, name: str, sink: dict) -> None:
    """Wrap `obj.name` so each call's host wall time lands in
    sink[name]."""
    fn = getattr(obj, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sink.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    setattr(obj, name, wrapper)


def synced_ms(fn) -> tuple[object, float]:
    """fn()'s result and host wall time (ms) up to a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def adaptation(dev, cell):
    """Phase 6e: drift adaptation on the full-size cell (fused + hash,
    phase 3's plan and out_capacity): forced actions, organic mild drift,
    a new heavy hitter."""
    from repro_torch.core import AdaptPolicy, tv_distance, two_way
    from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
    from repro_torch.data import drifting_join_batch
    from repro_torch.serve import SelfHealingSession

    q, plan, data = two_way(), cell["plan"], cell["data"]
    n_dev, m = FULL["n_dev"], ADAPT["sketch_counters"]
    policy = AdaptPolicy(**ADAPT_POLICY)
    ex, plain_ex = (ShardedJoinExecutor(plan, n_dev, ExecutorConfig(
        out_capacity=cell["cap_out"]), device=dev) for _ in range(2))
    out = {"sketch_counters": m, "policy": ADAPT_POLICY}

    # Forced actions on phase 3's data: a warm batch, force_replace, a
    # batch, force_replan, a batch; each batch's rows are phase 3's.
    eng = SelfHealingSession(ex, adapt=policy).prepare(data)
    same_rows(eng.run_batch(), cell, "6e warm")
    compiles = ex.compile_count
    eng.force_replace()
    same_rows(eng.run_batch(), cell, "6e after force_replace")
    hhs = eng.detector.sketched_hhs().values("B")
    check(0 in hhs, f"6e: the sketches (m = {m}) lost B = 0: {hhs}")
    _, t_warm_replan = synced_ms(eng.force_replan)
    same_rows(eng.run_batch(), cell, "6e after force_replan")
    st = eng.stats
    check(ex.compile_count == compiles and eng.executor is ex,
          "6e: a forced action built a step or missed the plan cache")
    check(st["replacements"] == 1 and st["replans"] == 1
          and st["replace_compiles"] == 0 and st["replan_compiles"] == 0
          and st["batches"] == 3, f"6e: forced-action counters {st}")
    _, t_clean = synced_ms(eng.session.run_batch)
    out["forced"] = dict(replan_ms=t_warm_replan, clean_batch_ms=t_clean,
                         sketched_hhs=list(hhs),
                         history=eng.detector.history)
    print(f"[adapt] 6e forced: warm batch, force_replace, force_replan "
          f"(sketched HHs {hhs} at m = {m}), rows == phase 3's each batch, "
          f"no step built, plan cache hit; warm re-plan {t_warm_replan:.1f}"
          f" ms beside a clean warm batch's {t_clean:.1f} ms")
    del eng
    torch.cuda.empty_cache()

    # Organic mild drift: prepared on hot_a, hot values moved in part.
    hot_a, hot_b = hot_sets(plan, ADAPT["n_hot"])
    mild = hot_a[:-ADAPT["moved"]] + hot_b[:ADAPT["moved"]]

    def batch(hot, seed, **kw):
        return drifting_join_batch(q, FULL["n"], FULL["hh_rows"],
                                   FULL["tail_domain"], hot, ADAPT["bonus"],
                                   seed=seed, **kw)

    start = batch(hot_a, 1)
    tv_batch = tv_distance(plan.cell_loads(batch(mild, 0)),
                           plan.cell_loads(start))
    check(ADAPT_POLICY["replace_threshold"] < tv_batch / 3
          and tv_batch < ADAPT_POLICY["replan_threshold"],
          f"6e: a mild batch's TV {tv_batch:.4f} leaves the policy's band")
    eng = SelfHealingSession(ex, adapt=policy).prepare(start)
    plain = plain_ex.session().prepare(start)
    table0 = eng.session.placement.table.copy()
    costs: dict = {}
    timed(eng.session, "count_batch", costs)
    timed(eng.detector, "observe_values", costs)
    timed(eng.detector, "assess", costs)
    schedule = ([(hot_a, 2 + i) for i in range(ADAPT["warm_batches"])]
                + [(mild, 10 + i) for i in range(ADAPT["mild_batches"])])
    warm_compiles = None
    for i, (hot, seed) in enumerate(schedule):
        b = batch(hot, seed)
        res = eng.run_batch(b)
        exact_batch(res, b, f"6e mild batch {i}")
        same_as_plain(res.tensors[0], res.tensors[1], plain, b,
                      f"6e mild batch {i}")
        del res
        if i == ADAPT["warm_batches"] - 1:
            warm_compiles = ex.compile_count
    st = eng.stats
    check(st["replacements"] >= 1 and st["replans"] == 0
          and st["replace_compiles"] == 0
          and ex.compile_count == warm_compiles,
          f"6e: mild drift counters {st} (history {eng.detector.history})")
    check(not np.array_equal(eng.session.placement.table, table0),
          "6e: the re-placement left the placement table as it was")
    observe = {k: float(np.median(v)) * 1e3 for k, v in costs.items()}
    out["mild"] = dict(n_hot=ADAPT["n_hot"], bonus=ADAPT["bonus"],
                       moved=ADAPT["moved"], batches=len(schedule),
                       tv_batch=tv_batch, replacements=st["replacements"],
                       history=eng.detector.history,
                       observe_ms_median=observe,
                       observe_ms={k: [t * 1e3 for t in v]
                                   for k, v in costs.items()})
    print(f"[adapt] 6e mild drift ({ADAPT['moved']} of {ADAPT['n_hot']} hot "
          f"values of +{ADAPT['bonus']} rows moved; a batch's TV "
          f"{tv_batch:.4f}): {st['replacements']} re-placements, 0 re-plans,"
          f" no step built, the table changed; every batch exact, its rows "
          f"those of a session that never adapts (multiset); history "
          f"(batch, action, TV) {eng.detector.history}")
    print(f"[adapt] 6e observation a batch (host, median of "
          f"{len(costs['assess'])}): count_batch "
          f"{observe['count_batch']:.1f} ms, observe_values "
          f"{observe['observe_values']:.1f} ms, assess "
          f"{observe['assess']:.3f} ms")
    del eng, plain
    torch.cuda.empty_cache()

    # A new heavy hitter: value 1 with extra_hh rows in R, on a fresh
    # session prepared on phase 3's data (empty sketches).
    def promoted(seed):
        b = batch(hot_a, seed)
        b["R"] = batch(hot_a, seed, extra_hh={"B": ADAPT["extra_hh"]})["R"]
        return b

    eng = SelfHealingSession(ex, adapt=policy).prepare(data)
    plain = plain_ex.session().prepare(data)
    cold: dict = {}
    replan = eng.force_replan

    def force_replan():
        """The re-plan's wall; then each run of the new session's batches
        (its first is the cold one), apart from their observation."""
        t0 = time.perf_counter()
        replan()
        cold.setdefault("force_replan", []).append(time.perf_counter() - t0)
        timed(eng.session, "run_with_retry", cold)

    eng.force_replan = force_replan
    for i in range(ADAPT["hh_batches"]):
        b = promoted(20 + i)
        res = eng.run_batch(b)
        exact_batch(res, b, f"6e new-HH batch {i}")
        same_as_plain(res.tensors[0], res.tensors[1], plain, b,
                      f"6e new-HH batch {i}")
        del res
    st = eng.stats
    new_hhs = eng.executor.plan.hhs.values("B")
    check(st["replans"] >= 1 and eng.executor is not ex and 1 in new_hhs
          and st["replan_compiles"] >= 1 and "run_with_retry" in cold,
          f"6e: new HH counters {st}, plan HHs {new_hhs}")
    runs = [t * 1e3 for t in cold["run_with_retry"]]
    t_replan = cold["force_replan"][0] * 1e3
    _, t_clean_new = synced_ms(eng.session.run_batch)
    out["new_hh"] = dict(extra_hh=ADAPT["extra_hh"], replans=st["replans"],
                         replan_compiles=st["replan_compiles"],
                         retries=st["retries"], plan_hhs=list(new_hhs),
                         replan_ms=t_replan, runs_after_ms=runs,
                         clean_batch_ms=t_clean_new,
                         history=eng.detector.history)
    print(f"[adapt] 6e new HH (value 1, +{ADAPT['extra_hh']} rows in R): "
          f"{st['replans']} re-plan(s), replan_compiles "
          f"{st['replan_compiles']}, {st['retries']} retries, plan HHs "
          f"{new_hhs}; cold re-plan {t_replan:.1f} ms, then the new plan's "
          f"batches ran in {', '.join(f'{t:.1f}' for t in runs)} ms (the "
          f"first cold; observation apart) beside a clean warm batch's "
          f"{t_clean_new:.1f} ms; every batch exact, its rows those of a "
          f"session that never adapts (multiset); history "
          f"{eng.detector.history}")
    del eng, ex, plain, plain_ex
    torch.cuda.empty_cache()
    return out


def multi_tenant(dev, cell):
    """Phase 8: multi-tenant join serving on the card — mixed_workload's
    tenants and the full-size cell — then per-tenant adaptation."""
    from repro_torch.core import (AdaptPolicy, canonical, reference_join,
                                  two_way)
    from repro_torch.core.executor import (ExecutorConfig, RetryPolicy,
                                           ShardedJoinExecutor)
    from repro_torch.data import (drifting_join_batch, mixed_workload,
                                  skewed_join_dataset)
    from repro_torch.serve import JoinServingEngine

    q, data = two_way(), cell["data"]
    retry = RetryPolicy(max_retries=SERVE["max_retries"])
    out = {}

    peaks = []

    def serve(eng, subs):
        """Submit, drain, time (and the device memory peak of the drain);
        per request the exactness check."""
        reqs = [(eng.submit(t, qq, d), qq, d) for t, qq, d in subs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.run()
        wall = time.perf_counter() - t0
        peaks.append(torch.cuda.max_memory_allocated())
        for req, qq, d in reqs:
            if req.tenant == "full":
                check(len(req.rows) == cell["exact"],
                      f"8: full request rows {len(req.rows)}")
                rows = torch.from_numpy(req.rows).to(dev)
                check(torch.equal(packed_rows(rows, torch.ones(
                    len(rows), dtype=torch.bool, device=dev)),
                    cell["sorted"]),
                    "8: full request rows differ from phase 3's")
                del rows
            else:
                check(np.array_equal(canonical(req.rows),
                                     canonical(reference_join(qq, d))),
                      f"8: {req.tenant} request {req.rid} not exact")
        return [r for r, _, _ in reqs], wall

    def sums_match(eng, label):
        st = eng.stats
        ts = st["tenants"].values()
        check(sum(t["requests"] for t in ts) == st["requests"]
              and sum(t["compiles"] for t in ts) == st["compiles"]
              and sum(t["prepares"] for t in ts) == st["cache"]["misses"],
              f"{label}: per-tenant stats do not sum to the engine's {st}")

    # 8a. Steady serving.  mixed_workload's tenants on an engine at the
    # reference's k = n_devices; the full-size tenant on one at the cell's
    # k.  (At k = 256 a small tenant's plan, derived from one request,
    # prunes type combinations that later requests fill: each such request
    # re-plans, a new executor and its steps; checked after the steady
    # phase.)
    small = JoinServingEngine(FULL["n_dev"], retry=retry, device=dev)
    full = JoinServingEngine(FULL["n_dev"], k=FULL["k"], retry=retry,
                             device=dev)
    (first,), t_first = serve(full, [("full", q, data)])
    ladder = int(np.log2(cell["cap_out"] // full.config.out_capacity))
    fst = full.tenants["full"].stats
    check(fst["escalations"] == fst["retries"] == ladder,
          f"8a: the cold ladder took {fst['retries']} retries, "
          f"{fst['escalations']} escalations (want {ladder})")
    for n_warm, seed in SERVE["warm"]:
        serve(small, mixed_workload(n_warm, seed=seed))
    c0 = dict(fst)
    warm_full, _ = serve(full, [("full", q, data)] * (SERVE["full_warm"] - 1))
    check(fst["retries"] == c0["retries"] and fst["compiles"] == c0["compiles"],
          "8a: the second full request retried or built a step")
    before = {name: (e.cache.compile_count(), e.cache.hits, e.cache.misses)
              for name, e in (("small", small), ("full", full))}
    windows, lat = [], []
    for w in range(SERVE["windows"]):
        reqs, wall = serve(small, mixed_workload(SERVE["steady"], seed=2 + w))
        ms = np.array([r.latency_s for r in reqs]) * 1e3
        lat.append(ms)
        windows.append(dict(requests=len(reqs), wall_s=wall,
                            requests_per_s=len(reqs) / wall,
                            p50_ms=float(np.percentile(ms, 50)),
                            p99_ms=float(np.percentile(ms, 99))))
        del reqs
    full_reqs, wall_full = serve(full, [("full", q, data)]
                                 * SERVE["full_steady"])
    n_steady = SERVE["steady"] * SERVE["windows"]
    for name, eng, n in (("small", small, n_steady),
                         ("full", full, SERVE["full_steady"])):
        c, h, mi = before[name]
        check(eng.cache.compile_count() == c and eng.cache.hits - h == n
              and eng.cache.misses == mi,
              f"8a: {name} engine's steady phase built "
              f"{eng.cache.compile_count() - c} steps, hits "
              f"{eng.cache.hits - h} of {n}")
        sums_match(eng, f"8a {name}")
    lat = np.concatenate(lat)
    wall = sum(w["wall_s"] for w in windows)
    rates = [w["requests_per_s"] for w in windows]
    peak = max(peaks)
    # What the engines' captured steps hold once every request is drained.
    graphs = {name: sum(e.captures for e in eng.cache._executors.values())
              for name, eng in (("small", small), ("full", full))}
    torch.cuda.empty_cache()
    held = dict(graphs=graphs,
                allocated_gb=torch.cuda.memory_allocated() / 1e9,
                reserved_gb=torch.cuda.memory_reserved() / 1e9)
    out["steady"] = dict(
        requests=n_steady, wall_s=wall, requests_per_s=n_steady / wall,
        p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)), windows=windows,
        requests_per_s_spread=(max(rates) - min(rates)) / min(rates),
        full_first_result_s=t_first, full_ladder=ladder,
        full_warm_ms=[r.latency_s * 1e3 for r in full_reqs],
        full_run_ms=[(r.latency_s - r.copy_s) * 1e3 for r in full_reqs],
        full_copy_ms=[r.copy_s * 1e3 for r in full_reqs],
        small_cache=small.cache.stats, full_cache=full.cache.stats,
        tenants={**small.stats["tenants"], **full.stats["tenants"]},
        peak_gb=peak / 1e9, held=held)
    print(f"[serve] 8a steady: {n_steady} mixed requests in "
          f"{SERVE['windows']} windows of {SERVE['steady']}, "
          f"{wall * 1e3:.1f} ms = {n_steady / wall:.1f} requests/s, p50 "
          f"{out['steady']['p50_ms']:.2f} ms, p99 "
          f"{out['steady']['p99_ms']:.2f} ms over every request; a window: "
          + "; ".join(f"{w['requests_per_s']:.1f} requests/s, p50 "
                      f"{w['p50_ms']:.2f}, p99 {w['p99_ms']:.2f} ms"
                      for w in windows)
          + f" (requests/s spread "
          f"{out['steady']['requests_per_s_spread'] * 100:.1f} %); 0 steps "
          f"built, hit rate 1.0 on both engines; every request exact")
    print(f"[serve] 8a full tenant: first exact result {t_first:.2f} s "
          f"(plan, prepare, cap_out {full.config.out_capacity} -> "
          f"{cell['cap_out']} in {ladder} escalations); warm "
          f"{', '.join(f'{x:.1f}' for x in out['steady']['full_warm_ms'])} "
          f"ms = run {', '.join(f'{x:.1f}' for x in out['steady']['full_run_ms'])}"
          f" + rows to the host "
          f"{', '.join(f'{x:.1f}' for x in out['steady']['full_copy_ms'])}"
          f" ms; rows == phase 3's; peak while serving {peak / 1e9:.2f} "
          f"GB (the checks' copies apart); graphs held {graphs}, allocated "
          f"{held['allocated_gb']:.2f} GB, reserved {held['reserved_gb']:.2f} "
          f"GB after the drains")
    del small, full, first, warm_full, full_reqs
    torch.cuda.empty_cache()

    # The small tenants at the cell's k: requests that fill a combination
    # their tenant's plan pruned re-plan it, and stay exact.  (chain4 is
    # left out: at k = 256 its planner sizes 65^3 type combinations, many
    # seconds of host time a plan.)
    wide = JoinServingEngine(FULL["n_dev"], k=FULL["k"], retry=retry,
                             device=dev)
    reqs, wall = serve(wide, [s for s in mixed_workload(
        SERVE["warm"][0][0], seed=0) if s[0] != "chain4"])
    replans = {t: ts["replans"] for t, ts in wide.stats["tenants"].items()}
    check(sum(replans.values()) >= 1,
          f"8a at k = {FULL['k']}: no request re-planned its tenant")
    sums_match(wide, "8a at the cell's k")
    out["cell_k"] = dict(requests=len(reqs), wall_s=wall, replans=replans,
                         compiles=wide.stats["compiles"])
    print(f"[serve] 8a the small tenants at k = {FULL['k']}: {len(reqs)} "
          f"requests, each exact, re-plans {replans} (each a request with "
          f"rows in a combination its tenant's plan pruned), "
          f"{wide.stats['compiles']} steps built, {wall:.2f} s")
    del wide, reqs
    torch.cuda.empty_cache()

    # 8b. Per-tenant adaptation: tenant full's hot set moves, tenant calm
    # sends one request.
    eng = JoinServingEngine(FULL["n_dev"], k=FULL["k"], retry=retry,
                            adapt=AdaptPolicy(**HAIR_TRIGGER), device=dev)
    hot_a, hot_b = hot_sets(cell["plan"], ADAPT["n_hot"])
    drift = [drifting_join_batch(q, FULL["n"], FULL["hh_rows"],
                                 FULL["tail_domain"], hot, ADAPT["bonus"],
                                 seed=30 + i)
             for i, hot in enumerate([hot_a, hot_a, hot_b, hot_b]
                                     [:SERVE["drift_batches"]])]
    calm = skewed_join_dataset(q, 300, 600, seed=50)
    reqs = [eng.submit("full", q, d) for d in drift]
    calm_req = eng.submit("calm", q, calm)
    eng.run()
    plain = ShardedJoinExecutor(cell["plan"], FULL["n_dev"], ExecutorConfig(
        out_capacity=cell["cap_out"]), device=dev).session().prepare(drift[0])
    for req, d in zip(reqs, drift):
        check(len(req.rows) == join_size(d), f"8b: full request {req.rid} "
              f"has {len(req.rows)} rows, not {join_size(d)}")
        rows = torch.from_numpy(req.rows).to(dev)
        same_as_plain(rows, torch.ones(len(rows), dtype=torch.bool,
                                       device=dev), plain, d,
                      f"8b: full request {req.rid}")
        del rows
    del plain
    check(np.array_equal(canonical(calm_req.rows),
                         canonical(reference_join(q, calm))),
          "8b: the calm request is not exact")
    det_f, det_c = eng.adapt.get("full"), eng.adapt.get("calm")
    fst = eng.tenants["full"].stats
    check(fst["replacements"] >= 1 and det_f is not det_c
          and det_f.batches == len(drift) and det_c.batches == 1,
          f"8b: replacements {fst['replacements']}, detectors' batches "
          f"{det_f.batches} / {det_c.batches}")
    sums_match(eng, "8b")
    out["per_tenant"] = dict(replacements=fst["replacements"],
                             compiles=fst["compiles"],
                             retries=fst["retries"],
                             history=det_f.history,
                             calm_batches=det_c.batches)
    print(f"[serve] 8b per-tenant adaptation: full {fst['replacements']} "
          f"re-placements over {len(drift)} drifting batches, its compiles "
          f"{fst['compiles']} (the cap_out ladder and any after a "
          f"re-placement), history {det_f.history}; calm's detector saw "
          f"{det_c.batches} batch; every request exact, full's rows those of "
          f"a session that never adapts (multiset)")
    del eng, reqs
    torch.cuda.empty_cache()
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
            runs = [(arm, fields, 0) for arm, fields in ARMS.items()]
            runs += [(arm, ARMS[arm], MODERATE_CHUNKS)
                     for arm in (FUSED_HASH, STAGED_SORT)]
            for arm, fields, chunks in runs:
                cfg = ExecutorConfig(out_capacity=quantize_capacity(biggest),
                                     overlap_shuffle=chunks, **fields)
                ex = ShardedJoinExecutor(plan, 8, cfg, device=dev)
                if chunks:
                    arm = f"{arm} overlap_shuffle={chunks}"
                # Counts zeroed just before prepare + run_batch, read just
                # after.
                ops.reset_launches()
                res = ex.session().prepare(data).run_batch()
                launches = dict(ops.LAUNCHES)
                want = expected_launches(ex, fields, max(chunks, 1))
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


def serve_both(dev, cfg, model, slots: int, max_seq: int, requests,
               tag: str, who: str = "") -> tuple[dict, dict]:
    """The same requests through a `ServingEngine` on the eager decode step
    of the plain versions (`use_kernels=False`, the reference), then on the
    captured one, the ticks timed one by one: every request completes with
    its max_new_tokens, and each request's tokens are the same on both.
    The capturing tick's growth of allocated and reserved memory is what
    the graph pins.  Returns each mode's figures and its engine (for the
    caller's checks and profiles)."""
    from repro_torch.serve import ServingEngine, build_decode_step

    out, engines, tokens = {}, {}, {}
    for mode in ("eager", "graph"):
        model.use_kernels = mode == "graph"
        fns = build_decode_step(cfg, slots, max_seq, device=dev)
        eng = ServingEngine(cfg, slots, max_seq, model, fns, device=dev)
        reqs = [eng.submit(p, m) for p, m in requests]
        tick_s, pinned = [], (0, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while any(not r.done for r in reqs):      # ServingEngine.run, timed
            eng._admit()
            captures = fns.captures
            if mode == "graph" and not captures:
                # The capture empties the allocator's cache on entry: empty
                # it first, so that the growth read is the graph's pool.
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            mem = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
            t = time.perf_counter()
            eng._tick()              # ends in the next tokens' copy to host
            tick_s.append(time.perf_counter() - t)
            if fns.captures > captures:
                pinned = (torch.cuda.memory_allocated() - mem[0],
                          torch.cuda.memory_reserved() - mem[1])
        t_run = time.perf_counter() - t0
        model.use_kernels = True
        check(all(len(r.out) == m for r, (_, m) in zip(reqs, requests)),
              f"{tag} {who}{mode}: a request did not complete with its "
              f"max_new_tokens")
        want = sum(m for _, m in requests)
        check(eng.tokens_out == want,
              f"{tag} {who}{mode}: tokens_out {eng.tokens_out} != {want}")
        tokens[mode] = [r.out for r in reqs]
        out[mode] = dict(
            ticks=eng.ticks, tick_median_ms=float(np.median(tick_s)) * 1e3,
            tick_p90_ms=float(np.percentile(tick_s, 90)) * 1e3,
            tick_max_ms=max(tick_s) * 1e3, run_s=t_run,
            decode_tokens_per_s=eng.tokens_out / t_run,
            eager_calls=fns.eager_calls, captures=fns.captures,
            replays=fns.replays, graph_allocated_bytes=pinned[0],
            graph_reserved_bytes=pinned[1])
        engines[mode] = eng
    check(tokens["graph"] == tokens["eager"],
          f"{tag} {who}: the graph engine's tokens differ from the eager engine's")
    g = out["graph"]
    check(g["captures"] == 1 and g["eager_calls"] == 1
          and g["replays"] == g["ticks"] - 1,
          f"{tag} {who}: graph engine eager / captures / replays "
          f"{g['eager_calls']} / {g['captures']} / {g['replays']} over "
          f"{g['ticks']} ticks, not 1 / 1 / ticks - 1")
    for mode, r in out.items():
        print(f"[{tag}] {who}serving {mode}: {len(requests)} requests on {slots} "
              f"slots, max_seq {max_seq}: {r['ticks']} ticks, median tick "
              f"{r['tick_median_ms']:.2f} ms (p90 {r['tick_p90_ms']:.2f}, "
              f"max {r['tick_max_ms']:.2f}); run {r['run_s']:.2f} s, "
              f"{r['decode_tokens_per_s']:.1f} decode tokens/s")
    print(f"[{tag}] {who}serving: every request's tokens on the graph equal "
          f"the eager plain engine's; the graph engine ran "
          f"{g['eager_calls']} tick eagerly, captured {g['captures']} graph, "
          f"replayed {g['replays']}; the capturing tick grew allocated "
          f"memory by {g['graph_allocated_bytes'] / 1e6:.2f} MB and reserved "
          f"by {g['graph_reserved_bytes'] / 1e6:.2f} MB; median tick "
          f"{out['eager']['tick_median_ms']:.2f} (eager, plain) -> "
          f"{g['tick_median_ms']:.2f} ms (graph)")
    return out, engines


def moe_serve(dev):
    """Phase 7a + 7b: the MoE serving path of the LM scaffold at full width
    (depth cut), through `api.forward`, `build_prefill` and the
    `ServingEngine` (on the plain versions' eager step and on the graph).
    Launch counts are zeroed just before 7a and read just after 7b:
    segment_histogram launches from the host on every model pass with
    kernels that runs eagerly or is captured (a replay launches nothing);
    the values each call gets are kept (one per size) for phase 7c."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.common import count_params
    from repro_torch.serve import build_prefill

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

    # Keep the first input of each size that the histogram is given (a
    # capture records no copy: its sizes were seen at the warm-up).
    captured = {}
    launch_hist = ops.segment_histogram

    def keep_input(values, n_bins, **kw):
        if values.numel() not in captured:
            captured[values.numel()] = values.detach().clone()
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
    # 7a. forward and prefill.
    lg, aux = api.forward(model, cfg, {"tokens": prompts}, last_only=True)
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
    print(f"[moe] 7a forward: expert_load {load.tolist()} sums to "
          f"{int(load.sum())} = B·S·K·L and equals the plain version's "
          f"(torch.equal); logits finite")
    fns = build_prefill(cfg, device=dev)
    prefill_s = []
    for _ in range(MOE["prefill_reps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = fns.prefill(model, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    check(last.shape == (B, cfg.padded_vocab())
          and bool(torch.isfinite(last).all()),
          f"prefill logits {tuple(last.shape)} not finite or misshaped")
    t_prefill = float(np.median(prefill_s))
    prefill = dict(ms=[t * 1e3 for t in prefill_s],
                   median_ms=t_prefill * 1e3)
    print(f"[moe] 7a prefill (build_prefill, eager) of {B} x {S} tokens: "
          f"median {t_prefill * 1e3:.1f} ms of {len(prefill_s)} "
          f"({', '.join(f'{t * 1e3:.1f}' for t in prefill_s)}), "
          f"{B * S / t_prefill:.0f} prompt tokens/s; logits finite")

    # 7b. serving, on an eager step and on the graph.
    serving, engines = serve_both(dev, cfg, model, MOE["slots"],
                                  MOE["max_seq"], requests, "moe", "7b ")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    ops.segment_histogram = launch_hist
    peak = torch.cuda.max_memory_allocated()

    # Host passes through the model's kernels: the forward, each prefill,
    # the graph engine's eager tick and its capture (a replay makes none;
    # the plain forward and the eager engine run the plain versions).
    g = serving["graph"]
    passes = {"forward": 1, "prefill": len(prefill["ms"]),
              "serving graph": g["eager_calls"] + g["captures"]}
    model_calls = sum(passes.values())
    want = dict.fromkeys(KERNEL_SITES, 0)
    want["segment_histogram"] = model_calls * L
    check(launches == want, f"moe_serve launches {launches}, expected {want}")
    check(16 in captured and B * S * K in captured,
          f"histogram inputs of sizes {sorted(captured)}")
    print(f"[moe] 7b: bound of a tick (reading every slot's expert weights "
          f"once, {expert_bytes / 1e9:.2f} GB / {HBM_BYTES_PER_S / 1e12:.2f} "
          f"TB/s) {expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms; tokens_out "
          f"{sum(m for _, m in requests)} a run (prompts "
          f"{int(lens.min())}-{int(lens.max())}, new tokens "
          f"{int(news.min())}-{int(news.max())})")
    print(f"[moe] segment_histogram launches {launches['segment_histogram']}"
          f" = ({model_calls} host passes: "
          f"{', '.join(f'{k} {v}' for k, v in passes.items())}) x {L} "
          f"layers; the plain forward, the eager plain engine and every "
          f"replay launched none from the host; peak allocated (measured) {peak / 1e9:.2f} GB")

    # Where a tick's time goes (not counted): the decode step alone, eager
    # on the plain versions and replayed.
    profiles = {}
    for mode, eng in engines.items():
        toks = torch.from_numpy(eng.next_tok[:, None].copy())
        pos = torch.from_numpy(np.minimum(eng.pos, MOE["max_seq"] - 1))
        profiles[mode] = {}
        model.use_kernels = mode == "graph"
        profile_calls(lambda: eng.fns.decode(model, eng.cache, toks, pos),
                      f"{MOE['profile_ticks']} decode steps {mode} "
                      f"(B={MOE['slots']})", MOE["profile_ticks"], tag="moe",
                      sink=profiles[mode])
        model.use_kernels = True
    del engines, eng, model, lg, last
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, captured=captured, n_bins=cfg.n_experts,
                summary=dict(prefill=prefill, serving=serving,
                             host_passes=passes, peak_gb=peak / 1e9,
                             tick_bound_ms=expert_bytes / HBM_BYTES_PER_S
                             * 1e3, decode_profile=profiles))


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
            # 100 calls a trace: the profiler has dropped every device
            # event of a trace of 10 calls of this 1.5 us kernel.
            calls = 100
            _, device = call_profile(
                lambda: sh.segment_histogram_cuda(vals, bins), calls)
            check(len(device) == 1 and max(device.values()) <= calls,
                  f"segment_histogram decode call: device operations "
                  f"{device} in {calls} calls, not one a call")
            print(f"[histogram] decode: one device operation a call "
                  f"({device} in {calls} calls)")

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


def moe_train(dev):
    """Phase 9a: train mixtral-8x22b at its published widths (depth cut)
    through `build_train_step`: 5 steps on one repeated batch.  Launch
    counts are zeroed just before the first step and read just after the
    fifth; a sixth step is profiled after them."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_histogram as sh
    from repro_torch.models import api
    from repro_torch.models.common import count_params
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import build_train_step

    full = ARCHS[TRAIN["arch"]]
    cfg = dataclasses.replace(full, n_layers=TRAIN["n_layers"])
    B, S, K, L = TRAIN["batch"], TRAIN["seq"], cfg.topk, cfg.n_layers
    n_steps = TRAIN["steps"]
    print(f"[train] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.n_experts} experts top-{K} on {cfg.n_slots()} slots, remat "
          f"{cfg.remat!r}, {TRAIN['state_bits']}-bit AdamW states; reduced: "
          f"n_layers {full.n_layers} -> {L}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = api.init_model(cfg, torch.Generator(device=dev).manual_seed(
        TRAIN["seed"]), device=dev)
    ocfg = AdamWConfig(lr=TRAIN["lr"], state_bits=TRAIN["state_bits"])
    opt = adamw.init(model.tree(), ocfg)
    fns = build_train_step(cfg, ocfg, total_steps=n_steps,
                           warmup_steps=TRAIN["warmup"], device=dev)
    torch.cuda.synchronize()
    n_params = count_params(api.layout(cfg))
    held = torch.cuda.memory_allocated() - base
    print(f"[train] {n_params} bf16 parameters + their int8 m and v: "
          f"{held / 1e9:.2f} GB allocated (measured) in "
          f"{time.perf_counter() - t0:.2f} s")

    batch = TokenPipeline(PipelineConfig(cfg.vocab, S, B, seed=TRAIN["seed"])
                          ).global_batch_at(0)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in batch.items()}
    # The first step's forward on the plain versions (not counted).
    with torch.no_grad():
        model.use_kernels = False
        _, aux = api.forward(model, cfg, {"tokens": batch["tokens"]},
                             last_only=True)
        model.use_kernels = True
    plain_load = aux["expert_load"].float().cpu()
    del aux

    captured = {}
    launch_hist = ops.segment_histogram

    def keep_input(values, n_bins, **kw):
        if values.numel() not in captured:      # the eager step's, not
            captured[values.numel()] = values.detach().clone()  # captured
        return launch_hist(values, n_bins, **kw)

    # The path: counts zeroed just before, read just after.
    ops.segment_histogram = keep_input
    torch.cuda.synchronize()
    ops.reset_launches()
    step_s, metrics = [], []
    with captures_watched() as watch:
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model, opt, m = fns.step(model, opt, batch)
            m = {k: v.detach().cpu() for k, v in m.items()}
            step_s.append(time.perf_counter() - t)
            metrics.append(m)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    ops.segment_histogram = launch_hist
    peak = torch.cuda.max_memory_allocated()
    c = fns.compiled
    passes = c.eager_calls + c.captures
    check((c.eager_calls, c.captures, c.replays) == (1, 1, n_steps - 1),
          f"9a: eager calls, captures, replays {c.eager_calls}, "
          f"{c.captures}, {c.replays}; expected 1, 1, {n_steps - 1}")

    losses = [float(m["loss"]) for m in metrics]
    check(all(np.isfinite(losses)), f"train losses {losses} not finite")
    check(losses[-1] < losses[0], f"train loss did not descend: {losses}")
    check(int(opt["step"]) == n_steps, f"opt step {int(opt['step'])} != "
          f"{n_steps}")
    for i, m in enumerate(metrics):
        check(int(m["expert_load"].sum()) == B * S * K * L,
              f"step {i}: expert_load sums to {int(m['expert_load'].sum())}"
              f", not B·S·K·L = {B * S * K * L}")
    check(torch.equal(metrics[0]["expert_load"], plain_load),
          f"first step's expert_load {metrics[0]['expert_load'].tolist()} "
          f"!= the plain forward's {plain_load.tolist()}")
    want = dict.fromkeys(KERNEL_SITES, 0)
    want["segment_histogram"] = 2 * L * passes
    check(launches == want, f"moe_train launches {launches}, expected {want}")
    vals = captured[B * S * K]
    check(torch.equal(sh.segment_histogram_cuda(vals, cfg.n_experts),
                      sh.segment_histogram_host(vals, cfg.n_experts)),
          "segment_histogram differs from plain on the train step's input")
    warm = float(np.median(step_s[2:]))
    series = {k: ", ".join(f"{float(m[k]):.4f}" for m in metrics)
              for k in ("loss", "grad_norm", "lr_scale")}
    print(f"[train] 9a losses {series['loss']}; zloss "
          f"{float(metrics[-1]['zloss']):.5f}; grad_norm "
          f"{series['grad_norm']}; lr_scale {series['lr_scale']}")
    print(f"[train] 9a expert_load every step sums to B·S·K·L = "
          f"{B * S * K * L}; step 1's {metrics[0]['expert_load'].tolist()} "
          f"equals the plain forward's (torch.equal); opt step {n_steps}; "
          f"segment_histogram launches {launches['segment_histogram']} = 2 "
          f"(forward + recompute) x {L} layers x {passes} host passes (the "
          f"eager step and the capture; {c.replays} replays launch it from "
          f"the graph), equal to plain on its {vals.numel()} values")
    print(f"[train] 9a steps {', '.join(f'{t * 1e3:.1f}' for t in step_s)} "
          f"ms: cold first (eager) {step_s[0] * 1e3:.1f} ms, capturing "
          f"{step_s[1] * 1e3:.1f} ms, warm median (replays, steps "
          f"3-{n_steps}) {warm * 1e3:.1f} ms, {B * S / warm:.0f} tokens/s; "
          f"peak allocated (measured) {peak / 1e9:.2f} GB")
    print(f"[train] 9a graph: {capture_line(watch.seen)}")
    # Where a warm step's time goes (a sixth step, not counted above).
    profile_calls(lambda: fns.step(model, opt, batch),
                  f"one warm train step ({B} x {S} tokens, {L} layers)", 1,
                  top=15, tag="train")
    out = dict(launches=launches, losses=losses, step_ms=[t * 1e3 for t in
                                                          step_s],
               warm_ms=warm * 1e3, tokens_per_s=B * S / warm,
               peak_gb=peak / 1e9, base_gb=base / 1e9, n_layers=L,
               graph=watch.seen)
    del model, opt, fns, c, batch, captured, vals, metrics
    torch.cuda.empty_cache()
    return out


def train_driver(dev):
    """Phase 9b: `python -m repro_torch.launch.train`'s main on qwen2-0.5b
    at its full size on the card, through a simulated node failure, then
    resumed, in a temporary directory."""
    import contextlib
    import io
    import tempfile
    from repro_torch.ckpt import Checkpointer
    from repro_torch.launch.train import main as train_main

    def run(argv):
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train_main(argv)
        wall = time.perf_counter() - t
        out = buf.getvalue()
        for line in out.splitlines():
            print(f"[driver] {line}")
        return out, wall

    def step_ms(out):
        return {int(line.split()[1]): float(line.split()[-1][:-2])
                for line in out.splitlines() if line.startswith("step ")}

    def losses(out):
        return [float(line.split("loss")[1].split()[0])
                for line in out.splitlines() if line.startswith("step ")]

    def save_s(out):
        return [float(line.split()[-2]) for line in out.splitlines()
                if line.startswith("[ckpt] final save")][0]

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        base = ["--arch", DRIVER["arch"], "--batch", str(DRIVER["batch"]),
                "--seq", str(DRIVER["seq"]), "--lr", str(DRIVER["lr"]),
                "--ckpt-every",
                str(DRIVER["ckpt_every"]), "--log-every", "1",
                "--ckpt-dir", d]
        with captures_watched() as watch:
            out1, wall1 = run(base + ["--steps", str(DRIVER["steps"]),
                                      "--fail-at-step",
                                      str(DRIVER["fail_at"])])
            out2, wall2 = run(base + ["--steps", str(DRIVER["resume_steps"]),
                                      "--resume"])
        latest = Checkpointer(d).latest_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    for line in (f"[FT] injecting node failure at step {DRIVER['fail_at']}",
                 "[FT] re-meshing {'data': 2, 'model': 4} -> {'data': 1, "
                 "'model': 4}, restoring step 4",
                 f"done; final checkpoint at {DRIVER['steps']}"):
        check(line in out1, f"9b: {line!r} not printed")
    check(f"resumed from step {DRIVER['steps']}" in out2,
          "9b: the resume line not printed")
    l1, l2 = losses(out1), losses(out2)
    check(all(np.isfinite(l1 + l2)) and l1[-1] < l1[0] and l2[-1] < l1[0],
          f"9b: the loss did not descend: {l1} then {l2}")
    check(latest == DRIVER["resume_steps"], f"9b: latest committed step "
          f"{latest}, not {DRIVER['resume_steps']}")
    check(len(watch.seen) == 3, f"9b: {len(watch.seen)} captures, not 3 "
          f"(a run's second step, and the second after the restore)")
    ms1 = step_ms(out1)
    # Eager first steps of a binding (0, and the failure's restored model)
    # and the captures after them are not warm.
    fail = DRIVER["fail_at"]
    warm = [v for k, v in ms1.items() if k not in (0, 1, fail, fail + 1)]
    warm_ms = float(np.median(warm))
    cap_ms = [ms1[1], ms1[fail + 1]]
    print(f"[driver] 9b qwen2-0.5b: loss {l1[0]:.4f} -> {l1[-1]:.4f} "
          f"(failure at step {DRIVER['fail_at']}), resumed {l2[0]:.4f} -> "
          f"{l2[-1]:.4f}; latest committed step {latest}; warm step median "
          f"{warm_ms:.0f} ms ({DRIVER['batch'] * DRIVER['seq'] / warm_ms * 1e3:.0f}"
          f" tokens/s); final checkpoint save (blocking) {save_s(out1):.2f} / "
          f"{save_s(out2):.2f} s; runs {wall1:.1f} s and {wall2:.1f} s; "
          f"peak allocated (measured, over the phase's start) "
          f"{peak / 1e9:.2f} GB")
    print(f"[driver] 9b graph: capturing steps 1 and {fail + 1} "
          f"{cap_ms[0]:.0f} / {cap_ms[1]:.0f} ms; {capture_line(watch.seen)}")
    torch.cuda.empty_cache()
    return dict(warm_ms=warm_ms, peak_gb=peak / 1e9,
                save_s=[save_s(out1), save_s(out2)],
                losses=l1 + l2, walls_s=[wall1, wall2], step_ms=ms1,
                capture_step_ms=cap_ms, graph=watch.seen)


def mesh_train_rank(rank: int, world: int, run: str, spec: dict,
                    out_dir: str) -> None:
    """One rank of phase 9m (a spawned process): `spec` (MESH_TRAIN's
    form), the one-process eager step first where `spec["one"]`, then the
    mesh step from the same seed-made parameters and batch; its metrics,
    launches and parameters held to the one-process run's, its memory
    beside the prediction.  Writes rank<r>.json."""
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import api
    from repro_torch.models.common import to_local
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import build_train_step
    from repro_torch.tree import flatten

    label = f"9m{run} {spec['backend']} rank {rank} of {world}"
    t0 = time.perf_counter()
    mesh = make_lm_mesh(spec["shape"], backend=spec["backend"],
                        device="cuda:0" if spec["backend"] == "gloo"
                        else None, init_method=f"file://{out_dir}/store",
                        rank=rank, world_size=world, timeout_s=300)
    t_mesh = time.perf_counter() - t0
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        cfg = get(spec["arch"])
        cfg = cfg.reduced() if spec["reduced"] else cfg
        dtype = getattr(torch, spec["dtype"])
        ocfg = AdamWConfig(lr=spec["lr"], state_bits=spec["bits"])
        kw = dict(total_steps=10, warmup_steps=1)
        rng = np.random.default_rng(0)
        batch = {k: rng.integers(0, cfg.vocab, (spec["batch"], spec["seq"])
                                 ).astype(np.int32)
                 for k in ("tokens", "labels")}

        def steps(fns, model, opt):
            out = []
            for _ in range(spec["steps"]):
                _, _, m = fns.step(model, opt, batch)
                out.append({k: v.detach().cpu() for k, v in m.items()})
            torch.cuda.synchronize()
            return out

        def held():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            return torch.cuda.memory_allocated()

        # The one-process eager step (the reference).
        want, one_s, one_peak = [], 0.0, 0
        if spec["one"]:
            base = held()
            one = build_train_step(cfg, ocfg, device=dev, **kw)
            model1 = api.init_model(
                cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                dtype=dtype)
            model1.use_kernels = False
            opt1 = adamw.init(model1.tree(), ocfg)
            t0 = time.perf_counter()
            want = steps(one, model1, opt1)
            one_s = time.perf_counter() - t0
            one_peak = torch.cuda.max_memory_allocated() - base
        # Params, grads and states of each leaf over the shards its
        # placements give: the prediction of the mesh's persistent bytes.
        fns = build_train_step(cfg, ocfg, mesh=mesh, **kw)
        flat_pl = flatten(fns.param_placements)
        flat_opt = flatten(adamw.init(fns.params_abstract, ocfg)["mu"])
        predicted = 0
        for key, p in flatten(fns.params_abstract).items():
            shards = int(np.prod([n for pl, n in zip(flat_pl[key], mesh.shape)
                                  if pl.is_shard()]))
            states = sum(t.numel() * t.element_size()
                         for k, t in flat_opt.items()
                         if k.rsplit("/", 1)[0] == key)
            predicted += (2 * p.numel() * dtype.itemsize + states) / shards

        # The mesh step: counts zeroed just before it, read just after.
        base = held()
        model = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev, dtype=dtype,
                               placements=fns.param_placements, mesh=mesh)
        opt = adamw.init(model.tree(), ocfg)
        resident = torch.cuda.memory_allocated() - base
        seen = []
        kernel = ops.segment_histogram

        def watched(values, n_bins, use_kernels=True):
            out = kernel(values, n_bins, use_kernels=use_kernels)
            if use_kernels and not seen:
                seen.append((values.clone(), out.clone()))
            return out

        ops.segment_histogram = watched
        ops.reset_launches()
        t0 = time.perf_counter()
        try:
            got = steps(fns, model, opt)
        finally:
            ops.segment_histogram = kernel
        mesh_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - base

        for i, (g, w) in enumerate(zip(got, want)):
            check(set(g) == set(w), f"{label}: metrics {sorted(g)}")
            for k in ("loss", "zloss", "grad_norm", "lr_scale"):
                if spec["exact"]:
                    check(torch.equal(g[k], w[k]), f"{label}: step {i} {k} "
                          f"{float(g[k])!r} != one process {float(w[k])!r}")
                else:
                    check(abs(float(g[k]) - float(w[k]))
                          <= MESH_TRAIN_RTOL * abs(float(w[k])) + 1e-7,
                          f"{label}: step {i} {k} {float(g[k])!r} vs one "
                          f"process {float(w[k])!r}")
            if "expert_load" in w:
                check(torch.equal(g["expert_load"], w["expert_load"])
                      and int(g["expert_load"].sum()) == spec["batch"]
                      * spec["seq"] * cfg.topk * cfg.n_layers,
                      f"{label}: step {i} expert_load {g['expert_load']} vs "
                      f"{w['expert_load']}")
        check(all(np.isfinite(float(m["loss"])) for m in got),
              f"{label}: a loss is not finite")
        if spec["exact"] and spec["one"]:
            for key, t in flatten(model.tree()).items():
                check(torch.equal(to_local(t), flatten(model1.tree())[key]),
                      f"{label}: parameter {key} differs from the "
                      f"one-process step's")
        if cfg.family == "moe":
            want_n = spec["steps"] * cfg.n_layers * (
                2 if cfg.remat == "full" else 1)
            check(launches["segment_histogram"] == want_n and seen,
                  f"{label}: segment_histogram launched "
                  f"{launches['segment_histogram']} times, not {want_n}")
            values, out = seen[0]
            check(values.numel() == spec["batch"] // mesh.shape[0]
                  * spec["seq"] * cfg.topk,
                  f"{label}: the kernel saw {values.numel()} routed copies, "
                  f"not this rank's rows'")
            check(torch.equal(out, ops.segment_histogram(
                values, cfg.n_experts, use_kernels=False)),
                  f"{label}: segment_histogram differs from its plain "
                  f"version on the rank's rows")
        result = dict(
            rank=rank, world=world, backend=dist.get_backend(),
            device=str(dev), mesh_s=t_mesh,
            coordinate=list(mesh.get_coordinate()),
            losses=[float(m["loss"]) for m in got],
            one_losses=[float(m["loss"]) for m in want],
            grad_norms=[float(m["grad_norm"]) for m in got],
            one_grad_norms=[float(m["grad_norm"]) for m in want],
            launches=launches["segment_histogram"], mesh_step_s=mesh_s,
            one_step_s=one_s, resident_gb=resident / 1e9,
            predicted_gb=predicted / 1e9, peak_gb=peak / 1e9,
            one_peak_gb=one_peak / 1e9)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def mesh_training(card: str, runs: dict = MESH_TRAIN) -> dict:
    """Phase 9m: the LM train step over a (data, model) mesh of ranks, each
    run of `runs` (MESH_TRAIN: "a", one NCCL rank, and "b", one gloo rank
    on the card) spawned and joined with a deadline, every rank checked
    against the one-process step (`mesh_train_rank`).  An NCCL rank r runs
    on card r."""
    import tempfile

    import torch.multiprocessing as mp

    torch.cuda.synchronize()
    print(f"[mesh-train] {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated before the ranks start")
    out = {"launches": []}
    for run, spec in runs.items():
        world = int(np.prod(spec["shape"]))
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ctx = mp.start_processes(mesh_train_rank,
                                     args=(world, run, spec, tmp),
                                     nprocs=world, join=False,
                                     start_method="spawn")
            deadline = time.monotonic() + MESH_TRAIN_DEADLINE_S
            try:
                while not ctx.join(timeout=5):
                    check(time.monotonic() < deadline, f"9m{run}: ranks "
                          f"still running at the deadline")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
            ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                     for r in range(world)]
            wall = time.perf_counter() - t0
        name = f"{spec['arch']}{' reduced' if spec['reduced'] else ''}"
        for r in ranks:
            print(f"[mesh-train] {card}: 9m{run} {name} {spec['backend']} "
                  f"rank {r['rank']} of {world} at {tuple(r['coordinate'])} "
                  f"of {spec['shape']}: losses {r['losses']} (one process "
                  f"{r['one_losses']}), grad_norm {r['grad_norms']}; "
                  f"{spec['steps']} mesh steps {r['mesh_step_s']:.2f} s "
                  f"(eager; one process {r['one_step_s']:.2f} s); "
                  f"segment_histogram launches {r['launches']}; memory: "
                  f"params + states resident {r['resident_gb']:.4f} GB, "
                  f"peak {r['peak_gb']:.4f} GB over the rank's start, "
                  f"predicted params + grads + states "
                  f"{r['predicted_gb']:.4f} GB (the one-process step's "
                  f"peak {r['one_peak_gb']:.4f} GB)")
        if not spec["one"]:
            held = "no one-process reference (it does not fit one card)"
        elif spec["exact"]:
            held = ("every rank's losses, grad_norm, lr_scale and "
                    "parameters bit for bit the one-process step's")
        else:
            held = (f"every rank's losses, grad_norm and lr_scale within "
                    f"rtol {MESH_TRAIN_RTOL} of the one-process step's, "
                    f"expert_load equal")
        print(f"[mesh-train] 9m{run}: {held}; every loss finite; "
              f"{wall:.1f} s with the spawn")
        if spec["arch"] == "mixtral-8x22b":
            out["launches"] += [r["launches"] for r in ranks]
        out[run] = dict(wall_s=wall, arch=spec["arch"],
                        shape=list(spec["shape"]), backend=spec["backend"],
                        ranks=ranks)
    return out


def cache_map(fn, cache, *rest):
    """fn over the leaves of a cache tree (and the matching leaves of
    `rest`), None kept: the hybrid's nested states, its tail or the VLM's
    tail cache may be None."""
    if cache is None:
        return None
    if isinstance(cache, dict):
        return {k: cache_map(fn, v, *(r[k] for r in rest))
                for k, v in cache.items()}
    return fn(cache, *rest)


def cache_leaves(cache) -> list:
    out = []
    cache_map(out.append, cache)
    return out


def first_tick_logits(eng, shd) -> torch.Tensor:
    """The last-position logits of an engine's next tick (its host inputs
    as they stand) on a copy of its cache: (B, V), whole on every rank."""
    from repro_torch.models import api
    from repro_torch.models.common import distribute_tree
    toks = eng._tok_in.to(eng.device)
    pos = eng._pos_in.to(eng.device)
    if shd.mesh is not None:
        toks = distribute_tree(toks, shd.placements(toks.shape, "batch",
                                                    None), shd.mesh)
        pos = distribute_tree(pos, shd.placements(pos.shape, "batch"),
                              shd.mesh)
    with torch.no_grad():
        lg, _ = api.decode_step(eng.params, eng.cfg, cache_map(
            torch.Tensor.clone, eng.cache), {"tokens": toks}, pos, shd)
    lg = lg[:, -1]
    return lg.full_tensor() if shd.mesh is not None else lg


def mesh_serve_rank(rank: int, world: int, run: str, spec: dict,
                    out_dir: str) -> None:
    """One rank of phase 7m (a spawned process; MESH_SERVE's form): the
    one-process engines on the rank's card (eager on the plain versions,
    then on the graph, `serve_both`), then a `ServingEngine(mesh=)` over
    the same weights and requests, its ticks timed one by one, counts
    zeroed just before its run and read just after; its tokens and first
    tick's logits held to the graph engine's, its memory beside what the
    placements predict, and where `spec["prefill"]`, a
    `build_prefill(mesh=)` held to the one-process prefill.  Writes
    rank<r>.json."""
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import api
    from repro_torch.models.common import NO_SHARD, ShardCtx
    from repro_torch.serve import ServingEngine, build_prefill
    from repro_torch.serve.serve_step import mesh_params
    from repro_torch.tree import flatten

    label = f"7m{run} rank {rank} of {world}"
    t0 = time.perf_counter()
    mesh = make_lm_mesh(spec["shape"], backend="nccl",
                        init_method=f"file://{out_dir}/store", rank=rank,
                        world_size=world, timeout_s=300)
    t_mesh = time.perf_counter() - t0
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        cfg = get(spec["arch"])
        if spec["layers"]:
            cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
        model = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
        rng = np.random.default_rng(0)
        lens = rng.integers(spec["prompt_len"][0], spec["prompt_len"][1] + 1,
                            spec["n_requests"])
        news = rng.integers(spec["new_tokens"][0], spec["new_tokens"][1] + 1,
                            spec["n_requests"])
        requests = [(rng.integers(0, cfg.vocab, n).tolist(), int(m))
                    for n, m in zip(lens, news)]
        slots, max_seq = spec["slots"], spec["max_seq"]
        one, engines = serve_both(dev, cfg, model, slots, max_seq, requests,
                                  "mesh-serve", f"7m{run} rank {rank} ")
        want = [r.out for r in engines["graph"].queue]
        del engines
        fresh = ServingEngine(cfg, slots, max_seq, model, device=dev)
        for p, m in requests:
            fresh.submit(p, m)
        fresh._admit()
        lg_one = first_tick_logits(fresh, NO_SHARD)
        del fresh
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        # The mesh engine: counts zeroed just before its run, read after.
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(cfg, slots, max_seq, model, mesh=mesh)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - base
        resident, predicted = placed_bytes(
            list(flatten(eng.params.tree()).values())
            + cache_leaves(eng.cache), mesh)
        reqs = [eng.submit(p, m) for p, m in requests]
        eng._admit()
        shd = ShardCtx(mesh, eng.fns.rules)
        lg_mesh = first_tick_logits(eng, shd)
        seen, ticks = [], []
        kernel = ops.segment_histogram

        def watched(values, n_bins, use_kernels=True):
            out = kernel(values, n_bins, use_kernels=use_kernels)
            if use_kernels and not seen:
                seen.append((values.clone(), out.clone()))
            return out

        ops.segment_histogram = watched
        torch.cuda.synchronize()
        ops.reset_launches()
        tick_s, made_at = [], [[] for _ in reqs]   # the tick of each output
        t0 = time.perf_counter()
        try:
            while any(not r.done for r in reqs):     # ServingEngine.run, timed
                eng._admit()
                t = time.perf_counter()
                eng._tick()
                tick_s.append(time.perf_counter() - t)
                for r, at in zip(reqs, made_at):
                    at += [eng.ticks] * (len(r.out) - len(at))
        finally:
            ops.segment_histogram = kernel
        t_run = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - base
        got = [r.out for r in reqs]
        # The first tick at which a request's token differs, if one does.
        diverged = min((at[next(i for i, (a, b) in enumerate(zip(g, w))
                                if a != b)]
                        for g, w, at in zip(got, want, made_at) if g != w),
                       default=None)
        scale = float(lg_one.float().abs().max())
        logit_err = float((lg_mesh.float() - lg_one.float()).abs().max())
        check(all(len(r.out) == m for r, (_, m) in zip(reqs, requests)),
              f"{label}: a request did not complete with its max_new_tokens")
        check(eng.fns.eager_calls == eng.ticks and eng.fns.captures == 0
              and eng.fns.replays == 0,
              f"{label}: eager / captures / replays {eng.fns.eager_calls} / "
              f"{eng.fns.captures} / {eng.fns.replays} over {eng.ticks} ticks")
        if spec["exact"]:
            check(got == want, f"{label}: tokens differ from the one-process "
                  f"engine's from tick {diverged} on")
            check(torch.equal(lg_mesh, lg_one), f"{label}: the first tick's "
                  f"logits differ from the one-process engine's by "
                  f"{logit_err!r}")
        else:
            check(logit_err <= MESH_SERVE_LOGIT_RTOL * scale,
                  f"{label}: the first tick's logits differ by {logit_err!r} "
                  f"from the one-process engine's (scale {scale!r})")
        if cfg.family == "moe":
            want_n = eng.ticks * cfg.n_layers
            check(launches["segment_histogram"] == want_n and seen,
                  f"{label}: segment_histogram launched "
                  f"{launches['segment_histogram']} times, not {want_n}")
            values, out = seen[0]
            rows = (slots // mesh.shape[0] if slots % mesh.shape[0] == 0
                    else slots)
            check(values.numel() == rows * cfg.topk,
                  f"{label}: the kernel saw {values.numel()} routed copies, "
                  f"not this rank's rows' {rows * cfg.topk}")
            check(torch.equal(out, kernel(values, cfg.n_experts,
                                          use_kernels=False)),
                  f"{label}: segment_histogram differs from its plain "
                  f"version on the rank's rows")
        prefill = None
        if spec["prefill"]:
            B, S = spec["prefill"]
            prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                       .astype(np.int32)).to(dev)
            fp = build_prefill(cfg, mesh=mesh)
            mp = mesh_params(cfg, model, fp)
            one_fp = build_prefill(cfg, device=dev)
            times = {}
            outs = {}
            for name, fn, params in (("one", one_fp, model), ("mesh", fp, mp)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[name] = fn.prefill(params, {"tokens": prompts})
                torch.cuda.synchronize()
                times[name] = time.perf_counter() - t0
            err = float((outs["mesh"].float() - outs["one"].float()).abs()
                        .max())
            if spec["exact"]:
                check(torch.equal(outs["mesh"], outs["one"]),
                      f"{label}: prefill logits differ from the one-process "
                      f"prefill's by {err!r}")
            else:
                pscale = float(outs["one"].float().abs().max())
                check(err <= MESH_SERVE_LOGIT_RTOL * pscale,
                      f"{label}: prefill logits differ by {err!r} (scale "
                      f"{pscale!r})")
            check(bool(torch.isfinite(outs["mesh"]).all()),
                  f"{label}: prefill logits not finite")
            prefill = dict(shape=[B, S], mesh_ms=times["mesh"] * 1e3,
                           one_ms=times["one"] * 1e3, max_abs_err=err)
            del outs, mp
        # Where a mesh tick's time goes (not counted), after the prefill
        # (a profile's summary holds a rank back from the next
        # collective): the collectives one decode step issues
        # (CommDebugMode) and a profile of two more, on every rank in
        # step; rank 0's printed.
        from torch.distributed.tensor.debug import CommDebugMode
        from torch.profiler import ProfilerActivity, profile
        toks = torch.from_numpy(eng.next_tok[:, None].copy())
        pos = torch.from_numpy(np.minimum(eng.pos, max_seq - 1))

        def step():
            return eng.fns.decode(eng.params, eng.cache, toks, pos)[0]

        with CommDebugMode() as comm:
            step()
        comms = {str(k).rsplit(".", 1)[-1]: v
                 for k, v in comm.get_comm_counts().items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # Device kernels only: NCCL's "nccl:<op>" ranges repeat its
        # kernels' time.  An NCCL kernel's time includes its wait for the
        # other ranks to launch theirs.
        events = [e for e in prof.key_averages()
                  if "CUDA" in str(getattr(e, "device_type", ""))
                  and not e.key.startswith("nccl:")]
        busy_us = sum(e.self_device_time_total for e in events)
        nccl_us = sum(e.self_device_time_total for e in events
                      if "nccl" in e.key.lower())
        top = [[e.key[:60], e.self_device_time_total / 1e3] for e in sorted(
            events, key=lambda e: -e.self_device_time_total)[:5]]
        tick_profile = dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                            nccl_ms=nccl_us / 1e3,
                            busy_share=busy_us / wall_us if events else None,
                            top=top, comms=comms)
        result = dict(
            rank=rank, world=world, device=str(dev), mesh_s=t_mesh,
            coordinate=list(mesh.get_coordinate()), ticks=eng.ticks,
            tick_median_ms=float(np.median(tick_s)) * 1e3,
            run_s=t_run, decode_tokens_per_s=eng.tokens_out / t_run,
            one_eager_tick_ms=one["eager"]["tick_median_ms"],
            one_graph_tick_ms=one["graph"]["tick_median_ms"],
            launches=launches["segment_histogram"],
            resident_gb=resident / 1e9, predicted_gb=predicted / 1e9,
            allocated_growth_gb=grown / 1e9, peak_gb=peak / 1e9,
            first_tick_logit_err=logit_err, logit_scale=scale,
            diverged_at_tick=diverged,
            prefill=prefill, tick_profile=tick_profile)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def mesh_serving(card: str, runs: dict = MESH_SERVE) -> dict:
    """Phase 7m: `ServingEngine(mesh=)` and `build_prefill(mesh=)` over a
    (data, model) mesh of NCCL ranks, rank r on card r, each run of `runs`
    spawned and joined with a deadline (`mesh_serve_rank`)."""
    import tempfile

    import torch.multiprocessing as mp

    torch.cuda.synchronize()
    print(f"[mesh-serve] {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated before the ranks start")
    out = {"launches": []}
    for run, spec in runs.items():
        world = int(np.prod(spec["shape"]))
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ctx = mp.start_processes(mesh_serve_rank,
                                     args=(world, run, spec, tmp),
                                     nprocs=world, join=False,
                                     start_method="spawn")
            deadline = time.monotonic() + MESH_SERVE_DEADLINE_S
            try:
                while not ctx.join(timeout=5):
                    check(time.monotonic() < deadline, f"7m{run}: ranks "
                          f"still running at the deadline")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
            ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                     for r in range(world)]
            wall = time.perf_counter() - t0
        name = spec["arch"] + (f" (depth {spec['layers']})"
                               if spec["layers"] else "")
        for r in ranks:
            pre = r["prefill"]
            print(f"[mesh-serve] {card}: 7m{run} {name} nccl rank "
                  f"{r['rank']} of {world} at {tuple(r['coordinate'])} of "
                  f"{spec['shape']}: {spec['n_requests']} requests on "
                  f"{spec['slots']} slots, max_seq {spec['max_seq']}, "
                  f"{r['ticks']} ticks; median tick {r['tick_median_ms']:.2f} "
                  f"ms over the mesh (eager) beside one process "
                  f"{r['one_eager_tick_ms']:.2f} (eager, plain) and "
                  f"{r['one_graph_tick_ms']:.2f} (graph); "
                  f"{r['decode_tokens_per_s']:.1f} decode tokens/s; "
                  f"segment_histogram launches {r['launches']}; params + "
                  f"cache resident {r['resident_gb']:.4f} GB (predicted "
                  f"{r['predicted_gb']:.4f}, allocated by the engine "
                  f"{r['allocated_growth_gb']:.4f}), peak "
                  f"{r['peak_gb']:.4f} GB over the engine's start; first "
                  f"tick's logits max |diff| {r['first_tick_logit_err']!r} "
                  f"(largest logit {r['logit_scale']:.3f}); tokens first "
                  f"differ at tick {r['diverged_at_tick']}"
                  + ("" if pre is None else
                     f"; prefill {pre['shape'][0]} x {pre['shape'][1]} "
                     f"{pre['mesh_ms']:.1f} ms over the mesh, "
                     f"{pre['one_ms']:.1f} ms in one process, max |diff| "
                     f"{pre['max_abs_err']!r}"))
        tp = ranks[0]["tick_profile"]
        print(f"[mesh-serve] 7m{run} rank 0: a decode step issues "
              f"{tp['comms']}; 2 steps profiled: wall {tp['wall_ms']:.1f} "
              f"ms, device kernels {tp['busy_ms']:.1f} ms ("
              + ("not measured" if tp["busy_share"] is None else
                 f"{100 * tp['busy_share']:.1f} %")
              + f"), of it NCCL's {tp['nccl_ms']:.1f} ms (waits for the "
              f"other ranks included); top device operations {tp['top']}")
        prefilled = " and the prefill's" if spec["prefill"] else ""
        held = (f"every request's tokens, the first tick's logits{prefilled}"
                f" bit for bit the one-process engine's" if spec["exact"] else
                f"the first tick's logits{prefilled} within "
                f"{MESH_SERVE_LOGIT_RTOL} of the largest logit of the "
                f"one-process engine's")
        print(f"[mesh-serve] 7m{run}: {held}; {wall:.1f} s with the spawn")
        if spec["arch"] == "mixtral-8x22b":
            out["launches"] += [r["launches"] for r in ranks]
        out[run] = dict(wall_s=wall, arch=spec["arch"],
                        shape=list(spec["shape"]), ranks=ranks)
    return out


def family_config(spec):
    """A 10m run's config: the published one, reduced where
    `spec["reduced"]`, its depth `spec["layers"]` where given."""
    from repro_torch.configs import get
    cfg = get(spec["arch"])
    cfg = cfg.reduced() if spec["reduced"] else cfg
    return (cfg if spec.get("layers") is None
            else dataclasses.replace(cfg, n_layers=spec["layers"]))


def placed_bytes(tensors, mesh) -> tuple[int, int]:
    """(bytes this rank holds of `tensors`, the bytes their placements
    predict: each tensor's over the shards its placements give)."""
    from repro_torch.models.common import to_local
    held = predicted = 0
    for t in tensors:
        held += to_local(t).numel() * t.element_size()
        shards = int(np.prod([n for pl, n in zip(t.placements, mesh.shape)
                              if pl.is_shard()]))
        predicted += t.numel() * t.element_size() // shards
    return held, predicted


def family_train(dev, mesh, spec, label: str) -> dict:
    """10m's training: the one-process eager step (the reference: its
    metrics, and its parameters copied to the host where `exact`), the
    one-process graph step beside it (eager, capture, replay), then the
    mesh step from the same seed-made model and batch, its counts zeroed
    just before and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import frontend_shapes
    from repro_torch.models import api
    from repro_torch.models.common import local_of, to_local
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import build_train_step
    from repro_torch.tree import flatten
    R = MESH_FAMILY_RUN
    cfg = family_config(spec)
    dtype = getattr(torch, spec["dtype"])
    ocfg = AdamWConfig(lr=R["lr"], state_bits=spec["bits"])
    kw = dict(total_steps=10, warmup_steps=1)
    B, S = R["batch"], R["seq"]
    rng = np.random.default_rng(R["seed"])
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32)) for k in ("tokens", "labels")}
    for k, shape in frontend_shapes(cfg, B, S).items():
        batch[k] = torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dtype)

    def model_of(**placed):
        model = api.init_model(cfg, torch.Generator(device=dev).manual_seed(
            R["seed"]), device=dev, dtype=dtype, **placed)
        if "gate" in spec:       # a zero gate hides the cross-attention
            to_local(model.ca_blocks.gate).fill_(spec["gate"])
        return model

    def steps(fns, model):
        opt = adamw.init(model.tree(), ocfg)
        out, ms = [], []
        for _ in range(R["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, m = fns.step(model, opt, batch)
            out.append({k: v.detach().cpu() for k, v in m.items()})
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    def freed():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    base = freed()
    one = build_train_step(cfg, ocfg, device=dev, **kw)
    model1 = model_of()
    model1.use_kernels = False
    want, one_ms = steps(one, model1)
    one_peak = torch.cuda.max_memory_allocated() - base
    ref = ({k: t.detach().cpu() for k, t in flatten(model1.tree()).items()}
           if spec["exact"] else None)
    del one, model1
    freed()
    graph = build_train_step(cfg, ocfg, device=dev, **kw)
    _, graph_ms = steps(graph, model_of())
    c = graph.compiled
    check((c.eager_calls, c.captures, c.replays) == (1, 1, R["steps"] - 1),
          f"{label}: one-process graph eager / captures / replays "
          f"{c.eager_calls} / {c.captures} / {c.replays}")
    del graph, c
    base = freed()

    fns = build_train_step(cfg, ocfg, mesh=mesh, **kw)
    flat_pl = flatten(fns.param_placements)
    flat_opt = flatten(adamw.init(fns.params_abstract, ocfg)["mu"])
    predicted = 0
    for key, p in flatten(fns.params_abstract).items():
        shards = int(np.prod([n for pl, n in zip(flat_pl[key], mesh.shape)
                              if pl.is_shard()]))
        states = sum(t.numel() * t.element_size() for k, t in flat_opt.items()
                     if k.rsplit("/", 1)[0] == key)
        predicted += (2 * p.numel() * dtype.itemsize + states) / shards
    model = model_of(placements=fns.param_placements, mesh=mesh)
    resident = torch.cuda.memory_allocated() - base
    ops.reset_launches()
    got, mesh_ms = steps(fns, model)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() - base
    check(not launches, f"{label}: custom kernels launched: {launches}")
    for i, (g, w) in enumerate(zip(got, want)):
        check(set(g) == set(w), f"{label}: metrics {sorted(g)}")
        for k in ("loss", "zloss", "grad_norm", "lr_scale"):
            same = (torch.equal(g[k], w[k]) if spec["exact"] else
                    abs(float(g[k]) - float(w[k]))
                    <= MESH_TRAIN_RTOL * abs(float(w[k])) + 1e-7)
            check(same, f"{label}: step {i} {k} {float(g[k])!r} vs one "
                  f"process {float(w[k])!r}")
    check(all(np.isfinite(float(m["loss"])) for m in got),
          f"{label}: a loss is not finite")
    if ref is not None:
        for key, t in flatten(model.tree()).items():
            check(torch.equal(to_local(t).cpu(), local_of(
                ref[key], t.placements, mesh)), f"{label}: parameter {key} "
                f"differs from the one-process step's")
    del model, fns
    freed()
    return dict(losses=[float(m["loss"]) for m in got],
                one_losses=[float(m["loss"]) for m in want],
                grad_norms=[float(m["grad_norm"]) for m in got],
                mesh_step_ms=mesh_ms, one_step_ms=one_ms,
                graph_step_ms=graph_ms, resident_gb=resident / 1e9,
                predicted_gb=predicted / 1e9, peak_gb=peak / 1e9,
                one_peak_gb=one_peak / 1e9)


def decode_both(mesh, dec, one, mp, model, cache, cache1, tok, pos0: int,
                ticks: int, label: str, exact: bool) -> dict:
    """`ticks` greedy ticks of the mesh step `dec` on `cache` and of the
    one-process eager step `one` on `cache1`, from the same tokens at
    positions pos0, pos0 + 1, ...; each tick's tokens equal (`exact`) and,
    after the last, every rank's blocks of the cache equal to the
    one-process cache's (else their largest difference reported)."""
    from repro_torch.models.common import local_of, to_local
    tok1, ms, ms1 = tok, [], []
    model.use_kernels = False
    for t in range(ticks):
        pos = torch.full((tok.shape[0],), pos0 + t, dtype=torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt1, _ = one.decode(model, cache1, tok1, pos)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        nxt, _ = dec.decode(mp, cache, tok, pos)
        torch.cuda.synchronize()
        ms1.append((t1 - t0) * 1e3)
        ms.append((time.perf_counter() - t1) * 1e3)
        if exact:
            check(torch.equal(nxt.cpu(), nxt1.cpu()), f"{label}: tick {t} "
                  f"tokens {nxt.tolist()} != one process {nxt1.tolist()}")
        tok, tok1 = nxt[:, None], nxt1[:, None]
    model.use_kernels = True
    worst = 0.0
    for mine, whole in zip(cache_leaves(cache), cache_leaves(cache1)):
        block = local_of(whole, mine.placements, mesh)
        worst = max(worst, float((to_local(mine).float() - block.float())
                                 .abs().max()))
        if exact:
            check(torch.equal(to_local(mine), block),
                  f"{label}: a cache block differs from the one-process "
                  f"cache's")
    return dict(mesh_tick_ms=float(np.median(ms)),
                one_tick_ms=float(np.median(ms1)), cache_max_abs_err=worst)


def family_serve(dev, mesh, spec, label: str) -> dict:
    """10m's serving: the one-process engines (eager on the plain
    versions, then the graph; `serve_both`), then `ServingEngine(mesh=)`
    on the same weights and requests, counts zeroed just before its run;
    then the prefill and its ticks ("b", "c") or the ring's ticks ("a")."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import frontend_shapes
    from repro_torch.models import api
    from repro_torch.models.common import NO_SHARD, ShardCtx, local_of, to_local
    from repro_torch.serve import ServingEngine, build_decode_step
    from repro_torch.serve.serve_step import _rows, mesh_cache, mesh_params
    from repro_torch.tree import flatten
    R = MESH_FAMILY_RUN
    cfg = family_config(spec)
    dtype = getattr(torch, spec["dtype"])
    model = api.init_model(cfg, torch.Generator(device=dev).manual_seed(
        R["seed"]), device=dev, dtype=dtype)
    if "gate" in spec:
        model.ca_blocks.gate.fill_(spec["gate"])
    rng = np.random.default_rng(R["seed"])
    lens = rng.integers(R["prompt_len"][0], R["prompt_len"][1] + 1,
                        R["n_requests"])
    news = rng.integers(R["new_tokens"][0], R["new_tokens"][1] + 1,
                        R["n_requests"])
    requests = [(rng.integers(0, cfg.vocab, n).tolist(), int(m))
                for n, m in zip(lens, news)]
    slots, max_seq = R["slots"], R["max_seq"]
    one, engines = serve_both(dev, cfg, model, slots, max_seq, requests,
                              "mesh-family", f"{label} ")
    want = [r.out for r in engines["eager"].queue]
    del engines
    fresh = ServingEngine(cfg, slots, max_seq, model, device=dev)
    for p, m in requests:
        fresh.submit(p, m)
    fresh._admit()
    lg_one = first_tick_logits(fresh, NO_SHARD)
    del fresh
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, slots, max_seq, model, mesh=mesh)
    held, predicted = placed_bytes(
        list(flatten(eng.params.tree()).values()) + cache_leaves(eng.cache),
        mesh)
    reqs = [eng.submit(p, m) for p, m in requests]
    eng._admit()
    lg_mesh = first_tick_logits(eng, ShardCtx(mesh, eng.fns.rules))
    ops.reset_launches()
    tick_ms = []
    t0 = time.perf_counter()
    while any(not r.done for r in reqs):           # ServingEngine.run, timed
        eng._admit()
        t = time.perf_counter()
        eng._tick()
        tick_ms.append((time.perf_counter() - t) * 1e3)
    run_s = time.perf_counter() - t0
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() - base
    got = [r.out for r in reqs]
    scale = float(lg_one[:, :cfg.vocab].float().abs().max())   # no pads
    logit_err = float((lg_mesh.float() - lg_one.float()).abs().max())
    check(not launches, f"{label}: custom kernels launched: {launches}")
    check(all(len(r.out) == m for r, (_, m) in zip(reqs, requests)),
          f"{label}: a request did not complete with its max_new_tokens")
    check(held == predicted, f"{label}: params + cache {held} B held, "
          f"{predicted} B predicted by the placements")
    if spec["exact"]:
        check(got == want, f"{label}: tokens differ from the one-process "
              f"eager engine's")
        check(torch.equal(lg_mesh, lg_one), f"{label}: the first tick's "
              f"logits differ from the one-process engine's by {logit_err!r}")
    else:
        check(logit_err <= MESH_SERVE_LOGIT_RTOL * scale,
              f"{label}: the first tick's logits differ by {logit_err!r} "
              f"(scale {scale!r})")
    diverged = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w),
                    None)
    out = dict(ticks=eng.ticks, mesh_tick_ms=float(np.median(tick_ms)),
               run_s=run_s, one_eager_tick_ms=one["eager"]["tick_median_ms"],
               one_graph_tick_ms=one["graph"]["tick_median_ms"],
               resident_gb=held / 1e9, predicted_gb=predicted / 1e9,
               resident_bytes=held, peak_gb=peak / 1e9,
               first_tick_logit_err=logit_err,
               logit_scale=scale, first_request_differing=diverged)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    with torch.no_grad():
        if spec["prefill"]:
            B, S = spec["prefill"]
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
                np.int32)).to(dev)
            batch = {"tokens": tokens}
            for k, shape in frontend_shapes(cfg, B, S).items():
                batch[k] = torch.from_numpy(rng.standard_normal(
                    shape, dtype=np.float32)).to(dev).to(dtype)
            ms = S + R["ticks"]
            dec = build_decode_step(cfg, B, ms, mesh=mesh)
            one_dec = build_decode_step(cfg, B, ms, device=dev)
            mp = mesh_params(cfg, model, dec)
            shd = ShardCtx(mesh, dec.rules)
            cache1 = api.init_cache(cfg, B, ms, device=dev)
            cache = mesh_cache(cfg, dec)
            times = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg1, cache1 = api.prefill(model, cfg, batch, cache1)
            torch.cuda.synchronize()
            times["one"] = (time.perf_counter() - t0) * 1e3
            rows = {k: _rows(v, shd) for k, v in batch.items()}
            t0 = time.perf_counter()
            lg, cache = api.prefill(mp, cfg, rows, cache, shd)
            lg = lg.full_tensor()
            torch.cuda.synchronize()
            times["mesh"] = (time.perf_counter() - t0) * 1e3
            err = float((lg.float() - lg1.float()).abs().max())
            filled = "enc_out" if cfg.family == "encdec" else "vis"
            check(tuple(cache[filled].shape) == tuple(cache1[filled].shape)
                  and bool(to_local(cache[filled]).abs().max() > 0),
                  f"{label}: the prefill left {filled} unfilled")
            if spec["exact"]:
                check(torch.equal(lg, lg1), f"{label}: prefill logits differ "
                      f"by {err!r}")
            tok = lg1[:, -1].argmax(-1).to(torch.int32)[:, None]
            out["prefill"] = dict(shape=[B, S], mesh_ms=times["mesh"],
                                  one_ms=times["one"], max_abs_err=err,
                                  **decode_both(mesh, dec, one_dec, mp, model,
                                                cache, cache1, tok, S,
                                                R["ticks"], label,
                                                spec["exact"]))
            del cache, cache1, mp, dec, one_dec, lg, lg1
        if spec["ring"]:
            pos0, ms = spec["ring"]
            B = R["ring_batch"]
            dec = build_decode_step(cfg, B, ms, mesh=mesh)
            one_dec = build_decode_step(cfg, B, ms, device=dev)
            mp = mesh_params(cfg, model, dec)
            cache1 = api.init_cache(cfg, B, ms, device=dev)
            g = torch.Generator(device=dev).manual_seed(R["seed"])
            for t in cache_leaves(cache1):        # seeded: no attention to 0
                t.copy_(torch.randn(t.shape, generator=g, device=dev))
            cache = mesh_cache(cfg, dec)
            cache_map(lambda mine, whole: to_local(mine).copy_(local_of(
                whole, mine.placements, mesh)), cache, cache1)
            window = cache1["attn_k"].shape[2]
            check(pos0 < window <= pos0 + R["ticks"] - 1,
                  f"{label}: ticks {pos0}-{pos0 + R['ticks'] - 1} do not "
                  f"cross the {window}-slot ring's wrap")
            tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(
                np.int32)).to(dev)
            out["ring"] = dict(positions=[pos0, pos0 + R["ticks"] - 1],
                               window=window, max_seq=ms,
                               **decode_both(mesh, dec, one_dec, mp, model,
                                             cache, cache1, tok, pos0,
                                             R["ticks"], label,
                                             spec["exact"]))
            del cache, cache1, mp, dec, one_dec
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_family_rank(rank: int, world: int, runs: dict, out_dir: str
                     ) -> None:
    """The rank of phase 10m (a spawned process): every run of `runs`
    (MESH_FAMILY's form), its training then its serving, over one mesh of
    NCCL ranks.  Writes rank<r>.json."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_lm_mesh
    shapes = {tuple(spec["shape"]) for spec in runs.values()}
    check(len(shapes) == 1, f"10m: runs over several mesh shapes {shapes}")
    t0 = time.perf_counter()
    mesh = make_lm_mesh(shapes.pop(), backend="nccl",
                        init_method=f"file://{out_dir}/store", rank=rank,
                        world_size=world, timeout_s=300)
    result = dict(rank=rank, world=world, mesh_s=time.perf_counter() - t0,
                  coordinate=list(mesh.get_coordinate()), runs={})
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        for run, spec in runs.items():
            label = f"10m{run} rank {rank} of {world}"
            t0 = time.perf_counter()
            got = {}
            if spec["train"]:
                got["train"] = family_train(dev, mesh, spec, label)
            if spec["serve"]:
                got["serve"] = family_serve(dev, mesh, spec, label)
            got["wall_s"] = time.perf_counter() - t0
            result["runs"][run] = got
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def mesh_families(card: str, runs: dict = MESH_FAMILY,
                  deadline_s: float = MESH_FAMILY_DEADLINE_S) -> dict:
    """Phase 10m: the hybrid, enc-dec and VLM families over a (data, model)
    mesh of NCCL ranks, rank r on card r, every run in one spawn joined
    with a deadline (`mesh_family_rank`)."""
    import tempfile

    import torch.multiprocessing as mp

    torch.cuda.synchronize()
    print(f"[mesh-family] {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated before the ranks start")
    world = int(np.prod(next(iter(runs.values()))["shape"]))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(mesh_family_rank, args=(world, runs, tmp),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      "10m: ranks still running at the deadline")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(world)]
        wall = time.perf_counter() - t0
    for run, spec in runs.items():
        name = spec["arch"] + (" reduced" if spec["reduced"] else "") + (
            f" (depth {spec['layers']})" if spec.get("layers") else "")
        for r in ranks:
            got, where = r["runs"][run], (f"rank {r['rank']} of {world} at "
                                          f"{tuple(r['coordinate'])}")
            tr, sv = got.get("train"), got.get("serve")
            if tr:
                print(f"[mesh-family] {card}: 10m{run} {name} {where}: "
                      f"training losses {tr['losses']} (one process "
                      f"{tr['one_losses']}); step ms mesh "
                      f"{[round(t, 1) for t in tr['mesh_step_ms']]} (eager), "
                      f"one process eager {[round(t, 1) for t in tr['one_step_ms']]}"
                      f", graph {[round(t, 1) for t in tr['graph_step_ms']]} "
                      f"(eager, capture, replay); parameters resident "
                      f"{tr['resident_gb']:.4f} GB, predicted params + grads "
                      f"+ states {tr['predicted_gb']:.4f} GB, peak "
                      f"{tr['peak_gb']:.4f} GB (one process "
                      f"{tr['one_peak_gb']:.4f})")
            if sv:
                print(f"[mesh-family] {card}: 10m{run} {name} {where}: "
                      f"serving {MESH_FAMILY_RUN['n_requests']} requests on "
                      f"{MESH_FAMILY_RUN['slots']} slots, {sv['ticks']} "
                      f"ticks; median tick {sv['mesh_tick_ms']:.2f} ms mesh "
                      f"(eager) beside one process "
                      f"{sv['one_eager_tick_ms']:.2f} (eager, plain) and "
                      f"{sv['one_graph_tick_ms']:.2f} (graph); params + "
                      f"cache resident {sv['resident_gb']:.4f} GB (predicted "
                      f"{sv['predicted_gb']:.4f}), peak {sv['peak_gb']:.4f} "
                      f"GB; first tick's logits max |diff| "
                      f"{sv['first_tick_logit_err']!r} (largest logit "
                      f"{sv['logit_scale']:.3f}); first request differing "
                      f"{sv['first_request_differing']}")
                for part in ("prefill", "ring"):
                    if part in sv:
                        p = sv[part]
                        what = (f"prefill {p['shape'][0]} x {p['shape'][1]} "
                                f"{p['mesh_ms']:.1f} ms mesh, "
                                f"{p['one_ms']:.1f} ms one process (max "
                                f"|diff| {p['max_abs_err']!r}), then"
                                if part == "prefill" else
                                f"ring of {p['window']} slots (max_seq "
                                f"{p['max_seq']}), positions "
                                f"{p['positions'][0]}-{p['positions'][1]}:")
                        print(f"[mesh-family] 10m{run} {where}: {what} "
                              f"{MESH_FAMILY_RUN['ticks']} ticks, median "
                              f"{p['mesh_tick_ms']:.2f} ms mesh, "
                              f"{p['one_tick_ms']:.2f} ms one process "
                              f"(eager, plain); the caches' largest "
                              f"difference {p['cache_max_abs_err']!r}")
            print(f"[mesh-family] 10m{run} {where} took {got['wall_s']:.1f} s")
    specs = list(runs.values())
    if all(s["exact"] for s in specs):
        held = ("every loss, grad_norm, lr_scale and parameter, every served "
                "token, the first tick's logits, the prefill's logits and "
                "every tick and cache block after it bit for bit the "
                "one-process runs'")
    else:
        held = ", ".join(
            part for part, ran in (
                (f"training within rtol {MESH_TRAIN_RTOL}",
                 any(s["train"] for s in specs)),
                (f"first ticks within {MESH_SERVE_LOGIT_RTOL} of the largest "
                 f"logit, resident bytes as the placements predict",
                 any(s["serve"] for s in specs))) if ran)
    print(f"[mesh-family] 10m: {held}; no kernel launched; {wall:.1f} s with "
          f"the spawn")
    return dict(wall_s=wall, runs={run: dict(arch=spec["arch"],
                                             shape=list(spec["shape"]))
                                   for run, spec in runs.items()},
                ranks=ranks)


def family_cell(dev, spec) -> dict:
    """Phase 10's cell `spec`: serve (prefill, decode, and a
    `ServingEngine` eager on the plain versions and on its CUDA graph) and
    train one
    family at its published widths.  No custom kernel lies on this path:
    launch counts are zeroed just before and must read 0 just after."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.train import frontend_shapes, make_batch
    from repro_torch.models import api
    from repro_torch.models.common import count_params
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import build_train_step
    from repro_torch.tree import flatten

    R = FAMILY_RUN
    tag, full = spec["tag"], ARCHS[spec["arch"]]
    B, S = R["batch"], R["seq"]
    out = {}

    def model_of(n_layers, dtype=torch.bfloat16):
        cfg = (full if n_layers is None
               else dataclasses.replace(full, n_layers=n_layers))
        model = api.init_model(cfg, torch.Generator(device=dev).manual_seed(
            R["seed"]), device=dev, dtype=dtype)
        if "gate" in spec:         # a zero gate hides the cross-attention
            model.ca_blocks.gate.fill_(spec["gate"])
        return cfg, model

    def cut(cfg):
        return ("none" if cfg.n_layers == full.n_layers else
                f"n_layers {full.n_layers} -> {cfg.n_layers}")

    def layout_of(cache):
        return {k: None if v is None else (tuple(v.shape), str(v.dtype))
                for k, v in flatten(cache).items()}

    def finite(t, what):
        check(bool(torch.isfinite(t[..., :full.vocab]).all()),
              f"{tag}: {what} logits not finite")

    def peak_gb(what):
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(peak < R["peak_gb"], f"{tag}: {what} peak {peak:.2f} GB, "
              f"past {R['peak_gb']} GB")
        return peak

    # -- serving --------------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    cfg, model = model_of(spec.get("layers"))
    torch.cuda.synchronize()
    n_params = count_params(api.layout(cfg))
    print(f"[family] {tag} {cfg.name} ({cfg.family}): d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, "
          f"d_ff {cfg.d_ff}, ssm_state {cfg.ssm_state}, ssm_chunk "
          f"{cfg.ssm_chunk}, vocab {cfg.vocab}; {n_params} bf16 parameters "
          f"({n_params * 2 / 1e9:.2f} GB) drawn in "
          f"{time.perf_counter() - t0:.2f} s; serving cut: {cut(cfg)}")
    out.update(params=n_params, serve_cut=cut(cfg))
    rng = np.random.default_rng(R["seed"])
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)}
    for k, shape in frontend_shapes(cfg, B, S).items():
        batch[k] = torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev).to(torch.bfloat16)
    max_seq = S + R["decode_steps"]
    prefill_s = []
    with torch.no_grad():
        for _ in range(R["prefill_reps"]):
            cache = api.init_cache(cfg, B, max_seq, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = api.prefill(model, cfg, batch, cache)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        check(lg.shape == (B, 1, cfg.padded_vocab()),
              f"{tag}: prefill logits {tuple(lg.shape)}")
        finite(lg, "prefill")
        before = layout_of(cache)
        nxt = lg[:, -1].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(R["decode_steps"]):
            pos = torch.full((B,), S + t, dtype=torch.int32, device=dev)
            lg, cache = api.decode_step(model, cfg, cache,
                                        {"tokens": nxt[:, None]}, pos)
            finite(lg, f"decode step {t}")
            nxt = lg[:, -1].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        t_decode = (time.perf_counter() - t0) / R["decode_steps"]
    check(layout_of(cache) == before,
          f"{tag}: the cache changed keys, shapes or dtypes in decode")
    t_prefill = float(np.median(prefill_s))
    print(f"[family] {tag} prefill of {B} x {S} tokens"
          f"{' over frames ' + str(tuple(batch['frames'].shape)) if 'frames' in batch else ''}"
          f": median {t_prefill * 1e3:.1f} ms of "
          f"{', '.join(f'{t * 1e3:.1f}' for t in prefill_s)} "
          f"({B * S / t_prefill:.0f} tokens/s); then {R['decode_steps']} "
          f"decode steps from its cache, {t_decode * 1e3:.2f} ms a step; "
          f"logits finite, the cache's layout kept")
    out.update(prefill_ms=[t * 1e3 for t in prefill_s],
               prefill_median_ms=t_prefill * 1e3,
               decode_step_ms=t_decode * 1e3)
    del cache, lg

    lens = rng.integers(R["prompt_len"][0], R["prompt_len"][1] + 1,
                        R["n_requests"])
    news = rng.integers(R["new_tokens"][0], R["new_tokens"][1] + 1,
                        R["n_requests"])
    requests = [(rng.integers(0, cfg.vocab, n).tolist(), int(m))
                for n, m in zip(lens, news)]
    serving, engines = serve_both(dev, cfg, model, R["slots"], R["max_seq"],
                                  requests, "family", f"{tag} ")
    want = layout_of(api.init_cache(cfg, R["slots"], R["max_seq"],
                                    device="meta"))
    for mode, eng in engines.items():
        check(layout_of(eng.cache) == want,
              f"{tag}: the {mode} engine's cache left init_cache's layout")
    serve_peak = peak_gb("serving")
    print(f"[family] {tag} serving: prompts {int(lens.min())}-"
          f"{int(lens.max())}, new tokens {int(news.min())}-"
          f"{int(news.max())}; both caches keep init_cache's layout; peak "
          f"allocated (measured) {serve_peak:.2f} GB")
    out.update(serving=serving, serve_peak_gb=serve_peak)
    del engines, eng, model
    gc.collect()
    torch.cuda.empty_cache()

    if "duality" in spec:
        # The float32 model: its forward's last logits against decode_step
        # replayed over the same tokens from a zeroed cache (two chunks of
        # 256 and more, so the carried state is used).
        n = spec["duality"]
        cfg32, model32 = model_of(spec.get("layers"), torch.float32)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, n)).astype(
            np.int32)).to(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            lf, _ = api.forward(model32, cfg32, {"tokens": toks},
                                last_only=True)
            cache = api.init_cache(cfg32, B, n, torch.float32, device=dev)
            for t in range(n):
                ld, cache = api.decode_step(
                    model32, cfg32, cache, {"tokens": toks[:, t:t + 1]},
                    torch.full((B,), t, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        err = float((lf - ld)[..., :cfg.vocab].abs().max())
        scale = float(lf[..., :cfg.vocab].abs().max())
        same = bool(torch.equal(lf.argmax(-1), ld.argmax(-1)))
        check(err <= spec["duality_tol"],
              f"{tag}: duality |forward - decode replay| {err:.3g} past "
              f"{spec['duality_tol']:.3g}")
        print(f"[family] {tag} duality (float32, full width, {B} x {n} "
              f"tokens, chunk {cfg32.ssm_chunk}): max |forward's last logits"
              f" - decode replay's| {err:.3g} (tolerance "
              f"{spec['duality_tol']:.3g}; logits up to {scale:.3g}), same "
              f"argmax {same}, {time.perf_counter() - t0:.1f} s")
        out.update(duality_max_abs_err=err, duality_logit_scale=scale)
        del model32, cache, lf, ld
        torch.cuda.empty_cache()

    # -- training -------------------------------------------------------------
    torch.cuda.synchronize()
    train_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg, model = model_of(spec.get("train_layers", spec.get("layers")))
    n_train = count_params(api.layout(cfg))
    ocfg = AdamWConfig(lr=R["lr"], state_bits=spec["state_bits"])
    opt = adamw.init(model.tree(), ocfg)
    steps = spec["steps"]
    fns = build_train_step(cfg, ocfg, total_steps=steps,
                           warmup_steps=R["warmup"], device=dev)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, S, B, seed=R["seed"]))
    batch = make_batch(cfg, pipe, 0, np.random.default_rng(R["seed"]), dev)
    step_s, metrics = [], []
    with captures_watched() as watch:
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model, opt, m = fns.step(model, opt, batch)
            m = {k: v.detach().cpu() for k, v in m.items()}
            step_s.append(time.perf_counter() - t)
            metrics.append(m)
    train_peak = peak_gb("train step")
    c = fns.compiled
    check((c.eager_calls, c.captures, c.replays) == (1, 1, steps - 1),
          f"{tag}: eager calls, captures, replays {c.eager_calls}, "
          f"{c.captures}, {c.replays}; expected 1, 1, {steps - 1}")
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    check(all(np.isfinite(losses + norms)),
          f"{tag}: losses {losses} / grad_norm {norms} not finite")
    check(losses[-1] < losses[0], f"{tag}: the loss did not descend: "
          f"{losses}")
    check(int(opt["step"]) == steps, f"{tag}: opt step {int(opt['step'])}")
    warm = float(np.median(step_s[2:]))
    print(f"[family] {tag} training ({n_train} parameters, "
          f"{spec['state_bits']}-bit AdamW states, remat {cfg.remat!r}; "
          f"cut: {cut(cfg)}): losses {', '.join(f'{v:.4f}' for v in losses)}"
          f"; grad_norm {', '.join(f'{v:.4f}' for v in norms)}; steps "
          f"{', '.join(f'{t * 1e3:.1f}' for t in step_s)} ms: cold first "
          f"(eager) {step_s[0] * 1e3:.1f} ms, capturing "
          f"{step_s[1] * 1e3:.1f} ms, warm median (replays) "
          f"{warm * 1e3:.1f} ms, {B * S / warm:.0f} tokens/s; opt step "
          f"{steps}; peak allocated (measured) {train_peak:.2f} GB")
    print(f"[family] {tag} train graph: {capture_line(watch.seen)}")
    prof = {}
    t0 = time.perf_counter()
    profile_calls(lambda: fns.step(model, opt, batch),
                  f"{tag} one warm train step ({B} x {S} tokens)", 1, top=8,
                  tag="family", sink=prof, cpu=False)
    print(f"[family] {tag} the profiled step and its summary took "
          f"{time.perf_counter() - t0:.1f} s")
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(not launches, f"{tag}: custom kernels launched: {launches}")
    out.update(train_params=n_train, train_cut=cut(cfg), losses=losses,
               grad_norms=norms, step_ms=[t * 1e3 for t in step_s],
               warm_step_ms=warm * 1e3, train_tokens_per_s=B * S / warm,
               train_peak_gb=train_peak, train_base_gb=train_base / 1e9,
               warm_step_profile=prof,
               train_graph=watch.seen)
    del model, opt, fns, c, batch, metrics     # the graph and its pool too
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_families(dev) -> dict:
    """Phase 10: every cell of FAMILIES, one after another."""
    out = {}
    for spec in FAMILIES:
        t0 = time.perf_counter()
        out[spec["arch"]] = family_cell(dev, spec)
        out[spec["arch"]]["wall_s"] = time.perf_counter() - t0
        print(f"[family] {spec['tag']} took "
              f"{out[spec['arch']]['wall_s']:.1f} s")
    return out


def dryrun_predictions() -> dict:
    """Phase 11's predictions, traced on fake tensors (no card): the dry
    run's `size` of each training step that phases 9 and 10 measure (the
    same config cut, batch, remat and state bits), its record of each
    cell of DECODE_CELLS, and 11m's (`mesh_predictions("1x1")`).  Runs in
    a child process while the card runs phases 3-10."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCHS, ShapeCell
    from repro_torch.launch import dryrun

    def train(tag, arch, n_layers, batch, seq, bits):
        cfg = ARCHS[arch]
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        return dict(arch=arch, n_layers=cfg.n_layers, **dryrun.size(
            cfg, ShapeCell(tag, seq, batch, "train"), 1, bits))

    out = {"9a": train("9a", TRAIN["arch"], TRAIN["n_layers"],
                       TRAIN["batch"], TRAIN["seq"], TRAIN["state_bits"]),
           "9b": train("9b", DRIVER["arch"], None, DRIVER["batch"],
                       DRIVER["seq"], 32)}
    for spec in FAMILIES:
        out[spec["tag"]] = train(
            spec["tag"], spec["arch"],
            spec.get("train_layers", spec.get("layers")),
            FAMILY_RUN["batch"], FAMILY_RUN["seq"], spec["state_bits"])
    for spec in DECODE_CELLS:
        out[spec["tag"]] = dryrun.run_cell(spec["arch"], spec["shape"])
    out["11m"] = mesh_predictions("1x1")
    return out


def decode_cell(dev, spec, pred) -> dict:
    """Phase 11b / 11c: one `SHAPES` decode cell at full depth through
    `build_decode_step`: `ticks` eager steps of the plain versions at the
    cache's last positions (the first one's peak held to the dry run's
    prediction), then `api.decode_step`'s logits over the same positions
    and tokens, then the graph over them, its next tokens equal to the
    eager step's at every position.  A pass over the positions rewrites
    the same keys and values; a cache that carries a recurrent state (the
    ssm and hybrid families') is put back to its state before the first
    tick first, from a copy."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.models import api
    from repro_torch.serve import build_decode_step
    from repro_torch.tree import flatten

    tag, cfg, cell = spec["tag"], ARCHS[spec["arch"]], SHAPES[spec["shape"]]
    check(pred["status"] == "ok", f"{tag}: the dry run of {cfg.name} x "
          f"{cell.name}: {pred.get('error', pred['status'])}")
    B, S, n = cell.global_batch, cell.seq_len, spec["ticks"]
    mem, rl = pred["memory"], pred["roofline"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = api.init_model(cfg, torch.Generator(device=dev).manual_seed(
        spec["seed"]), device=dev)
    fns = build_decode_step(cfg, B, S, device=dev)
    cache = api.init_cache(cfg, B, S, device=dev)
    leaves = [t for t in flatten(cache).values() if t is not None]
    start = ([t.clone() for t in leaves]
             if cfg.family in ("ssm", "hybrid") else None)
    copies = sum(t.nbytes for t in start or [])
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(spec["seed"])
    tokens = [torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(
        np.int32)).to(dev)]
    positions = [torch.full((B,), S - n + t, dtype=torch.int32, device=dev)
                 for t in range(n)]

    def rewind():
        for t, s0 in zip(leaves, start or []):
            t.copy_(s0)

    def tick(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, _ = fns.decode(model, cache, tokens[t], positions[t])
        torch.cuda.synchronize()
        return nxt, time.perf_counter() - t0

    model.use_kernels = False             # the plain versions, eager
    eager_s, eager_next = [], []
    for t in range(n):
        nxt, dt = tick(t)
        if t == 0:
            peak = torch.cuda.max_memory_allocated() - base - copies
        eager_s.append(dt)
        eager_next.append(nxt)
        if t + 1 < n:
            tokens.append(nxt[:, None])
    rewind()
    with torch.no_grad():
        for t in range(n):
            lg, _ = api.decode_step(model, cfg, cache, {"tokens": tokens[t]},
                                    positions[t])
            check(bool(torch.isfinite(lg[..., :cfg.vocab]).all()),
                  f"{tag}: logits at position {S - n + t} not finite")
            check(torch.equal(lg[:, -1].argmax(-1).to(torch.int32),
                              eager_next[t]),
                  f"{tag}: decode_step's argmax at position {S - n + t} "
                  f"differs from the eager step's")
    del lg
    model.use_kernels = True              # the graph
    graph_s = []
    with captures_watched() as watch:
        for _ in range(spec["graph_passes"]):
            rewind()
            for t in range(n):
                nxt, dt = tick(t)
                check(torch.equal(nxt, eager_next[t]),
                      f"{tag}: the graph's next tokens at position "
                      f"{S - n + t} differ from the eager plain step's")
                graph_s.append(dt)
    c = fns.compiled
    ticks = n * spec["graph_passes"]
    check((c.eager_calls, c.captures, c.replays) == (n + 1, 1, ticks - 1),
          f"{tag}: eager calls, captures, replays {c.eager_calls}, "
          f"{c.captures}, {c.replays}; expected {n + 1}, 1, {ticks - 1}")
    warm = float(np.median(graph_s[2:]))
    ratio = mem["total_per_device"] / peak
    print(f"[dryrun] {tag} {cfg.name} x {cell.name} at full depth "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads, {cfg.n_kv_heads} KV heads, vocab {cfg.vocab}): {B} slots,"
          f" {S} positions; weights and cache made in {t_init:.2f} s; "
          f"positions {S - n}-{S - 1}: logits finite, the graph's next "
          f"tokens == the eager plain step's at every position")
    print(f"[dryrun] {tag} memory: predicted {mem['total_per_device'] / 1e9:.3f}"
          f" GB (arguments {mem['argument_bytes'] / 1e9:.3f}, temp "
          f"{mem['temp_bytes'] / 1e9:.3f}), measured peak over the weights, "
          f"the cache and the first eager tick {peak / 1e9:.3f} GB: "
          f"predicted / measured {ratio:.4f}")
    print(f"[dryrun] {tag} ticks: eager (plain) median "
          f"{np.median(eager_s) * 1e3:.2f} ms of "
          f"{', '.join(f'{t * 1e3:.2f}' for t in eager_s)}; graph warm "
          f"median {warm * 1e3:.2f} ms ({B / warm:.0f} decode tokens/s); "
          f"dry run: bound {rl['bound_s'] * 1e3:.2f} ms ({rl['dominant']}),"
          f" ideal {max(rl['ideal_compute_s'], rl['ideal_memory_s']) * 1e3:.2f}"
          f" ms, roofline_fraction {rl['roofline_fraction']:.4f}; measured "
          f"warm tick / bound {warm / rl['bound_s']:.3f}")
    print(f"[dryrun] {tag} graph: {capture_line(watch.seen)}")
    prof = {}
    profile_calls(lambda: fns.decode(model, cache, tokens[-1],
                                     positions[-1]),
                  f"{tag} one replayed tick", 1, top=6, tag="dryrun",
                  sink=prof, cpu=False)
    if spec["peak_tol"] is not None:
        check(abs(ratio - 1) <= spec["peak_tol"],
              f"{tag}: predicted {mem['total_per_device'] / 1e9:.3f} GB, "
              f"measured {peak / 1e9:.3f} GB: past ±{spec['peak_tol']:.0%}")
    out = dict(arch=cfg.name, shape=cell.name, n_layers=cfg.n_layers,
               slots=B, cache_positions=S, positions=[S - n, S - 1],
               predicted_gb=mem["total_per_device"] / 1e9,
               measured_peak_gb=peak / 1e9, predicted_over_measured=ratio,
               eager_tick_ms=[t * 1e3 for t in eager_s],
               graph_tick_ms=[t * 1e3 for t in graph_s],
               graph_warm_median_ms=warm * 1e3, tokens_per_s=B / warm,
               bound_ms=rl["bound_s"] * 1e3, dominant=rl["dominant"],
               roofline_fraction=rl["roofline_fraction"], graph=watch.seen,
               replay_profile=prof)
    del model, cache, fns, c, tokens, positions, eager_next, nxt, leaves
    del start
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dryrun_phase(dev, card: str, pred: dict, measured: dict) -> dict:
    """Phase 11: the dry run's predicted peak of each training step of
    phases 9 and 10 beside its measured peak (`measured`: tag -> bytes over
    the phase's start; printed, not gated), then each cell of
    DECODE_CELLS."""
    out = {"card": card, "training": {}}
    for tag, got in measured.items():
        p = pred[tag]
        want = p["memory"]["total_per_device"]
        out["training"][tag] = dict(
            arch=p["arch"], n_layers=p["n_layers"], predicted_gb=want / 1e9,
            measured_peak_gb=got / 1e9, predicted_over_measured=want / got,
            trace_s=p["trace_s"])
        print(f"[dryrun] {tag} {p['arch']} ({p['n_layers']} layers) train "
              f"step: predicted {want / 1e9:.2f} GB (arguments "
              f"{p['memory']['argument_bytes'] / 1e9:.2f}, temp "
              f"{p['memory']['temp_bytes'] / 1e9:.2f}; traced in "
              f"{p['trace_s']:.1f} s), measured peak {got / 1e9:.2f} GB: "
              f"predicted / measured {want / got:.3f}")
    for spec in DECODE_CELLS:
        t0 = time.perf_counter()
        out[spec["tag"]] = decode_cell(dev, spec, pred[spec["tag"]])
        out[spec["tag"]]["wall_s"] = time.perf_counter() - t0
        print(f"[dryrun] {spec['tag']} took {out[spec['tag']]['wall_s']:.1f}"
              f" s")
    print(f"[dryrun] on {card}")
    return out


def mesh_dryrun_phase(card: str, pred: dict, mesh_train: dict,
                      mesh_family: dict, mesh_kind: str = "1x1") -> dict:
    """Phase 11m (the module's docstring): the dry run over `mesh_kind`
    (`pred`: `mesh_predictions`' form) beside the measured peak of each
    phase 9m run it holds and the resident params + cache of each phase
    10m engine, rank by rank.  The `1x1` records' memory must equal the
    one-card records' to the byte, and each rank's resident bytes the
    prediction's."""
    out = {"card": card, "mesh": mesh_kind}
    for key, recs in pred.items():
        if "card" in recs and mesh_kind == "1x1":
            check(recs["1x1"]["memory"] == recs["card"]["memory"],
                  f"11m {key}: the 1x1 record's memory "
                  f"{recs['1x1']['memory']} is not the one-card record's "
                  f"{recs['card']['memory']}")
    for run in [r for r in MESH_TRAIN if f"9m-{r}" in pred]:
        out.update(mesh_train_beside(pred[f"9m-{run}"][mesh_kind], run,
                                     mesh_train[run]["ranks"], mesh_kind))
    for run in [r for r in MESH_FAMILY if f"10m-{r}" in pred]:
        want = resident(pred[f"10m-{run}"][mesh_kind])
        out[f"10m-{run}"] = []
        for r in mesh_family["ranks"]:
            got = r["runs"][run]["serve"]["resident_bytes"]
            out[f"10m-{run}"].append(dict(rank=r["rank"], predicted=want,
                                          resident=got, ratio=want / got))
            print(f"[dryrun] 10m{run} {MESH_FAMILY[run]['arch']} over "
                  f"{mesh_kind}, rank {r['rank']}: params + cache predicted "
                  f"{want} B, resident {got} B: ratio {want / got:.6f}")
            check(want == got, f"10m{run}: rank {r['rank']} holds {got} "
                  f"B of params + cache, the dry run predicts {want} B")
    return out


def mesh_train_beside(rec: dict, run: str, ranks: list[dict],
                      mesh_kind: str, tol: float | None = None) -> dict:
    """A train prediction (`rec`, over `mesh_kind`) beside each rank's
    measured peak (`ranks`: a phase 9m run's rank results), printed with
    the ratio; with `tol`, each |ratio - 1| checked against it."""
    want = rec["memory"]["total_per_device"]
    out = []
    for r in ranks:
        got = r["peak_gb"] * 1e9
        out.append(dict(rank=r["rank"], predicted_gb=want / 1e9,
                        measured_peak_gb=r["peak_gb"],
                        predicted_over_measured=want / got))
        print(f"[dryrun] 9m{run} {rec['arch']} over {mesh_kind}, rank "
              f"{r['rank']}: predicted {want / 1e9:.4f} GB a card "
              f"(arguments {rec['memory']['argument_bytes'] / 1e9:.4f}, temp "
              f"{rec['memory']['temp_bytes'] / 1e9:.4f}), measured peak "
              f"{r['peak_gb']:.4f} GB: predicted / measured {want / got:.4f}")
        if tol is not None:
            check(abs(want / got - 1) <= tol, f"9m{run} rank {r['rank']}: "
                  f"predicted / measured {want / got:.4f}, past ±{tol}")
    return {f"9m-{run}": out}


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

    # Phase 11's predictions need no card: a child process traces them on
    # fake tensors while the card runs phases 3-10.
    tracer = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
        "spawn"))
    predictions = tracer.submit(dryrun_predictions)

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
    fused_sort = arm_cell(dev, cell, "fused+sort",
                          SCATTER_KERNELS + SCAN_KERNELS)
    cell["arms"]["fused+sort"] = fused_sort["summary"]
    del fused_sort
    torch.cuda.empty_cache()
    t3m = time.perf_counter()
    mesh = mesh_cell(cell)
    print(f"[mesh] phase 3m took {time.perf_counter() - t3m:.1f} s")
    staged = arm_cell(dev, cell, STAGED_SORT, SCAN_KERNELS + BUCKET_KERNELS)
    cell["arms"][STAGED_SORT] = staged["summary"]
    cell["sorted"] = packed_rows(cell.pop("rows"), cell.pop("valid"))
    torch.cuda.empty_cache()
    results.update(staged_kernel_checks(staged))
    path_launches = {FUSED_HASH: cell["launches"],
                     STAGED_SORT: staged["launches"],
                     LIBRARY: library_launches}
    del staged
    torch.cuda.empty_cache()
    t6 = time.perf_counter()
    healing = self_healing(dev, cell)
    print(f"[healing] phase 6 took {time.perf_counter() - t6:.1f} s")
    t6 = time.perf_counter()
    adapt = adaptation(dev, cell)
    print(f"[adapt] phase 6e took {time.perf_counter() - t6:.1f} s")
    t8 = time.perf_counter()
    serving = multi_tenant(dev, cell)
    print(f"[serve] phase 8 took {time.perf_counter() - t8:.1f} s")
    t6m = time.perf_counter()
    mesh_heal = mesh_healing(dev, cell, card)
    print(f"[mesh-heal] phase 6m took {time.perf_counter() - t6m:.1f} s")
    del cell["sorted"]
    cell_arms = cell.pop("arms")
    torch.cuda.empty_cache()
    moderate_checks(dev)
    del cell
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    print(f"[moe] join phases freed: {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB still allocated")
    t7 = time.perf_counter()
    serve = moe_serve(dev)
    results.update(histogram_checks(dev, serve))
    path_launches[MOE_SERVE] = serve["launches"]
    t9 = time.perf_counter()
    # Phase 7's engine and its timed tick (a closure over the engine's own
    # bound method) form a cycle that holds the weights: only the
    # collector frees it.
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] serving phases freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    train = moe_train(dev)
    path_launches[MOE_TRAIN] = train["launches"]
    driver = train_driver(dev)
    print(f"[train] phase 9 took {time.perf_counter() - t9:.1f} s")
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    t9m = time.perf_counter()
    mesh_train = mesh_training(card)
    print(f"[mesh-train] phase 9m took {time.perf_counter() - t9m:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t7m = time.perf_counter()
    mesh_serve = mesh_serving(card)
    print(f"[mesh-serve] phase 7m took {time.perf_counter() - t7m:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t10m = time.perf_counter()
    mesh_family = mesh_families(card)
    print(f"[mesh-family] phase 10m took {time.perf_counter() - t10m:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[family] training phases freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    t10 = time.perf_counter()
    families = lm_families(dev)
    print(f"[family] phase 10 took {time.perf_counter() - t10:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    pred = predictions.result()
    tracer.shutdown()
    print(f"[dryrun] the predictions' traces were ready "
          f"{time.perf_counter() - t11:.1f} s after phase 10 ended")
    measured = {"9a": (train["peak_gb"] - train["base_gb"]) * 1e9,
                "9b": driver["peak_gb"] * 1e9}
    for spec in FAMILIES:
        got = families[spec["arch"]]
        measured[spec["tag"]] = (got["train_peak_gb"]
                                 - got["train_base_gb"]) * 1e9
    shapes = dryrun_phase(dev, card, pred, measured)
    shapes["11m"] = mesh_dryrun_phase(card, pred["11m"], mesh_train,
                                      mesh_family)
    print(f"[dryrun] phase 11 took {time.perf_counter() - t11:.1f} s")
    t_end = time.perf_counter()

    kernels = []
    for name in ops.KERNELS:
        source, replaces, path = KERNEL_SITES[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, path=path,
                            launches=path_launches[path][name],
                            **results[name]))
        if path == MOE_TRAIN:
            kernels[-1]["serve_launches"] = serve["launches"][name]
            # Phase 9m's mesh step: each rank's launches on its rows.
            kernels[-1]["mesh_train_launches"] = mesh_train["launches"]
            # Phase 7m's mesh engine: each rank's launches on its rows.
            kernels[-1]["mesh_serve_launches"] = mesh_serve["launches"]
            check(mesh_serve["launches"] and all(
                n > 0 for n in mesh_serve["launches"]),
                f"segment_histogram launched {mesh_serve['launches']} times "
                f"by phase 7m's ranks")
    check(all(kn["launches"] > 0 for kn in kernels), "a kernel never launched")
    print(f"[done] all phases passed in {t_end - t_start:.1f} s (phases 7, "
          f"9, 10 and 11 {t_end - t7:.1f} s)")
    print(json.dumps({"join_arms": cell_arms}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"self_healing": healing}))
    print(json.dumps({"mesh_healing": mesh_heal}))
    print(json.dumps({"adaptation": adapt}))
    print(json.dumps({"join_serving": serving}))
    print(json.dumps({"training": {"moe_train": {
        k: v for k, v in train.items() if k != "launches"}, "driver": driver}}))
    print(json.dumps({"mesh_training": mesh_train}))
    print(json.dumps({"mesh_serving": mesh_serve}))
    print(json.dumps({"mesh_families": mesh_family}))
    print(json.dumps({"moe_serve": serve["summary"]}))
    print(json.dumps({"lm_families": families}))
    print(json.dumps({"dryrun": shapes}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
