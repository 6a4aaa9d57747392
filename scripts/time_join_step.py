#!/usr/bin/env python3
"""Time the join executor's step on one NVIDIA GPU, for the port under a
given source tree, on chip_smoke.py's full-size cell (two_way, 2^21 rows a
relation, k = 256 on n_dev = 8).

    python3 scripts/time_join_step.py [--src DIR] [--label NAME] [--warm N]

DIR is the `src` directory whose `repro_torch` is timed (default: this
checkout's), so that two versions of the executor can be compared in one
run on one card (parent, change, change, parent).  The cell, its sizing,
the fault and the serving settings come from this checkout's chip_smoke.py.
For fused + hash, fused + sort and staged + sort: the cold first run_batch
(prepare excluded), the second (where a tree that captures graphs
captures the step), the warm median of N run_batch calls (host clock
around each, ending in `torch.cuda.synchronize()`), the peak allocated
over prepare, the first batch and the warm ones (the exactness check's
own temporaries left out), the bytes allocated and reserved once the
results are dropped, and a device-only trace of one warm batch
(torch.profiler, CUDA activity alone), whose busy time is set against
that unprofiled median.  Then on fused + hash: the chunked
exchange (overlap_shuffle = 4), the warm median after a re-fold onto 7
survivors, the time to recover from caps squeezed to 1/8 (a
`SelfHealingSession` walking the retry ladder from cold keys) and the same
ladder walked a second and a third time, with the peak over the three
walks and what the executor holds after them, mixed_workload's steady
serving windows (requests/s, p50 / p99, the peak over the windows and
what the engine holds after them), and chip_smoke.py phase 8's `full`
tenant: three requests of the cell on an engine at its k (the first
walks cap_out up its ladder), their latencies, the peak over them and
what the engine holds after them.  Every result is held to the exact
join size (serving: to reference_join).  Prints one JSON line; exits
non-zero without a CUDA device or when a result is wrong.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def synced(fn):
    """(result, seconds) of fn() on the host clock, the card drained
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def warm_median(s, n: int) -> tuple[float, list[float]]:
    times = []
    for _ in range(n):
        r, t = synced(s.run_batch)
        del r
        times.append(t * 1e3)
    return float(np.median(times)), times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--warm", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_join_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import (canonical, lpt_placement, plan_skew_join,
                                  reference_join, two_way)
    from repro_torch.core.executor import (ExecutorConfig, RetryPolicy,
                                           ShardedJoinExecutor)
    from repro_torch.data import drifting_join_batch, mixed_workload
    from repro_torch.ft import ChaosInjector
    from repro_torch.kernels import _build
    from repro_torch.serve import JoinServingEngine, SelfHealingSession

    import repro_torch
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[time_join_step] {args.label} {repro_torch.__file__}; {card}")
    _build.lib()
    dev = torch.device("cuda")
    full, n_dev = cs.FULL, cs.FULL["n_dev"]
    q = two_way()
    data = drifting_join_batch(q, full["n"], full["hh_rows"],
                               full["tail_domain"], hot_set=(), hot_bonus=0,
                               seed=0)
    plan = plan_skew_join(q, data, full["k"])
    exact = cs.join_size(data)

    cap_out = cs.cell_out_capacity(dev, plan, data)

    def fresh():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def held():
        """(GB allocated, GB reserved) once the allocator's free blocks
        are returned: what live tensors and graph pools pin."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return (torch.cuda.memory_allocated() / 1e9,
                torch.cuda.memory_reserved() / 1e9)

    def graphs(executors):
        return sum(getattr(e, "captures", 0) for e in executors)

    def exact_rows(res, label):
        if int(res.tensors[1].sum()) != exact:
            raise SystemExit(f"time_join_step: {label}: valid rows "
                             f"{int(res.tensors[1].sum())} != {exact}")

    out = dict(label=args.label, card=card, exact=exact, cap_out=cap_out)
    for arm in ("fused+hash", "fused+sort", "staged+sort"):
        fresh()
        ex = ShardedJoinExecutor(plan, n_dev, ExecutorConfig(
            out_capacity=cap_out, **cs.ARMS[arm]), device=dev)
        s, t_prep = synced(lambda: ex.session().prepare(data))
        res, t_first = synced(s.run_batch)
        peak = torch.cuda.max_memory_allocated()
        exact_rows(res, arm)        # (its sum's temporaries left out)
        del res
        torch.cuda.reset_peak_memory_stats()
        res, t_second = synced(s.run_batch)
        del res
        med, times = warm_median(s, args.warm)
        peak = max(peak, torch.cuda.max_memory_allocated())
        alloc, reserved = held()
        prof = {}
        cs.profile_calls(s.run_batch, f"{args.label} {arm} warm, device only",
                         1, top=5, sink=prof, cpu=False)
        busy = prof.get("busy_ms", float("nan"))
        out[arm] = dict(prepare_ms=t_prep * 1e3, first_ms=t_first * 1e3,
                        second_ms=t_second * 1e3, warm_ms=med,
                        warm_all_ms=times, peak_gb=peak / 1e9,
                        held_allocated_gb=alloc, held_reserved_gb=reserved,
                        device_busy_ms=busy, busy_of_warm=busy / med,
                        compile_count=ex.compile_count,
                        graphs=graphs([ex]))
        if arm == "fused+hash":
            survivors = [d for d in range(n_dev) if d != cs.HEALING["dead"]]
            s.refold(lpt_placement(s.cell_loads(), n_dev, devices=survivors))
            res, t_refold_first = synced(s.run_batch)
            exact_rows(res, "7 survivors")
            del res
            med7, _ = warm_median(s, args.warm)
            out["survivors7"] = dict(first_ms=t_refold_first * 1e3,
                                     warm_ms=med7)
            # Recovery: caps squeezed to 1/8 on this executor (its prepared
            # key cached), then the same ladder walked twice more.
            def squeezed():
                chaos = ChaosInjector(n_dev, seed=0)
                chaos.squeeze_caps(cs.HEALING["squeeze"])
                return SelfHealingSession(ex, chaos=chaos).prepare(data)
            torch.cuda.reset_peak_memory_stats()
            for key in ("recovery", "ladder_walked_again",
                        "ladder_walked_third"):
                eng = squeezed()
                c0, g0 = ex.compile_count, graphs([ex])
                res, t_heal = synced(eng.run_batch)
                exact_rows(res, key)
                out[key] = dict(ms=t_heal * 1e3,
                                retries=eng.stats["retries"],
                                builds=ex.compile_count - c0,
                                captures=graphs([ex]) - g0)
                del res, eng
            alloc, reserved = held()
            out["ladder_memory"] = dict(
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                held_allocated_gb=alloc, held_reserved_gb=reserved,
                graphs=graphs([ex]))
        print(f"[time_join_step] {args.label} {arm}: prepare {t_prep * 1e3:.1f}"
              f" ms, first {t_first * 1e3:.2f} ms, warm median {med:.3f} ms, "
              f"peak {peak / 1e9:.3f} GB, device busy {busy:.3f} ms "
              f"({100 * busy / med:.1f} % of the warm median)")
        del s, ex
    fresh()
    ex = ShardedJoinExecutor(plan, n_dev, ExecutorConfig(
        out_capacity=cap_out, overlap_shuffle=cs.HEALING["chunks"]),
        device=dev)
    s = ex.session().prepare(data)
    res, t_first = synced(s.run_batch)
    peak = torch.cuda.max_memory_allocated()
    exact_rows(res, "chunked")
    del res
    torch.cuda.reset_peak_memory_stats()
    med, _ = warm_median(s, args.warm)
    peak = max(peak, torch.cuda.max_memory_allocated())
    out["chunked"] = dict(chunks=cs.HEALING["chunks"], first_ms=t_first * 1e3,
                          warm_ms=med, peak_gb=peak / 1e9)
    del s, ex
    fresh()
    # Serving: mixed_workload's tenants, warm windows then steady ones.
    eng = JoinServingEngine(n_dev, device=dev)

    def serve(subs):
        reqs = [(eng.submit(t, qq, d), qq, d) for t, qq, d in subs]
        _, wall = synced(eng.run)
        for req, qq, d in reqs:
            if not np.array_equal(canonical(req.rows),
                                  canonical(reference_join(qq, d))):
                raise SystemExit(f"time_join_step: request {req.rid} wrong")
        return [r for r, _, _ in reqs], wall

    for n_warm, seed in cs.SERVE["warm"]:
        serve(mixed_workload(n_warm, seed=seed))
    c0 = eng.cache.compile_count()
    torch.cuda.reset_peak_memory_stats()
    lat, walls = [], []
    for w in range(cs.SERVE["windows"]):
        reqs, wall = serve(mixed_workload(cs.SERVE["steady"], seed=2 + w))
        lat += [r.latency_s * 1e3 for r in reqs]
        walls.append(wall)
    n = cs.SERVE["steady"] * cs.SERVE["windows"]
    peak = torch.cuda.max_memory_allocated()
    alloc, reserved = held()
    out["serving"] = dict(requests=n, requests_per_s=n / sum(walls),
                          peak_gb=peak / 1e9, held_allocated_gb=alloc,
                          held_reserved_gb=reserved,
                          graphs=graphs(eng.cache._executors.values()),
                          window_requests_per_s=[cs.SERVE["steady"] / w
                                                 for w in walls],
                          p50_ms=float(np.percentile(lat, 50)),
                          p99_ms=float(np.percentile(lat, 99)),
                          steady_builds=eng.cache.compile_count() - c0)
    del eng
    fresh()
    # Phase 8's `full` tenant: the cell on an engine at its k.
    eng = JoinServingEngine(n_dev, k=full["k"], retry=RetryPolicy(
        max_retries=cs.SERVE["max_retries"]), device=dev)
    lat = []
    for _ in range(3):
        req = eng.submit("full", q, data)
        eng.run()
        if len(req.rows) != exact:
            raise SystemExit(f"time_join_step: full request rows "
                             f"{len(req.rows)} != {exact}")
        lat.append(req.latency_s * 1e3)
        del req
    peak = torch.cuda.max_memory_allocated()
    alloc, reserved = held()
    out["serving_full"] = dict(
        latency_ms=lat, peak_gb=peak / 1e9, held_allocated_gb=alloc,
        held_reserved_gb=reserved,
        builds=eng.cache.compile_count(),
        graphs=graphs(eng.cache._executors.values()))
    del eng
    print(f"[time_join_step] {args.label} " + "; ".join(
        f"{k}: {v}" for k, v in out.items() if k not in (
            "fused+hash", "fused+sort", "staged+sort")))
    print(json.dumps({"time_join_step": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
