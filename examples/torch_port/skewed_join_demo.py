"""End-to-end run of the PyTorch + CUDA port: a distributed multiway
join under heavy skew.

Plan (HH detection + residual decomposition + Shares), then execute (hash
-> placement fold -> capacity-bounded exchange -> local joins) as 8 logical
servers on one device, validated against the single-machine oracle.  The
plan allocates k=64 LOGICAL reducer cells, 8x more than the 8 servers, and
the executor folds them onto the servers with skew-aware LPT placement
(core/placement.py).  On the card the first batch captures the step as a
CUDA graph (`compile_count` 1) and a second batch replays it.

Run:  PYTHONPATH=src python examples/torch_port/skewed_join_demo.py
      [--device cuda|cpu]   (default cuda; without a card it raises)
"""
import argparse
import time

import numpy as np

from repro_torch.core import (canonical, plan_skew_join, reference_join,
                              running_example)
from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
from repro_torch.data import skewed_join_dataset

N_DEVICES = 8


def main(device: str = "cuda"):
    """Plan, run and check the demo join on `device`; returns the data and
    the joined rows."""
    # The paper's running 3-way example: R(A,B) ⋈ S(B,E,C) ⋈ T(C,D),
    # with heavy hitters on both B and C.
    query = running_example()
    data = skewed_join_dataset(query, n_per_relation=120, domain=60,
                               skew={"B": 1.6, "C": 1.3}, seed=7)
    print(f"query: {query}")
    print(f"{N_DEVICES} logical servers on {device}\n")

    # k = 64 logical cells on 8 servers: an 8x fold.
    plan = plan_skew_join(query, data, k=64, max_hh_per_attr=3)
    print(f"HHs: B={plan.hhs.values('B')} C={plan.hhs.values('C')}")
    print(f"{len(plan.residuals)} residual joins, k={plan.k} logical cells, "
          f"total planned communication {plan.total_cost:.0f} tuples\n")

    ex = ShardedJoinExecutor(plan, N_DEVICES,
                             config=ExecutorConfig(out_capacity=32768),
                             device=device)
    t0 = time.perf_counter()
    session = ex.session().prepare(data)
    result = session.run_batch()
    rows = result["rows"][result["valid"]]
    dt = time.perf_counter() - t0
    warm = session.run_batch()
    warm_rows = warm["rows"][warm["valid"]]

    p = session.placement
    fold = np.bincount(p.table, minlength=p.n_devices)
    print(f"placement: {p.strategy}, {p.k} logical cells -> {p.n_devices} "
          f"servers ({fold.min()}-{fold.max()} cells each)")

    expect = reference_join(query, data)
    ok = (np.array_equal(canonical(rows), expect)
          and np.array_equal(warm_rows, rows))
    recv = result["recv_counts"].astype(float)
    print(f"executed in {dt:.2f}s ({'exact match' if ok else 'MISMATCH'} "
          f"vs oracle: {len(rows)} joined rows)")
    print(f"shuffle overflow: {int(result['shuffle_overflow'].sum())}, "
          f"join overflow: {int(result['join_overflow'].sum())}")
    print(f"per-device received tuples: min={recv.min():.0f} "
          f"mean={recv.mean():.0f} max={recv.max():.0f} "
          f"(imbalance {recv.max() / max(recv.mean(), 1):.2f})")
    print(f"steps built: compile_count={ex.compile_count}, "
          f"step_hits={ex.step_hits} (the second batch)")
    assert ok, "distributed result != oracle"
    return data, rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
