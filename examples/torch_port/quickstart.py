"""Quickstart of the PyTorch + CUDA port: plan a skewed 2-way join, see the
paper's numbers, and RUN it.

Reproduces Examples 1.1/1.2: a heavy hitter makes naive partitioning cost
r + ks while the Shares grid costs 2√(krs), and the full SkewShares planner
(HH detection -> residual joins -> per-residual Shares) balances reducer
load.  The finale executes a k=256 plan as 8 logical servers on one
device: the executor folds the 256 logical cells onto them with LPT
placement (core/placement.py) and the result is validated bit-exactly
against the numpy oracle.

Run:  PYTHONPATH=src python examples/torch_port/quickstart.py
      [--device cuda|cpu]   (default cuda; without a card it raises)
"""
import argparse

import numpy as np

from repro_torch.core import (canonical, naive_hh_cost, naive_two_way_cost,
                              plan_no_skew, plan_skew_join, reference_join,
                              shares_hh_cost, two_way)
from repro_torch.core.executor import ExecutorConfig, ShardedJoinExecutor
from repro_torch.data import skewed_join_dataset

N_DEVICES = 8


def main(device: str = "cuda"):
    """The planner's numbers, then the k=256 plan run on `device`; returns
    the run's data and joined rows."""
    # R(A,B) ⋈ S(B,C) with zipf-skewed B — the paper's running 2-way example.
    query = two_way()
    data = skewed_join_dataset(query, n_per_relation=50_000, domain=500,
                               skew={"B": 1.8}, seed=0)
    k = 256

    print(f"query: {query}")
    print(f"|R|={len(data['R'])}, |S|={len(data['S'])}, k={k} reducers\n")

    plan = plan_skew_join(query, data, k)
    print(f"heavy hitters detected on B: {plan.hhs.values('B')[:8]}"
          f"{'...' if len(plan.hhs.values('B')) > 8 else ''} "
          f"({plan.hhs.total()} total)")
    print(f"residual joins: {len(plan.residuals)}\n")
    for rp in plan.residuals[:6]:
        shares = " × ".join(f"{a}={s}" for a, s in
                            zip(rp.cube.attr_order, rp.cube.shares)) or "1"
        print(f"  {str(rp.residual.combo):24s} k_i={rp.k_i:4d} "
              f"shares[{shares}]  cost={rp.cost:12.0f}")

    naive = naive_two_way_cost(data, query, k, plan.hhs)
    print("\ncommunication cost:")
    print(f"  naive (Example 1.1, partition+broadcast): {naive:12.0f}")
    print(f"  SkewShares plan (Example 1.2 grids):      {plan.total_cost:12.0f}"
          f"   ({naive / plan.total_cost:.2f}x better)")

    loads_skew = plan.reducer_loads(data)
    loads_flat = plan_no_skew(query, data, k).reducer_loads(data)
    print("\nreducer balance (max/mean load):")
    print(f"  plain Shares (no HH handling): "
          f"{loads_flat.max() / max(loads_flat.mean(), 1):8.1f}")
    print(f"  SkewShares:                    "
          f"{loads_skew.max() / max(loads_skew.mean(), 1):8.1f}")

    # The paper's analytic claim, verbatim.
    r, s = 1e7, 1e5
    print(f"\nanalytic (r={r:.0e}, s={s:.0e}, one HH):")
    for kk in (16, 256, 4096):
        print(f"  k={kk:5d}: naive r+ks = {naive_hh_cost(r, s, kk):.3e}   "
              f"Shares 2√(krs) = {shares_hh_cost(r, s, kk):.3e}")

    # Now EXECUTE a k=256 plan on 8 logical servers: 256 logical cells fold
    # onto them via LPT placement; output is bit-exact vs the numpy oracle.
    run_data = skewed_join_dataset(query, n_per_relation=3_000, domain=1_500,
                                   skew={"B": 1.4}, seed=1)
    run_plan = plan_skew_join(query, run_data, k)
    ex = ShardedJoinExecutor(run_plan, N_DEVICES,
                             config=ExecutorConfig(out_capacity=1 << 18),
                             device=device)
    session = ex.session().prepare(run_data)
    res = session.run_batch()
    rows = res["rows"][res["valid"]]
    expect = reference_join(query, run_data)
    exact = np.array_equal(canonical(rows), expect)
    p = session.placement
    recv = res["recv_counts"]
    print(f"\nexecuted k={run_plan.k} plan on {p.n_devices} logical servers "
          f"on {device} ({p.strategy} placement, {p.k // p.n_devices}x "
          f"fold): {len(rows)} rows, "
          f"{'exact match' if exact else 'MISMATCH'} vs oracle")
    print(f"shuffle overflow: {int(res['shuffle_overflow'].sum())}, join "
          f"overflow: {int(res['join_overflow'].sum())}; per-device received "
          f"tuples {recv.tolist()}; steps built: "
          f"compile_count={ex.compile_count}")
    assert exact, "distributed result != oracle"
    return run_data, rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
