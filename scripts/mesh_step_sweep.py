#!/usr/bin/env python3
"""The LM mesh tests' cases without JAX: each case of
tests/_torch_lm_mesh_cases.py (its rank body, `lm_rank`, over 4 gloo ranks
on the CPU) run from seed-made parameters and fresh optimizer states, the
mesh step against the port's one-process step with the tests' own check
(`check_metrics`); with `--serve`, each case of
tests/_torch_serve_mesh_cases.py (`serve_rank`: decode, the engine, MoE
decode, prefill) from seed-made parameters, against the one-process port
(`check_one_process`); with `--families`, the hybrid, enc-dec and VLM
cases of tests/_torch_family_mesh_cases.py, training (`train_rank`,
`check_metrics`) then serving (`serve_rank`, its `check_one_process`).
The check of the mesh path on a machine whose torch differs from the test
container's (DTensor's strategies change between torch releases) and
which has no JAX.

    python3 scripts/mesh_step_sweep.py [--serve | --families] [--cases ...]

One line a case: the worst relative difference of loss, zloss and
grad_norm over the steps and the ranks (serving: the worst logit
difference), PASS or FAIL.  Exits 1 if a case fails; a rank that fails
raises.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import _torch_family_mesh_cases as fc  # noqa: E402
import _torch_lm_mesh_cases as lc  # noqa: E402
import _torch_mesh_cases as mc  # noqa: E402
import _torch_serve_mesh_cases as sc  # noqa: E402


def seed_params(cfg) -> dict:
    """Seed-made float32 parameters as numpy (the VLM's gate at fc.GATE)."""
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    from repro_torch.tree import tree_map
    return fc.adjust(tree_map(lambda t: t.numpy(), init_params(
        api.layout(cfg), torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32)), cfg)


def start_of(case: str) -> dict:
    """The case's start without the reference: seed-made float32
    parameters as numpy, no optimizer state, the tests' batch."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[lc.CASES[case][0]].reduced()
    return {"states": [(seed_params(cfg), None)],
            "batch": lc.batch(cfg.vocab)}


def serve_start(case: str) -> dict:
    """A serve case's start without the reference: seed-made float32
    parameters as numpy and the tests' inputs."""
    from repro_torch.configs import ARCHS
    cfg = sc.config(case, ARCHS)
    return {"params": seed_params(cfg), "inputs": sc.inputs(cfg.vocab)}


def family_starts(case: str) -> tuple[dict | None, dict | None]:
    """A family case's train and serve starts without the reference (None
    where the case has no such side)."""
    from repro_torch.configs import ARCHS
    train = serve = None
    if case in fc.TRAIN:
        cfg = fc.train_config(case, ARCHS)
        train = {"states": [(seed_params(cfg), None)],
                 "batch": fc.train_batch(cfg)}
    if case in fc.SERVE:
        cfg = fc.serve_config(case, ARCHS)
        serve = {"params": seed_params(cfg),
                 "inputs": fc.serve_inputs(case, cfg.vocab),
                 "cache0": fc.seeded_cache(cfg, fc.B, fc.SERVE[case][4])}
    return train, serve


def spawned(rank_fn, starts: dict, deadline_s: float) -> list[dict]:
    """4 ranks of `rank_fn` over the cases `starts` ({case: its start})."""
    with tempfile.TemporaryDirectory() as d:
        for case, start in starts.items():
            with open(Path(d) / f"{case}.pkl", "wb") as f:
                pickle.dump(start, f)
        t0 = time.monotonic()
        ctx = mc.spawn_ranks(rank_fn, 4, f"{d}/store", d, list(starts))
        mc.join_ranks(ctx, t0 + deadline_s)
        ranks = mc.load_ranks(d, 4)
    print(f"{len(starts)} cases over 4 ranks in "
          f"{time.monotonic() - t0:.1f} s with the spawn", flush=True)
    return ranks


def held(cases, check) -> int:
    """Each case's verdict from `check(case)` (its worst logit difference,
    raising AssertionError on a failure); the number that failed."""
    failed = 0
    for case in cases:
        try:
            verdict = f"worst logit diff {check(case):.2e}: PASS"
        except AssertionError as e:
            verdict, failed = f"FAIL {e!r}"[:300], failed + 1
        print(f"{case} against the one-process port: {verdict}", flush=True)
    return failed


def serve(cases: list[str]) -> int:
    ranks = spawned(sc.serve_rank, {c: serve_start(c) for c in cases},
                    sc.DEADLINE_S)
    return 1 if held(cases, lambda c: sc.check_one_process(ranks, c)) else 0


def train_verdicts(ranks, cases) -> int:
    failed = 0
    for case in cases:
        worst = max(abs(float(g[k]) - float(w[k])) / abs(float(w[k]))
                    for rank in ranks
                    for g, w in zip(rank[case]["metrics"], rank[case]["one"])
                    for k in ("loss", "zloss", "grad_norm"))
        try:
            for rank in ranks:
                lc.check_metrics(rank[case]["metrics"], rank[case]["one"],
                                 case)
            verdict = "PASS"
        except AssertionError as e:
            verdict, failed = f"FAIL {e!r}"[:300], failed + 1
        print(f"{case}: worst rel {worst:.2e} against the one-process "
              f"step: {verdict}", flush=True)
    return failed


def families(cases: list[str]) -> int:
    starts = {c: family_starts(c) for c in cases}
    train = {c: t for c, (t, _) in starts.items() if t is not None}
    serve = {c: s for c, (_, s) in starts.items() if s is not None}
    failed = 0
    if train:
        print("training:", flush=True)
        failed += train_verdicts(spawned(fc.train_rank, train,
                                         fc.DEADLINE_S), list(train))
    if serve:
        print("serving:", flush=True)
        ranks = spawned(fc.serve_rank, serve, fc.DEADLINE_S)
        failed += held(list(serve),
                       lambda c: fc.check_one_process(ranks, c))
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--families", action="store_true")
    ap.add_argument("--cases", default=None)
    args = ap.parse_args()
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    print(sys.version.split()[0], torch.__version__, flush=True)
    if args.serve:
        return serve((args.cases or ",".join(sc.CASES)).split(","))
    if args.families:
        every = list(dict.fromkeys([*fc.TRAIN, *fc.SERVE]))
        return families(args.cases.split(",") if args.cases else every)
    cases = (args.cases or ",".join(lc.CASES)).split(",")
    ranks = spawned(lc.lm_rank, {c: start_of(c) for c in cases},
                    lc.DEADLINE_S)
    return 1 if train_verdicts(ranks, cases) else 0


if __name__ == "__main__":
    sys.exit(main())
