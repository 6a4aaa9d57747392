"""The port's drift detector and Misra–Gries sketch against the JAX
package's, host-side.

Every scenario of `tests/test_adapt.py`'s detector section and of
`tests/test_heavy_hitters.py` feeds the same count-matrix or column
sequence to `repro.core` and to `repro_torch.core`; the two must give
equal verdicts, `history`, sketches (counters and weight seen) and
`sketched_hhs`, and the port's must keep the reference tests' contracts
(the hysteresis state machine, the N/m guarantee under updates, batches
and merges)."""
from types import SimpleNamespace

import numpy as np
import pytest
from _hypothesis_stub import given, settings, st

from repro.core import adapt as jax_adapt
from repro.core import heavy_hitters as jax_hh
from repro_torch.core import adapt as port_adapt
from repro_torch.core import heavy_hitters as port_hh
from repro_torch.core import exact_heavy_hitters, two_way
from repro_torch.data import drifting_join_batch

JAX = SimpleNamespace(ad=jax_adapt, hh=jax_hh)
PORT = SimpleNamespace(ad=port_adapt, hh=port_hh)


def _both(scenario, *args, **kw):
    """`scenario(pkg, ...)` for JAX and the port; equal results.  Returns
    the port's."""
    want, got = scenario(JAX, *args, **kw), scenario(PORT, *args, **kw)
    assert got == want
    return got


def _sketch(sk):
    return dict(m=sk.m, n_seen=sk.n_seen, counters=dict(sk.counters))


def _detector(det):
    """What both packages' detectors must agree on."""
    return dict(history=list(det.history), batches=det.batches,
                drift=det.drift(), expected=det.expected.tolist(),
                observed=det.observed_cell_loads().tolist(),
                streaks=(det._replace_streak, det._replan_streak),
                last=(det._last_replace, det._last_replan),
                known={a: sorted(v) for a, v in det.known_hhs.items()},
                sketches={a: {n: _sketch(sk) for n, sk in s.items()}
                          for a, s in det.sketches.items()},
                hhs=det.sketched_hhs().per_attr,
                new=det.new_heavy_hitters())


# ---------------------------------------------------------------------------
# tv_distance and AdaptPolicy
# ---------------------------------------------------------------------------

def _tv_cases(pkg):
    p = np.array([3.0, 1.0, 0.0])
    return [pkg.ad.tv_distance(p, p), pkg.ad.tv_distance(p, 10 * p),
            pkg.ad.tv_distance([1, 0], [0, 1]),
            pkg.ad.tv_distance([1, 1], [0, 2])]


def test_tv_identity_and_disjoint():
    same, scaled, disjoint, half = _both(_tv_cases)
    assert same == 0.0 and scaled == 0.0          # normalization invariance
    assert disjoint == pytest.approx(1.0)
    assert half == pytest.approx(0.5)


def _tv_guards(pkg):
    out = [pkg.ad.tv_distance([0, 0], [0, 0]),
           pkg.ad.tv_distance([0, 0], [1, 0])]
    with pytest.raises(ValueError, match="shape") as err:
        pkg.ad.tv_distance([1, 2], [1, 2, 3])
    return out + [str(err.value)]


def test_tv_zero_sum_and_shape_guards():
    empty, one_sided, _ = _both(_tv_guards)
    assert empty == 0.0 and one_sided == 1.0


def _policy_guards(pkg):
    msgs = []
    for kw, match in ((dict(replace_threshold=0.5, replan_threshold=0.2),
                       "replace_threshold"),
                      (dict(replace_threshold=0.0), "replace_threshold"),
                      (dict(patience=0), "≥ 1")):
        with pytest.raises(ValueError, match=match) as err:
            pkg.ad.AdaptPolicy(**kw)
        msgs.append(str(err.value))
    return msgs + [repr(pkg.ad.AdaptPolicy())]


def test_policy_threshold_order_enforced():
    _both(_policy_guards)


# ---------------------------------------------------------------------------
# DriftDetector state machine: synthetic load vectors, `_drive`
# rebaselining on action as the engine does.
# ---------------------------------------------------------------------------

K = 16
POL = dict(replace_threshold=0.05, replan_threshold=0.25, window=4,
           patience=2, min_batches=2, replace_cooldown=2, replan_cooldown=4)


def _uniform():
    return np.full(K, 100.0)


def _shifted(frac):
    """Move `frac` of the total mass from the first half cells to the last."""
    loads = np.full(K, 100.0)
    move = frac * loads.sum() / (K // 2)
    loads[: K // 2] -= move
    loads[K // 2:] += move
    return loads


def _drive(pkg, load_seq, policy=POL):
    """Feed loads a batch at a time, acting + rebaselining like the engine:
    (actions, every verdict, the detector's final state)."""
    det = pkg.ad.DriftDetector(_uniform(), pkg.ad.AdaptPolicy(**policy))
    actions, verdicts = [], []
    for loads in load_seq:
        det.observe_loads(loads)
        action = det.assess()
        verdicts.append(action)
        if action != "stable":
            actions.append((det.batches, action))
            det.rebaseline(det.observed_cell_loads(), action=action)
    return actions, verdicts, _detector(det)


def test_stable_load_never_acts():
    rng = np.random.default_rng(0)
    seq = [_uniform() + rng.normal(0, 0.5, K) for _ in range(30)]
    actions, _, det = _both(_drive, seq)
    assert actions == []
    assert det["drift"] < POL["replace_threshold"]


def test_gradual_drift_replaces_before_replanning():
    seq = [_shifted(min(0.02 * i, 0.15)) for i in range(1, 25)]
    actions, _, _ = _both(_drive, seq)
    assert actions, "gradual drift must eventually act"
    assert all(a == "replace" for _, a in actions)


def test_step_shift_replans_without_thrash():
    seq = [_uniform()] * 4 + [_shifted(0.8)] * 30
    actions, _, det = _both(_drive, seq)
    replans = [b for b, a in actions if a == "replan"]
    assert len(replans) == 1, f"expected exactly one replan, got {actions}"
    assert len(actions) <= 3, f"action thrash: {actions}"
    assert det["streaks"][1] == 0
    assert det["drift"] < POL["replace_threshold"]


def test_moderate_step_heals_with_replaces_only():
    seq = [_uniform()] * 4 + [_shifted(0.45)] * 30
    actions, _, det = _both(_drive, seq)
    assert actions and all(a == "replace" for _, a in actions)
    assert len(actions) <= 3
    assert det["drift"] < POL["replace_threshold"]


def test_oscillating_load_is_ignored_by_patience():
    seq = [_shifted(0.45) if i % 2 else _uniform() for i in range(30)]
    actions, _, _ = _both(_drive, seq)
    assert all(a == "replace" for _, a in actions)
    assert len(actions) <= 2


def _min_batches(pkg):
    det = pkg.ad.DriftDetector(_uniform(), pkg.ad.AdaptPolicy(
        replace_threshold=0.01, replan_threshold=0.5, window=4,
        patience=1, min_batches=3))
    out = []
    for _ in range(3):
        det.observe_loads(_shifted(0.3))
        out.append(det.assess())
    return out


def test_min_batches_suppresses_early_decisions():
    assert _both(_min_batches) == ["stable", "stable", "replace"]


def _cooldown(pkg, pol):
    det = pkg.ad.DriftDetector(_uniform(), pkg.ad.AdaptPolicy(**pol))
    acted = []
    for i in range(20):
        det.observe_loads(_shifted(0.2 + 0.02 * (i % 7)))   # keeps drifting
        if det.assess() == "replace":
            acted.append(det.batches)
            # rebaseline to the ORIGINAL expectation so drift persists
            det.rebaseline(_uniform(), action="replace")
    return acted, _detector(det)


def test_cooldown_bounds_action_frequency():
    pol = dict(replace_threshold=0.01, replan_threshold=0.9, window=2,
               patience=1, min_batches=1, replace_cooldown=5)
    acted, _ = _both(_cooldown, pol)
    assert acted
    assert all(b - a >= pol["replace_cooldown"]
               for a, b in zip(acted, acted[1:]))


def _new_hh(pkg):
    pol = pkg.ad.AdaptPolicy(replace_threshold=0.05, replan_threshold=0.9,
                             window=4, patience=1, min_batches=1,
                             sketch_counters=32)
    det = pkg.ad.DriftDetector(_uniform(), pol, attrs=("B",), hh_frac=0.1,
                               known_hhs={"B": (7,)})
    trail = []
    # loads stay EXACTLY at baseline: TV = 0, so only the HH arm can fire
    for col in (np.array([7] * 50 + [1, 2, 3]), np.array([9] * 80 + [1, 2])):
        det.observe_loads(_uniform())
        det.observe_values({"B": {"R": col}})
        trail.append((dict(det.new_heavy_hitters()), _detector(det)))
        trail.append(det.assess())
    det.rebaseline(_uniform(), action="replan", known_hhs={"B": (7, 9)})
    trail.append(_detector(det))
    det.observe_loads(_uniform())
    det.observe_values({"B": {"R": np.array([9] * 80)}})
    trail.append(det.assess())
    return trail


def test_new_heavy_hitter_forces_replan_arm():
    (new0, _), v0, (new1, _), v1, after, v2 = _both(_new_hh)
    assert new0["B"] == () and v0 == "stable"     # 7 is already known
    assert new1["B"] == (9,) and v1 == "replan"
    assert after["sketches"]["B"] == {}           # replan resets the sketches
    assert v2 == "stable"                         # 9 is known now


def _count_matrices(pkg):
    det = pkg.ad.DriftDetector(_uniform(), pkg.ad.AdaptPolicy(**POL))
    det.observe_loads(np.ones((3, K)))
    with pytest.raises(ValueError, match="incompatible") as err:
        det.observe_loads(np.ones(K + 1))
    return det.observed_cell_loads().tolist(), str(err.value)


def test_observe_loads_accepts_count_matrices():
    loads, _ = _both(_count_matrices)
    np.testing.assert_array_equal(loads, np.full(K, 3.0))


def _rebaseline_guards(pkg):
    det = pkg.ad.DriftDetector(_uniform(), pkg.ad.AdaptPolicy(**POL))
    msgs = []
    for loads, action, match in ((_uniform(), "panic",
                                  "unknown rebaseline action"),
                                 (np.ones(K + 2), "replace", "size")):
        with pytest.raises(ValueError, match=match) as err:
            det.rebaseline(loads, action=action)
        msgs.append(str(err.value))
    return msgs


def test_rebaseline_guards():
    _both(_rebaseline_guards)


def _sketched(pkg, batch, k):
    q = two_way()
    det = pkg.ad.DriftDetector(np.ones(k), pkg.ad.AdaptPolicy(
        sketch_counters=256), attrs=("B",), hh_frac=1.0 / k)
    det.observe_values(
        {"B": {r.name: batch[r.name][:, r.attrs.index("B")]
               for r in q.relations}})
    return _detector(det)


def test_sketched_hhs_match_exact_detector_on_pinned_stream():
    """With m ≥ distinct values the sketch is exact and the estimate
    threshold reproduces `exact_heavy_hitters` bit for bit."""
    k = 32
    batch = drifting_join_batch(two_way(), 1024, 128, 100, [3, 4], 20, seed=5)
    det = _both(_sketched, batch, k)
    exact = exact_heavy_hitters(batch, two_way(), k)
    assert det["hhs"] == dict(exact.per_attr)


# ---------------------------------------------------------------------------
# Misra–Gries: the N/m guarantee under updates, batches and merges.
# ---------------------------------------------------------------------------

def _exact_counts(stream):
    vals, cnts = np.unique(np.asarray(stream), return_counts=True)
    return dict(zip(vals.tolist(), cnts.tolist()))


def _check_guarantee(sk, truth: dict, n: int):
    assert sk["n_seen"] == n
    assert len(sk["counters"]) <= sk["m"]
    for v, c in truth.items():
        est = sk["counters"].get(v, 0)
        assert est <= c, f"over-count: {v}: {est} > {c}"
        assert est >= c - n / sk["m"], f"under-count beyond N/m: {v}"
    for v, c in sk["counters"].items():
        assert c > 0
        assert v in truth, f"phantom counter {v}"


def _reduce_ties(pkg):
    return [pkg.hh._reduce_counters({i: 5 for i in range(10)}, 3),
            pkg.hh._reduce_counters({0: 10, 1: 10, 2: 10, 3: 10, 4: 10,
                                     5: 1}, 2)]


def test_reduce_counters_handles_ties_at_cut():
    a, b = _both(_reduce_ties)
    assert len(a) <= 3 and len(b) <= 2


def test_reduce_counters_noop_when_small():
    cs = {1: 5, 2: 3}
    assert _both(lambda pkg: pkg.hh._reduce_counters(dict(cs), 4)) == cs


def _adversarial_merge(pkg, m):
    a, b = pkg.hh.MisraGries(m), pkg.hh.MisraGries(m)
    for v in range(m):
        a.counters[v] = 7
        b.counters[v + m] = 7          # disjoint values, equal counts
    a.n_seen = b.n_seen = 7 * m
    return _sketch(a.merge(b))


def test_merge_never_exceeds_m_on_adversarial_ties():
    merged = _both(_adversarial_merge, 4)
    assert len(merged["counters"]) <= 4
    assert merged["n_seen"] == 56


def _update(pkg, stream, m):
    sk = pkg.hh.MisraGries(m)
    sk.update(stream)
    return _sketch(sk)


@pytest.mark.parametrize("seed,m,domain,n", [(0, 8, 50, 2000),
                                             (1, 16, 10, 500),
                                             (2, 5, 200, 3000)])
def test_update_guarantee_zipf(seed, m, domain, n):
    stream = np.random.default_rng(seed).zipf(1.5, size=n) % domain
    _check_guarantee(_both(_update, stream, m), _exact_counts(stream), n)


def _update_counts(pkg, vals, cnts, m):
    sk = pkg.hh.MisraGries(m)
    sk.update_counts(vals, cnts)
    return _sketch(sk)


@pytest.mark.parametrize("seed,m", [(3, 8), (4, 24)])
def test_update_counts_matches_expanded_stream_guarantee(seed, m):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 40, size=30)
    cnts = rng.integers(0, 50, size=30)            # zeros must be skipped
    sk = _both(_update_counts, vals, cnts, m)
    _check_guarantee(sk, _exact_counts(np.repeat(vals, cnts)),
                     int(cnts.sum()))


def test_update_counts_ignores_nonpositive():
    sk = _both(_update_counts, [1, 2, 3], [5, 0, -7], 4)
    assert sk["n_seen"] == 5 and sk["counters"] == {1: 5}


def _merge_tree(pkg, streams, m):
    merged = pkg.hh.MisraGries(m)
    for s in streams:
        shard = pkg.hh.MisraGries(m)
        shard.update(s)
        merged = merged.merge(shard)
    single = pkg.hh.MisraGries(m)
    single.update(np.concatenate(streams))
    return _sketch(merged), _sketch(single)


@pytest.mark.parametrize("seed,m,shards", [(5, 8, 2), (6, 12, 5), (7, 6, 8)])
def test_merge_tree_guarantee(seed, m, shards):
    """A left-deep merge tree over shard sketches keeps the N/m guarantee
    with N the TOTAL weight, and agrees with one sketch of the whole stream
    up to the (two-sided) guarantee."""
    rng = np.random.default_rng(seed)
    streams = [rng.zipf(1.3, size=int(rng.integers(100, 800))) % 60
               for _ in range(shards)]
    merged, single = _both(_merge_tree, streams, m)
    full = np.concatenate(streams)
    truth, n = _exact_counts(full), len(full)
    _check_guarantee(merged, truth, n)
    for v in truth:
        assert abs(merged["counters"].get(v, 0)
                   - single["counters"].get(v, 0)) <= n / m


def _weaker(pkg):
    a, b = pkg.hh.MisraGries(16), pkg.hh.MisraGries(4)
    a.update([1] * 10)
    b.update([2] * 10)
    return _sketch(a.merge(b))


def test_merge_keeps_weaker_guarantee():
    assert _both(_weaker)["m"] == 4


def _candidates(pkg, cols, n, k, m):
    out = []
    for col in cols:
        sk = pkg.hh.MisraGries(m)
        sk.update(col)
        out.append(sorted(sk.heavy_hitters(n, 1.0 / k)))
    return out


@pytest.mark.parametrize("seed", [8, 9, 10])
def test_no_false_negatives_vs_exact_on_zipf(seed):
    """`heavy_hitters` holds every exact HH: the error is < N/m strictly."""
    rng = np.random.default_rng(seed)
    k, n = 16, 4000
    col_r = rng.zipf(1.6, size=n) % 100
    col_s = rng.zipf(1.2, size=n) % 100
    data = {"R": np.stack([rng.integers(0, 50, n), col_r], axis=1),
            "S": np.stack([col_s, rng.integers(0, 50, n)], axis=1)}
    exact = exact_heavy_hitters(data, two_way(), k, max_hh_per_attr=10_000)
    cands = _both(_candidates, (col_r, col_s), n, k, 4 * k)
    for col, cand in zip((col_r, col_s), cands):
        truth = {int(v) for v, c in _exact_counts(col).items() if c >= n / k}
        assert truth <= set(cand), f"false negatives: {truth - set(cand)}"
    assert set(exact.values("B")) <= set(cands[0]) | set(cands[1])


def _certain(pkg, stream, frac):
    sk = pkg.hh.MisraGries(6)               # deliberately lossy
    sk.update(stream)
    return sorted(sk.certain_heavy_hitters(frac)), _sketch(sk)


def test_certain_heavy_hitters_no_false_positives():
    stream = np.random.default_rng(11).zipf(1.5, size=3000) % 40
    certain, _ = _both(_certain, stream, 1.0 / 8)
    truth = _exact_counts(stream)
    for v in certain:
        assert truth[v] > len(stream) / 8, f"{v} not a true HH"


@settings(max_examples=50, deadline=None)
@given(data=st.lists(st.integers(0, 30), min_size=1, max_size=500),
       m=st.integers(1, 20))
def test_prop_update_guarantee(data, m):
    _check_guarantee(_both(_update, data, m), _exact_counts(data), len(data))


@settings(max_examples=50, deadline=None)
@given(chunks=st.lists(st.lists(st.integers(0, 20), min_size=0, max_size=80),
                       min_size=1, max_size=6),
       m=st.integers(1, 12))
def test_prop_merge_tree_guarantee(chunks, m):
    streams = [np.asarray(ch, np.int64) for ch in chunks]
    merged, single = _both(_merge_tree, streams, m)
    full = np.concatenate(streams)
    if not len(full):
        assert merged["counters"] == {}
        return
    _check_guarantee(merged, _exact_counts(full), len(full))
    for v in set(full.tolist()):
        assert abs(merged["counters"].get(v, 0)
                   - single["counters"].get(v, 0)) <= len(full) / m


@settings(max_examples=50, deadline=None)
@given(vals=st.lists(st.integers(0, 25), min_size=1, max_size=40),
       m=st.integers(1, 10))
def test_prop_update_counts_guarantee(vals, m):
    cnts = [(v % 7) for v in vals]               # deterministic weights
    sk = _both(_update_counts, vals, cnts, m)
    stream = np.repeat(vals, cnts)
    if not len(stream):
        assert sk["counters"] == {} and sk["n_seen"] == 0
        return
    _check_guarantee(sk, _exact_counts(stream), len(stream))
