"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit (`nvcc`) and
skips without one.  Run them on the GPU machine with
`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`.
Outputs are int32 data-plane values, so the bar is bit equality.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (canonical, plan_skew_join, reference_join,
                              running_example, two_way)
from repro_torch.core.executor import (ExecutorConfig, ShardedJoinExecutor,
                                       _build_routes, _route_specs)
from repro_torch.data import chain_query, skewed_join_dataset
from repro_torch.kernels import bucket_pack as bp
from repro_torch.kernels import build_probe as bpr
from repro_torch.kernels import hash_partition as hp
from repro_torch.kernels import join_probe as jp
from repro_torch.kernels import map_pack as mp
from repro_torch.kernels import ops
from repro_torch.kernels import route_cells as rc
from repro_torch.kernels import scatter_pack as sp
from repro_torch.kernels import segment_histogram as sh
from repro_torch.kernels._build import KernelError
from test_torch_kernels_expand import (EXPAND_CASES, composed_cols,
                                       expand_inputs, random_probe)
from test_torch_kernels_expand import rows as expand_rows_of
from test_torch_kernels_match import keys_with_home, shared_limit

pytestmark = pytest.mark.cuda

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
CHIP_SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(CHIP_SMOKE)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(rng, n, w, domain, invalid_frac=0.1):
    rows = rng.integers(0, domain, size=(n, w)).astype(np.int32)
    rows[rng.random(n) < invalid_frac] = -1
    return rows


def _specs(k, skew_attr="B"):
    q = two_way()
    data = skewed_join_dataset(q, 600, 50, skew={skew_attr: 1.6}, seed=5)
    plan = plan_skew_join(q, data, k)
    return {n: _route_specs(r) for n, r in _build_routes(plan).items()}


def _eq(a, b):
    assert a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def _synthetic_specs(k):
    """One hashed route of fanout 2 with a not-in constraint."""
    return {"T": ((((0, 0x9E3779B1, k // 2, 1),), (0, k // 2), 0, (),
                   ((1, (7, 13)),)),)}


@pytest.mark.parametrize("k,n,make_specs", [
    (8, 0, _specs), (8, 5, _specs), (64, 1000, _specs), (256, 40000, _specs),
    (16384, 50000, _synthetic_specs)])
def test_map_count_kernel(dev, k, n, make_specs):
    """k > 8192 takes the kernel's global-atomics path."""
    rng = np.random.default_rng(k + n)
    specs = make_specs(k)
    for name, routes in specs.items():
        rows = torch.from_numpy(_rows(rng, n, 2, 50)).to(dev)
        got = ops.map_count(rows, routes, k, 8)
        _eq(got, mp.map_count_host(rows, routes, k, 8))


def _map_count_case(case, rng):
    """(rows (n, w), routes, k, n_src) of a map_count card case."""
    if case in ("cell-routes", "eq-reps-40", "eq-reps-5000"):
        rows, specs, _, k, n_dev, _ = _scatter_case(case, rng)
        return rows.reshape(-1, rows.shape[-1]), specs[0], k, rows.shape[0]
    if case.startswith("k-"):
        # 8,192 cells: the kernel's last shared-memory counter; 8,193:
        # counters in device memory (and a wrap past k that is not a power
        # of two).
        k = int(case[2:])
        return _rows(rng, 50000, 2, 1 << 20), _synthetic_specs(k)["T"], k, 8
    if case == "n-odd":         # rows past 8 * (50001 // 8) count nowhere
        return _rows(rng, 50001, 2, 50), _specs(64)["R"], 64, 8
    if case == "n-lt-src":      # one row a source, sources 3..7 empty
        return _rows(rng, 3, 2, 50), _specs(64)["R"], 64, 8
    if case == "all-padding":
        return np.full((30000, 2), -1, np.int32), _specs(64)["R"], 64, 8
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "cell-routes", "eq-reps-40", "eq-reps-5000", "k-8192", "k-8193",
    "n-odd", "n-lt-src", "all-padding"])
def test_map_count_kernel_cases(dev, case):
    """map_count at the edges of its tiles and counters: the full-size
    cell's two route shapes at 8 x 2^18 rows; fanout 42, and an eq route
    of 5,000 reps (its descriptor read in place); k at the shared counters'
    limit and one past it; n no multiple of n_src, n < n_src, and only
    padding rows.  One launch a call."""
    rng = np.random.default_rng(sum(map(ord, case)))
    rows, routes, k, n_src = _map_count_case(case, rng)
    rows = torch.from_numpy(rows).to(dev)
    ops.reset_launches()
    got = ops.map_count(rows, routes, k, n_src)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["map_count"] == 1
    _eq(got, mp.map_count_host(rows, routes, k, n_src))


def _cell_routes(k=256):
    """The full-size cell's two route shapes on R(A, B): a 1-rep tail route
    hashed on B at share 128 for B not in {0}, and a 16-rep heavy-hitter
    route for B = 0 hashed on A at share 8."""
    tail = (((1, 0x9E3779B1, 128, 1),), (0,), 0, (), ((1, (0,)),))
    heavy = (((0, 0x85EBCA6B, 8, 16),), tuple(range(16)), 128, ((1, 0),), ())
    return (tail, heavy)


def _scatter_case(case, rng):
    """(rows (n_src, n_loc, w), the route specs to pack them by, ptable, k,
    n_dev, cap) of a scatter_pack card case."""
    if case.startswith("specs"):     # the planner's routes, 8 devices
        k, n_loc, cap = (int(x) for x in case.split("-")[1:])
        rows = _rows(rng, 8 * n_loc, 2, 50).reshape(8, n_loc, 2)
        return rows, list(_specs(k).values()), rng.integers(0, 8, k), k, 8, cap
    if case.startswith("one-device"):
        # Every member copy folded to device 0; the small cap drops the
        # same copies as the plain version.
        cap = {"one-device-fits": 4096, "one-device-overflow": 50}[case]
        rows = _rows(rng, 8 * 700, 2, 50).reshape(8, 700, 2)
        return rows, [_specs(64)["R"]], np.zeros(64, np.int64), 64, 8, cap
    if case.startswith("eq-reps"):
        # An eq-only route of n_reps reps beside a hashed one: fanout above
        # 32, and (5000 reps) one row's member copies past a window of 2,048
        # with a descriptor past the kernels' shared-memory copy.
        n_reps = int(case.split("-")[2])
        routes = (((), tuple(range(n_reps)), 3, ((1, 7),), ()),
                  (((0, 0x9E3779B1, 16, 1),), (0, 1), 0, (), ((1, (7,)),)))
        rows = _rows(rng, 3 * 300, 2, 12).reshape(3, 300, 2)
        return rows, [routes], rng.integers(0, 5, 64), 64, 5, 20000
    if case.startswith("w"):
        # w = 5; w = 9 and 300, tiles of 910 and 27 rows; w = 9000, a tile
        # of one row wider than 8,192 words.
        w = int(case[1:])
        n_loc, cap = {5: (3000, 700), 9: (3000, 700), 300: (400, 100),
                      9000: (30, 40)}[w]
        routes = _synthetic_specs(32)["T"]
        rows = _rows(rng, 4 * n_loc, w, 50).reshape(4, n_loc, w)
        return rows, [routes], rng.integers(0, 8, 32), 32, 8, cap
    if case == "max-devices":
        n_dev = mp.MAX_PACK_BINS - 1
        rows = _rows(rng, 2 * 9000, 2, 5000).reshape(2, 9000, 2)
        return (rows, [_synthetic_specs(4096)["T"]],
                rng.integers(0, n_dev, 4096), 4096, n_dev, 8)
    if case == "all-padding":
        rows = np.full((8, 3000, 2), -1, np.int32)
        return rows, [_specs(64)["R"]], rng.integers(0, 8, 64), 64, 8, 16
    if case == "no-members":
        # Valid rows that every route refuses (B in its not-in set).
        rows = _rows(rng, 4 * 3000, 2, 50, 0).reshape(4, 3000, 2)
        rows[..., 1] = rng.choice([7, 13], (4, 3000))
        return (rows, [_synthetic_specs(32)["T"]], rng.integers(0, 8, 32),
                32, 8, 64)
    if case == "heavy-only":
        # Every row the heavy hitter B = 0: only the 16-rep route's copies
        # are members.
        rows = _rows(rng, 8 * 5000, 2, 1 << 20, 0).reshape(8, 5000, 2)
        rows[..., 1] = 0
        return rows, [_cell_routes()], rng.integers(0, 8, 256), 256, 8, 4096
    if case == "cell-routes":
        # 8 x 2^18 rows of R(A, B): 1 in 171 rows the heavy hitter B = 0
        # (12,288 of 2^21 at the cell), the rest a tail of 2^20 values.
        n = 8 << 18
        rows = np.stack([rng.integers(0, 1 << 20, n),
                         rng.integers(1, 1 << 20, n)], 1).astype(np.int32)
        rows[rng.random(n) < 12288 / (1 << 21), 1] = 0
        return (rows.reshape(8, 1 << 18, 2), [_cell_routes()],
                rng.integers(0, 8, 256), 256, 8, 1 << 16)
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "specs-8-1-4", "specs-64-700-8", "specs-256-5000-4096", "specs-8-0-2",
    "specs-256-2049-300", "one-device-fits", "one-device-overflow",
    "eq-reps-40", "eq-reps-5000", "w5", "w9", "w300", "w9000",
    "max-devices", "all-padding", "cell-routes"])
def test_scatter_pack_kernel(dev, case):
    """Buffer and overflow equal the plain version's, at the edges of the
    kernel's tiles and windows: n_loc of 1, 0 and no multiple of the
    1,024-row tile; every copy on one device with and without overflow;
    fanout above 32 and one row's member copies past a 2,048-copy window;
    w = 5, and w of 9, 300 and 9,000 (tiles shrunk to fit shared memory);
    the most devices; only padding rows; the cell's route shapes at its
    size."""
    rng = np.random.default_rng(sum(map(ord, case)))
    rows, specs, ptable, k, n_dev, cap = _scatter_case(case, rng)
    rows = torch.from_numpy(rows).to(dev)
    ptable = torch.from_numpy(ptable.astype(np.int32)).to(dev)
    for routes in specs:
        buf, over = ops.scatter_pack(rows, routes, ptable, k, n_dev, cap)
        buf_h, over_h = sp.scatter_pack_host(rows, routes, ptable, k, n_dev,
                                             cap)
        _eq(buf, buf_h)
        _eq(over, over_h)
    if case.endswith("overflow") or case == "eq-reps-5000":
        assert int(over.sum()) > 0


def _build_case(b, n, w, bits, recipe="few", id_=None):
    return pytest.param(b, n, w, bits, recipe, id=id_ or
                        f"{b}-{n}-{w}-{bits}-{recipe}")


@pytest.mark.parametrize("b,n,w,bits,recipe", [
    _build_case(1, 0, 2, 4, id_="1-0-2-4"),
    _build_case(3, 1000, 2, 1, id_="3-1000-2-1"),
    _build_case(8, 5000, 3, 5, id_="8-5000-3-5"),
    _build_case(2, 70000, 2, 16, id_="2-70000-2-16"),
    # build_table's digit passes (digits of at most 10 bits): one digit
    # (8, 9, 10 bits), just over one (11), the cell's 16, two full digits
    # (20), three digits (21, and 30, the widest)
    _build_case(4, 3000, 2, 8, "wide"), _build_case(4, 3000, 2, 9, "wide"),
    _build_case(4, 3000, 2, 10, "wide"), _build_case(4, 3000, 2, 11, "wide"),
    _build_case(2, 70000, 2, 16, "wide"), _build_case(2, 50000, 2, 20, "wide"),
    _build_case(2, 9000, 2, 21, "wide"), _build_case(1, 5000, 2, 30, "wide"),
    # the heavy hitter's shape: every valid row in one bucket, > 65,536 rows
    _build_case(2, 70000, 2, 16, "one_bucket"),
    _build_case(2, 70000, 2, 8, "one_bucket"),
    # only the sentinel
    _build_case(3, 5000, 2, 16, "invalid"), _build_case(3, 5000, 2, 8, "invalid"),
    # n = 1, n no multiple of the 2,048-row tile, B = 8 with w = 3
    _build_case(3, 1, 2, 16, "wide"), _build_case(3, 1, 2, 6, "wide"),
    _build_case(2, 4097, 2, 12, "wide"), _build_case(8, 20000, 3, 16, "wide"),
    # the full-size cell's scale: 8 destinations of 2^20 rows at 16 bits
    _build_case(8, 1 << 20, 2, 16, "wide"),
    # past the CUDA build's 30 bits: KernelError
    _build_case(2, 100, 2, 31, "wide")])
def test_hash_and_build_kernels(dev, b, n, w, bits, recipe):
    """join_hash and build_table against their plain versions; keys "few"
    (31 values a column, 20 % invalid), "wide" (30-bit values),
    "one_bucket" (every row one key) or "invalid" (no valid row)."""
    rng = np.random.default_rng(n + bits)
    high = 1 << 30 if recipe == "wide" else 30
    k = rng.integers(-1, high, size=(b, n, w)).astype(np.int32)
    v = rng.random((b, n)) > 0.2
    if recipe == "one_bucket":
        k[:] = k[0, 0]
    if recipe == "invalid":
        v[:] = False
    keys, valid = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
    if bits > jp.MAX_BUILD_BITS:
        with pytest.raises(KernelError, match="n_bits 31"):
            ops.build_table(keys, valid, bits)
        return
    _eq(ops.join_hash(keys, valid, bits), jp.join_hash_host(keys, valid, bits))
    for got, want in zip(ops.build_table(keys, valid, bits),
                         jp.build_table_host(keys, valid, bits)):
        _eq(got, want)


def _probe_inputs(dev, b, n_l, n_r, w, bits, recipe, seed):
    """(lk, l_bkt, rk, r_bkt, rank, hist) on the card from join_hash and
    build_table's plain versions.  Keys: "few" (31 values a column, so
    buckets hold several keys), "wide" (30-bit values, mostly distinct),
    "hot" / "hot2" (every valid right row one key, or two keys of one
    bucket interleaved; a third of the left rows carry them), "late" (four
    keys of one bucket, new ones in later tiles), "collide" (pairs of keys
    of one hash in the walk's match), "one_empty" (batch row 1
    without valid rows), "none" (no valid row on either side); valid rows
    26 % on the right (the cell's share), 80 % on the left."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    high = 31 if recipe == "few" else 1 << 30
    lk = torch.randint(0, high, (b, n_l, w), generator=gen, device=dev,
                       dtype=torch.int32)
    rk = torch.randint(0, high, (b, n_r, w), generator=gen, device=dev,
                       dtype=torch.int32)
    # half the left rows copy a right row, so most buckets see hits
    pick = torch.randint(0, max(n_r, 1), (b, n_l // 2), generator=gen,
                         device=dev)
    if n_r:
        lk[:, : n_l // 2] = torch.gather(
            rk, 1, pick[..., None].expand(-1, -1, w))
    lv = torch.rand((b, n_l), generator=gen, device=dev) < 0.8
    rv = torch.rand((b, n_r), generator=gen, device=dev) < 0.26
    if recipe in ("hot", "hot2"):
        cand = torch.randint(0, 1 << 30, (1, 1 << 16, w), generator=gen,
                             device=dev, dtype=torch.int32)
        ones = torch.ones(cand.shape[:2], dtype=torch.bool, device=dev)
        h = jp.join_hash_host(cand, ones, bits)[0]
        vals, counts = torch.unique(h, return_counts=True)
        two = torch.unique(cand[0, h == vals[counts.argmax()]], dim=0)[:2]
        assert two.shape[0] == 2
        which = (torch.arange(n_r, device=dev) % 2 if recipe == "hot2"
                 else torch.zeros(n_r, dtype=torch.long, device=dev))
        rk[:] = two[which]
        lk[:, ::3] = two[torch.randint(0, 2, lk[:, ::3].shape[:2],
                                       generator=gen, device=dev)]
    if recipe == "late":
        # One bucket (at 8 bits) holds every valid right row: its first
        # third one key, then two keys alternating, then four in turn, so
        # the first key's group spans the bucket's tiles and keys first
        # appear in later pieces.
        cand = torch.randint(0, 1 << 30, (1, 1 << 16, w), generator=gen,
                             device=dev, dtype=torch.int32)
        ones = torch.ones(cand.shape[:2], dtype=torch.bool, device=dev)
        h = jp.join_hash_host(cand, ones, bits)[0]
        vals, counts = torch.unique(h, return_counts=True)
        four = torch.unique(cand[0, h == vals[counts.argmax()]], dim=0)[:4]
        assert four.shape[0] == 4
        j = torch.arange(n_r, device=dev)
        which = torch.where(j < n_r // 3, 0, torch.where(
            j < 2 * n_r // 3, j % 2, j % 4))
        rk[:] = four[which]
        lk[:, ::3] = four[torch.randint(0, 4, lk[:, ::3].shape[:2],
                                        generator=gen, device=dev)]
    if recipe == "collide":
        # 64 keys and, beside each, a key of the same hash in the walk's
        # match ((k0 + 0x85EBCA77, k1 - 0x9E3779B1) mod 2^32): lanes of
        # different keys that the hash puts together must be told apart.
        base = torch.randint(0, 1 << 30, (64, 2), generator=gen, device=dev,
                             dtype=torch.int64)
        twin = torch.stack([(base[:, 0] + 0x85EBCA77) % (1 << 32),
                            (base[:, 1] - 0x9E3779B1) % (1 << 32)], 1)
        both = torch.cat([base, twin])
        both = torch.where(both >= 1 << 31, both - (1 << 32), both).to(
            torch.int32)
        rk[:] = both[torch.randint(0, 128, rk.shape[:2], generator=gen,
                                   device=dev)]
        lk[:] = both[torch.randint(0, 128, lk.shape[:2], generator=gen,
                                   device=dev)]
    if recipe == "one_empty":
        # Batch row 1 has no valid row on either side; the others' right
        # sides are all valid.
        rv[:] = True
        rv[1] = False
        lv[1] = False
    if recipe == "none":
        lv[:] = False
        rv[:] = False
    l_bkt = jp.join_hash_host(lk, lv, bits)
    r_bkt, rank, hist = jp.build_table_host(rk, rv, bits)
    return lk, l_bkt, rk, r_bkt, rank, hist


def _probe_case(b, n_l, n_r, w, bits, recipe, id_=None):
    return pytest.param(b, n_l, n_r, w, bits, recipe, id=id_ or
                        f"{b}-{n_l}-{n_r}-{w}-{bits}-{recipe}")


@pytest.mark.parametrize("b,n_l,n_r,w,bits,recipe", [
    # the full-size cell's shape: 8 destinations, 2^20 rows a side, 16 bits
    _probe_case(8, 1 << 20, 1 << 20, 2, 16, "wide"),
    # the hot bucket: ~270K valid rows of one key, and of two keys
    _probe_case(2, 1 << 16, 1 << 20, 2, 16, "hot"),
    _probe_case(2, 1 << 16, 1 << 20, 3, 16, "hot2"),
    # deep rounds: bits 1-2 with many keys (group lists past a warp's
    # lanes, buckets across many tiles, keys new in later tiles)
    _probe_case(2, 3000, 8000, 2, 1, "wide"),
    _probe_case(2, 3000, 8000, 1, 2, "wide"),
    _probe_case(3, 5000, 20000, 2, 2, "few"),
    # no valid rows on either side, n_l = 0, n_r = 1, n_r = 0
    _probe_case(3, 500, 700, 2, 8, "none"), _probe_case(2, 0, 900, 2, 6, "few"),
    _probe_case(2, 300, 1, 2, 4, "few"), _probe_case(2, 300, 0, 2, 4, "few"),
    # w = 1, 2, 3, 9; buckets of several keys (few); left rows in empty
    # buckets (16 bits over a few hundred right rows)
    _probe_case(4, 20000, 30000, 1, 9, "few"),
    _probe_case(4, 20000, 30000, 2, 12, "few"),
    _probe_case(4, 20000, 30000, 3, 7, "wide"),
    _probe_case(4, 20000, 30000, 9, 10, "wide"),
    _probe_case(2, 5000, 300, 2, 16, "wide"),
    # a bucket of more than 1,024 keys (rounds past one 8-bit digit pass
    # and past 1,023); a group over at least 3 walk tiles with keys new in
    # later pieces; B = 4 with a batch row of no valid rows beside full
    # ones; the hot bucket's key in every batch row
    _probe_case(2, 3000, 20000, 2, 1, "wide"),
    _probe_case(2, 5000, 20000, 2, 8, "late"),
    _probe_case(3, 4000, 40000, 3, 8, "late"),
    _probe_case(4, 20000, 30000, 2, 12, "one_empty"),
    # keys whose hashes collide in the walk's match, at 1 and 2 bits
    _probe_case(2, 3000, 8000, 2, 1, "collide"),
    _probe_case(2, 3000, 8000, 2, 2, "collide"),
    _probe_case(8, 1 << 18, 1 << 20, 2, 16, "hot")])
def test_probe_tables_kernel(dev, b, n_l, n_r, w, bits, recipe):
    """probe_tables' kernels against the plain version: one launch a call
    (none for n_r = 0)."""
    args = _probe_inputs(dev, b, n_l, n_r, w, bits, recipe, n_l + n_r + w)
    ops.reset_launches()
    got = ops.probe_tables(*args, bits)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["probe_tables"] == (1 if b * n_r else 0)
    for g, w_ in zip(got, jp.probe_tables_host(*args, bits)):
        assert g.dtype == torch.int32
        _eq(g, w_)


def test_probe_tables_wrapper_rejects_what_it_does_not_take(dev):
    args = _probe_inputs(dev, 2, 30, 40, 2, 4, "few", 1)
    ops.reset_launches()
    with pytest.raises(KernelError, match="n_bits 31"):
        jp.probe_tables_cuda(*args, 31)
    with pytest.raises(ValueError):
        jp.probe_tables_cuda(*args, 5)                   # hist of 16 buckets
    with pytest.raises(ValueError):
        jp.probe_tables_cuda(args[0][..., :1], *args[1:], 4)   # w 1 vs 2
    assert all(v == 0 for v in ops.LAUNCHES.values())


@pytest.mark.parametrize("b,n_l,n_r,cap", [(1, 1, 1, 4), (4, 300, 200, 5000),
                                           (8, 3000, 2500, 20000)])
def test_expand_rows_kernel(dev, b, n_l, n_r, cap):
    rng = np.random.default_rng(n_l + cap)
    lk = torch.from_numpy(rng.integers(0, 40, (b, n_l, 1)).astype(np.int32))
    rk = torch.from_numpy(rng.integers(0, 40, (b, n_r, 1)).astype(np.int32))
    lk, rk = lk.to(dev), rk.to(dev)
    lv = torch.ones((b, n_l), dtype=torch.bool, device=dev)
    rv = torch.from_numpy(rng.random((b, n_r)) > 0.1).to(dev)
    bits = jp.default_bits(n_r)
    bl = jp.join_hash_host(lk, lv, bits)
    br, rank, hist = jp.build_table_host(rk, rv, bits)
    counts, lo, perm = jp.probe_tables_host(lk, bl, rk, br, rank, hist,
                                            bits)
    left = torch.cat([lk, lk + 100], -1)
    right = torch.cat([rk, rk * 3], -1)
    got = ops.expand_rows(left, right, counts, lo, perm, cap)
    want = sp.expand_rows_host(left, right, counts, lo, perm, cap)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def _expand_eq(dev, args, cols):
    """One launch per call; the kernel equal to the plain version."""
    args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    ops.reset_launches()
    got = ops.expand_rows(*args, cols=cols)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["expand_rows"] == 1
    want = sp.expand_rows_host(*args, cols=cols)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("name", list(EXPAND_CASES))
def test_expand_rows_fused_kernel(dev, name):
    """The CPU test's cases (tests/test_torch_kernels_expand.py), with
    their column map and with none."""
    args = expand_inputs(name)
    _expand_eq(dev, args, composed_cols(name))
    _expand_eq(dev, args, None)


def _probe_args(rng, b, n_l, n_r, cap, wl=3, wr=3):
    counts, lo, perm = random_probe(rng, b, n_l, n_r)
    return tuple(torch.from_numpy(x) for x in (
        expand_rows_of(rng, b, n_l, wl), expand_rows_of(rng, b, n_r, wr),
        counts, lo, perm)) + (cap,)


@pytest.mark.parametrize("n_cols", range(1, 8))
def test_expand_rows_fused_kernel_column_counts(dev, n_cols):
    """1 to 7 output columns (repeats allowed), B = 8, a cap that is no
    multiple of the 2,048-item tile, some destinations past it."""
    rng = np.random.default_rng(n_cols)
    args = _probe_args(rng, 8, 3000, 2500, 4099)
    cols = tuple(int(c) for c in rng.integers(0, 6, n_cols))
    _expand_eq(dev, args, cols)
    _expand_eq(dev, args, None)


def test_expand_rows_fused_kernel_long_window(dev):
    """One left row's window spans more than 10 tiles (30,000 slots)."""
    rng = np.random.default_rng(11)
    n_l, n_r = 50, 30000
    counts = np.zeros((2, n_l), np.int32)
    lo = np.zeros((2, n_l), np.int32)
    counts[:, 7] = n_r
    counts[:, 9], lo[:, 9] = 100, 5
    perm = np.stack([rng.permutation(n_r) for _ in range(2)]).astype(np.int32)
    for cap in (30103, 25000):
        args = tuple(torch.from_numpy(x) for x in (
            expand_rows_of(rng, 2, n_l, 2), expand_rows_of(rng, 2, n_r, 3),
            counts, lo, perm)) + (cap,)
        _expand_eq(dev, args, (4, 0, 0, 3))
        _expand_eq(dev, args, None)


def test_expand_rows_fused_kernel_zero_count_rows(dev):
    """2^20 zero-count left rows around a few matches."""
    rng = np.random.default_rng(12)
    n_l, n_r = 1 << 20, 64
    counts = np.zeros((2, n_l), np.int32)
    lo = rng.integers(0, n_r, (2, n_l)).astype(np.int32)
    for i in (0, 4097, 300001, n_l - 1):
        counts[:, i], lo[:, i] = 5, 10
    perm = np.stack([rng.permutation(n_r) for _ in range(2)]).astype(np.int32)
    args = tuple(torch.from_numpy(x) for x in (
        expand_rows_of(rng, 2, n_l, 3), expand_rows_of(rng, 2, n_r, 3),
        counts, lo, perm)) + (37,)
    _expand_eq(dev, args, (0, 1, 4))
    _expand_eq(dev, args, None)


@pytest.mark.parametrize("n,recipe", [
    (1, ((0, 0x9E3779B1, 8, 1),)),
    (1000, ((0, 0x9E3779B1, 1, 4), (1, 0x85EBCA77, 4, 1))),
    (70000, ((0, 0x9E3779B1, 4, 1), (1, 0x85EBCA77, 64, 4))),
    (500, ((1, 0x9E3779B1, 1, 1),))])
def test_route_cells_kernel(dev, n, recipe):
    rows = torch.from_numpy(_rows(np.random.default_rng(n), n, 2, 1 << 20))
    rows = rows.to(dev)
    _eq(ops.route_cells(rows, recipe), rc.route_cells_host(rows, recipe))


@pytest.mark.parametrize("k,m", [(8, 1), (8, 100000), (256, 5000),
                                 (20000, 3000)])
def test_fold_cells_kernel(dev, k, m):
    """dest past the table gives 0; k > 8192 reads the table from device
    memory instead of shared memory."""
    rng = np.random.default_rng(k + m)
    table = torch.from_numpy(rng.integers(0, 8, k).astype(np.int32)).to(dev)
    dest = torch.from_numpy(rng.integers(-1, k + 3, m).astype(np.int32))
    dest = dest.to(dev)
    _eq(ops.fold_cells(dest, table), rc.fold_cells_host(dest, table))


def _bucket_dests(rng, b, m, k, case):
    """dest (b, m) for the bucket cases: `hot` draws from [-1, k + 2) with a
    third of the items in one bucket; `sparse` has about 6 % members (the
    full-size cell's share); `outside` has none; `one_bin` puts every item
    in bucket k // 2; `tile_edges` changes bucket at every tile edge and one
    item either side of it, with every third tile all outside [0, k)."""
    if case == "hot":
        dest = rng.integers(-1, k + 2, (b, m)).astype(np.int32)
        dest[:, : m // 3] = k // 2
    elif case == "sparse":
        dest = np.where(rng.random((b, m)) < 0.06, rng.integers(0, k, (b, m)),
                        -1).astype(np.int32)
    elif case == "outside":
        vals = np.array([-1, k, k + 5, -2**31, 2**31 - 1], np.int32)
        dest = vals[rng.integers(0, len(vals), (b, m))]
    elif case == "one_bin":
        dest = np.full((b, m), k // 2, np.int32)
    else:
        tile = bp.bucket_geometry(k)[0]
        i = np.arange(m)
        dest = np.broadcast_to(((i // tile) % k).astype(np.int32), (b, m))
        edge = i % tile
        dest = np.where((edge == 0) | (edge == tile - 1), (dest + 1) % k, dest)
        dest = np.where((i // tile) % 3 == 2, -1, dest).astype(np.int32)
    return np.ascontiguousarray(dest)


@pytest.mark.parametrize("b,m,k,cap,w,case", [
    pytest.param(1, 0, 8, 4, 3, "hot", id="1-0-8-4"),
    pytest.param(2, 1, 1, 1, 3, "hot", id="2-1-1-1"),
    pytest.param(8, 5000, 8, 700, 3, "hot", id="8-5000-8-700"),
    pytest.param(3, 70000, 33, 100, 3, "hot", id="3-70000-33-100"),
    pytest.param(2, 20000, 256, 200, 3, "hot", id="2-20000-256-200"),
    pytest.param(8, 4_456_448, 8, 131_072, 3, "sparse", id="cell"),
    pytest.param(3, 50_000, 8, 10, 3, "outside", id="outside"),
    pytest.param(2, 40_000, 8, 40_000, 3, "one_bin", id="one-bin-fits"),
    pytest.param(2, 40_000, 8, 9_000, 3, "one_bin", id="one-bin-overflows"),
    pytest.param(2, 9 * 2048, 4, 6_000, 3, "tile_edges", id="tile-edges"),
    pytest.param(3, 3 * 2048 + 77, 8, 400, 3, "hot", id="ragged-m"),
    pytest.param(2, 30_001, 8, 2_000, 1, "hot", id="w1"),
    pytest.param(2, 30_001, 8, 2_000, 9, "hot", id="w9"),
    pytest.param(2, 30_001, 8, 2_000, 25, "hot", id="w25-in-place"),
    pytest.param(2, 60_000, 4096, 5, 3, "hot", id="k4096"),
    pytest.param(2, 60_000, 5000, 5, 3, "hot", id="k5000-in-place"),
    pytest.param(3, 20_000, 8, 1, 3, "hot", id="cap1")])
def test_bucket_rank_and_pack_kernels(dev, b, m, k, cap, w, case):
    """Forced overflow where cap is below the buckets' sizes: the ranks
    must be the plain version's exactly.  `ragged-m` leaves the last tile
    short and rows after the first unaligned for 16-byte loads; k = 4096
    keeps the pack's counters in shared memory while bucket_rank's 4,097
    bins, and every bin of k = 5000, take the warp walk over device
    memory."""
    rng = np.random.default_rng(b * m + k + w)
    dest = torch.from_numpy(_bucket_dests(rng, b, m, k, case)).to(dev)
    rows = torch.from_numpy(rng.integers(0, 1000, (b, m, w))
                            .astype(np.int32)).to(dev)
    for got, want in zip(bp.bucket_rank_cuda(dest, k),
                         bp.bucket_rank_host(dest, k)):
        _eq(got, want)
    for got, want in zip(ops.bucket_pack(dest, rows, k, cap),
                         bp.bucket_pack_host(dest, rows, k, cap)):
        _eq(got, want)


def test_bucket_pack_allocates_no_rank(dev):
    """The pack's scratch is its tile counts and histogram: far below the
    (B, m) int32 rank bucket_rank returns."""
    b, m, k, cap = 4, 1 << 20, 8, 16
    rng = np.random.default_rng(3)
    dest = torch.from_numpy(_bucket_dests(rng, b, m, k, "sparse")).to(dev)
    rows = torch.from_numpy(rng.integers(0, 1000, (b, m, 1))
                            .astype(np.int32)).to(dev)
    bp.bucket_pack_cuda(dest, rows, k, cap)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = bp.bucket_pack_cuda(dest, rows, k, cap)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - before
    assert grown < b * m * 4 // 8, grown
    for got, want in zip(out, bp.bucket_pack_host(dest, rows, k, cap)):
        _eq(got, want)


def _tile_edge_keys(b, n, w):
    """Runs that start at a scan tile's first row, runs of one row at a
    tile's first and last rows, and every third tile without a run start."""
    tile = bpr.seg_tile_rows(w)
    cuts = np.zeros(n, np.int32)
    for e in range(tile, n, tile):
        if (e // tile) % 3 != 2:
            cuts[[e - 1, e, min(e + 1, n - 1)]] = 1
    ids = np.cumsum(cuts, dtype=np.int32)
    return np.ascontiguousarray(np.broadcast_to(ids[None, :, None], (b, n, w)))


@pytest.mark.parametrize("b,n,w,case", [
    (1, 0, 2, "random"), (2, 1, 1, "random"), (3, 2047, 2, "random"),
    (3, 2049, 3, "random"), (8, 100000, 1, "random"), (2, 70000, 2, "long"),
    (2, 5000, 2, "all_equal"), (2, 5000, 2, "all_distinct"),
    # One run across every tile of a 2^22-row batch row: every row's
    # length comes from the trailing-run kernel.
    (1, 1 << 22, 2, "all_equal"),
    # Runs at tiles' edges, at w = 1, 2, 4 and at widths that shrink the
    # tile (9: 512 rows; 33: 256 rows in shared memory; 40: 256 rows read
    # in place).
    (2, 5 * 2048 + 3, 1, "tile_edges"), (2, 5 * 2048 + 3, 2, "tile_edges"),
    (2, 9000, 4, "tile_edges"), (2, 5000, 9, "tile_edges"),
    (2, 3000, 33, "tile_edges"), (2, 3000, 40, "tile_edges"),
    # More tiles than the card holds blocks at once: the look-back under
    # contention.
    (8, (1 << 20) + 1, 2, "random"), (8, (1 << 20) + 1, 1, "long"),
    (3, 50000, 4, "random"), (2, 20000, 9, "long"), (2, 9000, 33, "random"),
    (2, 9000, 40, "long"),
    # Keys holding -2, -3 and INT32_MIN.
    (4, 70000, 2, "sentinels"), (2, 70001, 1, "sentinels")])
def test_segment_scan_kernel(dev, b, n, w, case):
    """Runs that cross the kernel's tiles, ragged last tiles."""
    rng = np.random.default_rng(n + w)
    if case == "all_equal":
        keys = np.zeros((b, n, w), np.int32)
    elif case == "all_distinct":
        keys = np.tile(np.arange(n * w, dtype=np.int32).reshape(1, n, w),
                       (b, 1, 1))
    elif case == "tile_edges":
        keys = _tile_edge_keys(b, n, w)
    elif case == "sentinels":
        vals = np.array([-2**31, -3, -2, 0, 7], np.int32)
        keys = np.sort(vals[rng.integers(0, len(vals), (b, n, w))], axis=1)
    else:
        domain = 3 if case == "long" else max(n // 5, 2)
        keys = np.sort(rng.integers(-3, domain, (b, n, w)).astype(np.int32),
                       axis=1)
    keys = torch.from_numpy(keys).to(dev)
    for got, want in zip(ops.segment_scan(keys), bpr.segment_scan_host(keys)):
        _eq(got, want)
    for got, want in zip(ops.run_lengths(keys), bpr.run_lengths_host(keys)):
        _eq(got, want)


def test_new_kernel_wrappers_reject_shapes_they_do_not_take(dev):
    ops.reset_launches()
    rows = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        rc.route_cells_cuda(rows, ((2, 0x9E3779B1, 4, 1),))   # column 2 of 2
    with pytest.raises(ValueError):
        rc.fold_cells_cuda(rows[:, 0], rows)                 # 2-D table
    with pytest.raises(ValueError):
        bp.bucket_pack_cuda(rows, rows[None], 4, 2)          # (4, 2) vs (1, 4)
    with pytest.raises(ValueError):
        bp.bucket_rank_cuda(rows[0], 4)                      # 1-D dest
    with pytest.raises(ValueError):
        bpr.segment_scan_cuda(rows)                          # 2-D keys
    assert all(v == 0 for v in ops.LAUNCHES.values())


@pytest.mark.parametrize("n,nb", [
    (0, 8), (1, 1), (1, 2), (2047, 128), (2048, 128), (2049, 2),
    (70000, 1 << 14), (70000, 1 << 15), (1 << 21, 128), (1 << 21, 1 << 20),
    (300000, 1)])
def test_hash_partition_kernel(dev, n, nb):
    """Shared-memory counters up to 8,192 bins, device-memory atomics past
    them; block edges at 2,048 keys; nb = 1 takes no shift."""
    rng = np.random.default_rng(n + nb)
    keys = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                            .astype(np.int32)).to(dev)
    for seed in (1, 0x9E3779B1):
        got = ops.hash_partition(keys, seed, nb)
        want = hp.hash_partition_host(keys, seed, nb)
        _eq(got[0], want[0])
        _eq(got[1], want[1])
        assert int(got[1].sum()) == n


def test_hash_partition_kernel_key_dtypes(dev):
    """int16 keys sign-extend, uint32 and int64 keys keep their low 32
    bits: the kernel sees the same bits as the plain version."""
    rng = np.random.default_rng(3)
    base = rng.integers(-2**40, 2**40, 5000, dtype=np.int64)
    base[:4] = [-1, -2, 2**31, 2**32 - 1]
    for keys in (torch.from_numpy(base.astype(np.int16)),
                 torch.from_numpy(base.astype(np.uint32)),
                 torch.from_numpy(base)):
        keys = keys.to(dev)
        for nb in (64, 1 << 16):
            for got, want in zip(ops.hash_partition(keys, 0x85EBCA77, nb),
                                 hp.hash_partition_host(keys, 0x85EBCA77, nb)):
                _eq(got, want)


MATCH_LIM = shared_limit()        # the shared arm's largest build side


def _match_case(rng, n_p, n_b, case):
    if case == "all_equal":
        return np.full(n_p, 7, np.int32), np.full(n_b, 7, np.int32)
    if case == "all_distinct":
        return (rng.permutation(n_p).astype(np.int32),
                rng.permutation(n_b).astype(np.int32))
    if case == "pads":                 # the padding values on both sides
        probe = rng.integers(-2, 3, n_p).astype(np.int32)
        return probe, rng.integers(-2, 3, n_b).astype(np.int32)
    if case == "edge":                 # traps for the empty slot word
        edge = [-2**31, 2**31 - 1, 0, -1, -2]
        return (rng.choice(edge + [5, 6], n_p).astype(np.int32),
                rng.choice(edge + [5], n_b).astype(np.int32))
    if case == "one_slot":             # one partition, one home slot
        keys = np.repeat(keys_with_home(n_b // 2, n_p, n_b, rng), 2)
        probe = np.concatenate([keys, rng.integers(0, 99, n_p)])[:n_p]
        return rng.permutation(probe).astype(np.int32), keys
    if case == "heavy":                # one key n_b times
        probe = rng.choice([-5, 0, 1], n_p).astype(np.int32)
        return probe, np.zeros(n_b, np.int32)
    if case == "spread":               # one key's copies far apart
        build = rng.integers(100, 2**30, n_b).astype(np.int32)
        build[rng.choice(n_b, 300, replace=False)] = 42
        probe = rng.integers(100, 2**30, n_p).astype(np.int32)
        probe[::3] = 42
        return probe, build
    dom = max(n_b // 4, 2)
    return (rng.integers(0, dom, n_p).astype(np.int32),
            rng.integers(0, dom, n_b).astype(np.int32))


@pytest.mark.parametrize("n_p,n_b,case", [
    (0, 5, "random"), (5, 0, "random"), (1, 1, "random"), (1, 1, "pads"),
    (1023, 2047, "random"), (1024, 2048, "random"), (1025, 2049, "pads"),
    (3000, 70001, "random"), (16384, 16384, "random"), (16384, 4096, "pads"),
    (1536, 768, "all_equal"), (5000, 6000, "all_distinct"),
    (200, 300000, "random"),
    (5000, MATCH_LIM, "random"), (5000, MATCH_LIM + 1, "random"),
    (1 << 21, 1 << 21, "random"), (4096, MATCH_LIM, "edge"),
    (4096, 100000, "edge"), (3000, 2000, "one_slot"),
    (5000, 300000, "heavy"), (20000, 16000, "spread"),
    (20000, 1 << 20, "spread"), (1, MATCH_LIM, "random"),
    (1, 1 << 20, "random"), (1 << 21, 3, "random"),
    (300000, MATCH_LIM, "random"), (5000, 4099, "unaligned"),
    (5000, 70001, "unaligned")])
def test_match_kernels(dev, n_p, n_b, case):
    """Both arms of the hash join (a block's table of its partition in
    shared memory up to MATCH_LIM build keys, one table in device memory
    past it): keys on the empty-word traps (INT_MIN, INT_MAX, 0, -1, -2)
    on both sides, build keys that all share one partition and one home
    slot, one key 300,000 times (contended atomics), one key's copies
    spread over many blocks (first_match's least index), n_p far below and
    far above n_b (partitions only, slices only), and a build side that
    starts off a 16-byte boundary (scalar loads)."""
    rng = np.random.default_rng(n_p + n_b)
    if case == "unaligned":
        probe, build = _match_case(rng, n_p, n_b + 1, "random")
        probe = torch.from_numpy(probe).to(dev)
        build = torch.from_numpy(build).to(dev)[1:]
        assert build.data_ptr() % 16
    else:
        probe, build = (torch.from_numpy(x).to(dev)
                        for x in _match_case(rng, n_p, n_b, case))
    assert build.shape[0] == n_b
    _eq(ops.match_counts(probe, build), bpr.match_counts_host(probe, build))
    _eq(ops.first_match(probe, build), bpr.first_match_host(probe, build))


@pytest.mark.parametrize("n_b,arm,want", [
    (4096, bpr.MATCH_SHARED, {"match_shared_kernel"}),
    (70001, bpr.MATCH_DEVICE, {"Memset", "match_insert_kernel",
                               "match_probe_kernel"})])
def test_match_kernels_one_call_a_wrapper_call(dev, monkeypatch, n_b, arm,
                                               want):
    """One wrapper call is one `_build.call`; the shared arm is one kernel
    on the card and no memset, the device arm a memset and two kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    rng = np.random.default_rng(n_b)
    probe, build = (torch.from_numpy(x).to(dev)
                    for x in _match_case(rng, 16384, n_b, "random"))
    assert bpr.match_plan(16384, n_b)[0] == arm
    calls = []
    real = _build.call
    monkeypatch.setattr(_build, "call",
                        lambda *a: calls.append(a[0]) or real(*a))
    for fn in (ops.match_counts, ops.first_match):
        fn(probe, build)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn(probe, build)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.self_device_time_total > 0}
        assert {w for w in want if any(w in n for n in names)} == want
        assert len(names) == len(want), names
    assert calls == ["match_counts_launch"] * 4 + ["first_match_launch"] * 4


def test_match_kernels_refuse_plans_their_arms_do_not_take(dev):
    """A table no larger than the build side, a shared table past its
    bytes, partitions past the limit, a grid that is no whole number of
    them or is empty, partitions on the device arm and an arm that does
    not exist are refused; plans they take give the plain answer, a
    nearly full table included."""
    S, D = bpr.MATCH_SHARED, bpr.MATCH_DEVICE
    probe = torch.arange(100, dtype=torch.int32, device=dev)
    build = torch.arange(0, 600, 3, dtype=torch.int32, device=dev)
    big = bpr.MATCH_SHARED_BYTES // 8 + 1
    for plan in ((S, 200, 0, 1), (S, big, 0, 1), (S, 400, 8, 256),
                 (S, 400, 2, 6), (S, 400, 0, 0), (D, 400, 1, 2),
                 (7, 400, 0, 1)):
        for fn in (bpr.match_counts_cuda, bpr.first_match_cuda):
            with pytest.raises(KernelError):
                fn(probe, build, plan=plan)
    for plan in ((S, 201, 0, 1), (S, 400, 3, 24), (D, 4096, 0, 3)):
        _eq(bpr.match_counts_cuda(probe, build, plan=plan),
            bpr.match_counts_host(probe, build))
        _eq(bpr.first_match_cuda(probe, build, plan=plan),
            bpr.first_match_host(probe, build))


@pytest.mark.parametrize("case", [
    "specs-8-1-4", "specs-64-700-8", "specs-256-2049-300", "one-device-fits",
    "one-device-overflow", "eq-reps-40", "eq-reps-5000", "w5", "w9", "w9000",
    "max-devices", "all-padding", "no-members", "heavy-only", "cell-routes"])
def test_map_pack_kernel_cases(dev, case):
    """map_pack's streams equal route_streams, and its buffer and overflow
    map_pack_host's and scatter_pack's, at the edges of its tiles and
    windows: fewer rows than a tile and ragged last tiles; every cell on
    one device with a cap that fits and one below the counts; fanout above
    32 and a row of 5,002 copies over several 4,096-copy windows; w = 5, 9
    and a tile of one row wider than 8,192 words; the most devices; every
    copy a non-member (padding, or rows every route refuses); only the heavy
    route's members; the cell's route shapes at 8 x 2^18 rows.  One launch
    a call."""
    rng = np.random.default_rng(sum(map(ord, case)))
    rows, specs, ptable, k, n_dev, cap = _scatter_case(case, rng)
    rows = torch.from_numpy(rows).to(dev)
    ptable = torch.from_numpy(ptable.astype(np.int32)).to(dev)
    for routes in specs:
        if rows.shape[1]:
            ops.reset_launches()
            got = mp.map_pack_streams_cuda(rows, routes, ptable, k, n_dev)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["map_pack"] == 1
            for g, want in zip(got, mp.route_streams(rows, routes, ptable, k,
                                                     n_dev)):
                _eq(g, want)
        ops.reset_launches()
        buf, over = ops.map_pack(rows, routes, ptable, k, n_dev, cap)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["map_pack"] == int(rows.shape[1] > 0)
        for want in (mp.map_pack_host(rows, routes, ptable, k, n_dev, cap),
                     sp.scatter_pack_cuda(rows, routes, ptable, k, n_dev,
                                          cap)):
            _eq(buf, want[0])
            _eq(over, want[1])
    if case.endswith("overflow") or case == "eq-reps-5000":
        assert int(over.sum()) > 0
    if case in ("all-padding", "no-members"):
        assert not (buf != -1).any() and not over.any()


def test_map_pack_card_path_allocates_no_index_tensor(dev):
    """The card path holds no (n_src, n_loc·F) int64 index: its peak is the
    int32 streams, the buffer, its slot map (two words a record) and small
    scratch."""
    rng = np.random.default_rng(4)
    rows, specs, ptable, k, n_dev, cap = _scatter_case("specs-64-700-8", rng)
    rows = torch.from_numpy(rows).to(dev)
    ptable = torch.from_numpy(ptable.astype(np.int32)).to(dev)
    routes = specs[0]
    s, n, w = rows.shape
    m = n * mp.route_fanout(routes)
    mp.map_pack_cuda(rows, routes, ptable, k, n_dev, cap)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    buf, _ = mp.map_pack_cuda(rows, routes, ptable, k, n_dev, cap)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    slots = 2 * 4 * buf.numel() // (w + 1)
    assert extra < 3 * 4 * s * m + 4 * buf.numel() + slots + (1 << 20)


def _library_spec(k):
    """The kernel library tests' recipe: a hashed route of fanout 2 with a
    not-in constraint and a two-axis route with an eq constraint (one
    share-1 route of fanout 1 at k = 1)."""
    a, b = 0x9E3779B1, 0x85EBCA77
    if k == 1:
        return ((((0, a, 1, 1),), (0,), 0, (), ()),)
    half, quarter = k // 2, max(k // 4, 1)
    return ((((0, a, half, 1),), (0, half), 0, (), ((1, (7, 13)),)),
            (((0, b, quarter, 1), (2, a, 2, quarter)), (0,), quarter,
             ((1, 7),), ()))


@pytest.mark.parametrize("k,n_dev,n_loc,cap", [
    (1, 1, 1, 4), (8, 4, 700, 8), (256, 8, 5000, 40), (256, 8, 5000, 4096),
    (8, 4, 0, 2), (256, 8, 100000, 20000), (8, 4, 700, 0)])
def test_map_pack_kernel(dev, k, n_dev, n_loc, cap):
    """Streams, buffer and overflow equal the plain version's and the
    buffer equals scatter_pack's; small caps force overflow (cap 0: every
    member copy)."""
    rng = np.random.default_rng(k * n_loc + cap)
    spec = _library_spec(k)
    ptable = torch.from_numpy(rng.integers(0, n_dev, k).astype(np.int32))
    ptable = ptable.to(dev)
    rows = torch.from_numpy(_rows(rng, 3 * n_loc, 3, 50)).to(dev)
    rows = rows.view(3, n_loc, 3)
    if n_loc:
        for got, want in zip(mp.map_pack_streams_cuda(rows, spec, ptable, k,
                                                      n_dev),
                             mp.route_streams(rows, spec, ptable, k, n_dev)):
            _eq(got, want)
    buf, over = ops.map_pack(rows, spec, ptable, k, n_dev, cap)
    for want in (mp.map_pack_host(rows, spec, ptable, k, n_dev, cap),
                 ops.scatter_pack(rows, spec, ptable, k, n_dev, cap)):
        _eq(buf, want[0])
        _eq(over, want[1])
    if cap <= 40 and n_loc >= 700:
        assert int(over.sum()) > 0


def test_library_wrappers_reject_shapes_and_dtypes_they_do_not_take(dev):
    ops.reset_launches()
    keys = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        hp.hash_partition_cuda(keys, 1, 8)                   # 2-D keys
    with pytest.raises(ValueError):
        hp.hash_partition_cuda(keys[:, 0], 1, 12)            # not 2^b
    with pytest.raises(TypeError):
        hp.hash_partition_cuda(keys[:, 0].float(), 1, 8)     # float keys
    with pytest.raises(ValueError):
        bpr.match_counts_cuda(keys, keys[:, 0])              # 2-D probe
    with pytest.raises(ValueError):
        bpr.first_match_cuda(keys[:, 0], keys)               # 2-D build
    with pytest.raises(TypeError):
        bpr.match_counts_cuda(keys[:, 0].float(), keys[:, 0])
    spec = _library_spec(8)
    with pytest.raises(ValueError):
        mp.map_pack_cuda(keys, spec, keys[:, 0], 8, 4, 4)    # 2-D rows
    rows = torch.zeros((2, 4, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        mp.map_pack_cuda(rows, spec, keys[:, 0], 8, 4, 4)    # (4,) table
    table = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        mp.map_pack_cuda(rows, spec, table, 8, mp.MAX_PACK_BINS, 4)
    with pytest.raises(ValueError):
        mp.map_pack_streams_cuda(rows, spec, table, 8, 0)    # no device
    with pytest.raises(ValueError):
        mp.map_pack_cuda(rows, spec, table, 8, 4, -1)        # cap < 0
    with pytest.raises(KernelError):
        mp.map_pack_cuda(rows.float(), spec, table, 8, 4, 4)
    assert all(v == 0 for v in ops.LAUNCHES.values())


# Kernels each ExecutorConfig arm launches (prepare counts, k > n_dev).
ARM_KERNELS = {
    (True, True): {"map_count", "scatter_pack", "join_hash", "build_table",
                   "probe_tables", "expand_rows"},
    (True, False): {"map_count", "scatter_pack", "segment_scan",
                    "expand_rows"},
    (False, True): {"route_cells", "fold_cells", "bucket_pack", "join_hash",
                    "build_table", "probe_tables", "expand_rows"},
    (False, False): {"route_cells", "fold_cells", "bucket_pack",
                     "segment_scan", "expand_rows"},
}


def expected_launches(ex, chunks: int = 1, prepare: bool = True
                      ) -> dict[str, int]:
    """chip_smoke.py's exact launches on `ex`'s arm of one prepare and a
    key's first run_batch, which runs the step eagerly; with
    `prepare=False`, of one pass through the step alone (the key's second
    run_batch, which captures it)."""
    return CHIP_SMOKE.expected_launches(
        ex, {"fuse_map": ex.config.fuse_map,
             "hash_reduce": ex.config.hash_reduce}, chunks, prepare)


@pytest.mark.parametrize("fuse_map,hash_reduce", list(ARM_KERNELS))
@pytest.mark.parametrize("q,skew,k", [
    (two_way(), {"B": 1.5}, 64),
    (running_example(), {"B": 1.2, "C": 1.2}, 256),
    (chain_query(4), {"X2": 1.2}, 64),
])
def test_executor_on_card(dev, q, skew, k, fuse_map, hash_reduce):
    """Each arm launches exactly its hand kernels (the counting pass and
    one eager step: a key's first batch), the plain versions none."""
    data = skewed_join_dataset(q, 200, 60, skew=skew, seed=3)
    plan = plan_skew_join(q, data, k)
    results = []
    for use_kernels in (True, False):
        cfg = ExecutorConfig(out_capacity=1 << 17, use_kernels=use_kernels,
                             fuse_map=fuse_map, hash_reduce=hash_reduce)
        ops.reset_launches()
        ex = ShardedJoinExecutor(plan, 8, cfg, device=dev)
        res = ex.session().prepare(data).run_batch()
        assert res["shuffle_overflow"].sum() == 0
        assert res["join_overflow"].sum() == 0
        results.append(res)
        launched = {name for name in ops.KERNELS if ops.LAUNCHES[name] > 0}
        want = ARM_KERNELS[fuse_map, hash_reduce] if use_kernels else set()
        assert launched == want, ops.LAUNCHES
        if use_kernels:
            assert ops.LAUNCHES == expected_launches(ex)
    kern, plain = results
    for key in kern:
        np.testing.assert_array_equal(kern[key], plain[key])
    np.testing.assert_array_equal(
        canonical(kern["rows"][kern["valid"]]), reference_join(q, data))


@pytest.mark.parametrize("n", [1, 16, 2047, 2048, 2049, 16384, 300001])
@pytest.mark.parametrize("n_bins", [1, 8, 384, 12288, 12289, 65536])
def test_segment_histogram_kernel(dev, n, n_bins):
    """int64 values in [-3, n_bins + 3) on both arms: shared counters up to
    12,288 bins, device atomics past them."""
    rng = np.random.default_rng(n + n_bins)
    vals = torch.from_numpy(rng.integers(-3, n_bins + 3, n)).to(dev)
    assert vals.dtype == torch.int64
    ops.reset_launches()
    got = ops.segment_histogram(vals, n_bins)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["segment_histogram"] == 1
    _eq(got, sh.segment_histogram_host(vals, n_bins))
    assert got.dtype == torch.int32


def _hist_arm_cases():
    """(n, n_bins) at each arm's edges: one block up to its threshold and
    one value past it; 12,288 and 12,289 bins (one block's counters, the
    cluster's); 2^16 bins with one cluster and with several; a cluster's
    bins and one past them (device atomics)."""
    one, shared = sh.ONE_BLOCK_VALUES, sh.SHARED_BINS
    cluster = sh.CLUSTER_BLOCKS * sh.CLUSTER_BLOCK_BINS
    return [(1, 8), (16, 8), (one, 8), (one + 1, 8), (one, shared),
            (one + 1, shared), (5, shared + 1), (1 << 20, shared + 1),
            (1, 1 << 16), (1 << 22, 1 << 16), (300001, cluster),
            (300001, cluster + 1)]


@pytest.mark.parametrize("n,n_bins", _hist_arm_cases())
@pytest.mark.parametrize("values", ["random", "one bin", "out of range"])
def test_segment_histogram_kernel_arms(dev, n, n_bins, values):
    """Every arm equals the plain version with values spread over the bins
    and the padding around them, all in one bin, and all out of range; one
    launch a call."""
    rng = np.random.default_rng(n + n_bins)
    if values == "random":
        v = rng.integers(-3, n_bins + 3, n)
    elif values == "one bin":
        v = np.full(n, n_bins - 1)
    else:
        v = rng.choice([-1, -5, n_bins, n_bins + 9], n)
    vals = torch.from_numpy(v.astype(np.int32)).to(dev)
    ops.reset_launches()
    got = ops.segment_histogram(vals, n_bins)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["segment_histogram"] == 1
    _eq(got, sh.segment_histogram_host(vals, n_bins))
    if values == "out of range":
        assert not got.any()


def test_segment_histogram_kernel_refuses_plans_its_arms_do_not_take(dev):
    vals = torch.arange(100, dtype=torch.int32, device=dev)
    for n_bins, plan in (
            (8, (sh.SH_ONE, 2, 32)),                          # one block
            (sh.SHARED_BINS + 1, (sh.SH_ONE, 1, 128)),        # past it
            (sh.SHARED_BINS + 1, (sh.SH_GRID, 4, 256)),       # past shared
            (1 << 16, (sh.SH_CLUSTER, 12, 512)),              # part cluster
            (1 << 16, (sh.SH_CLUSTER, 8, 1024)),              # 1,024 threads
            (sh.CLUSTER_BLOCKS * sh.CLUSTER_BLOCK_BINS + 1,
             (sh.SH_CLUSTER, 8, 512)),                        # past a cluster
            (8, (sh.SH_GRID, 4, 48)),                         # 48 threads
            (8, (7, 1, 32))):                                 # no such arm
        with pytest.raises(KernelError):
            sh.segment_histogram_cuda(vals, n_bins, plan=plan)


def test_segment_histogram_kernel_edges(dev):
    """Every value in one bin, all out of range, other integer dtypes, a
    2-D input, and an empty one (zeros, no launch)."""
    hot = torch.full((1 << 20,), 5, dtype=torch.int32, device=dev)
    _eq(ops.segment_histogram(hot, 8), sh.segment_histogram_host(hot, 8))
    out = torch.tensor([-1, 8, 9, -7] * 1000, dtype=torch.int32, device=dev)
    assert not ops.segment_histogram(out, 8).any()
    for dtype in (torch.int8, torch.int16, torch.uint8):
        v = torch.arange(-5, 300, device=dev).to(dtype)
        _eq(ops.segment_histogram(v, 128), sh.segment_histogram_host(v, 128))
    v2 = torch.randint(-2, 20, (7, 9, 11), device=dev)
    _eq(ops.segment_histogram(v2, 16), sh.segment_histogram_host(v2, 16))
    ops.reset_launches()
    empty = ops.segment_histogram(torch.empty(0, dtype=torch.int32,
                                              device=dev), 8)
    assert ops.LAUNCHES["segment_histogram"] == 0
    _eq(empty, torch.zeros(8, dtype=torch.int32))


def test_segment_histogram_wrapper_rejects_what_it_does_not_take(dev):
    for bad in (torch.zeros(4, device=dev), torch.zeros(4, dtype=torch.bool,
                                                        device=dev)):
        with pytest.raises(TypeError):
            ops.segment_histogram(bad, 8)
    with pytest.raises(ValueError):
        ops.segment_histogram(torch.arange(4, device=dev), 0)


def test_reduced_moe_forward_on_card(dev):
    """The reduced mixtral in bf16 on the card: expert loads with the kernel
    equal those of the plain version, one launch per layer."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    cfg = ARCHS["mixtral-8x22b"].reduced()
    model = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    toks = torch.randint(0, cfg.vocab, (3, 40), device=dev)
    ops.reset_launches()
    lg, aux = api.forward(model, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    assert ops.LAUNCHES["segment_histogram"] == cfg.n_layers
    model.use_kernels = False
    lg_p, aux_p = api.forward(model, cfg, {"tokens": toks})
    assert ops.LAUNCHES["segment_histogram"] == cfg.n_layers
    assert torch.equal(aux["expert_load"], aux_p["expert_load"])
    assert int(aux["expert_load"].sum()) == 3 * 40 * 2 * cfg.n_layers
    assert torch.isfinite(lg).all() and torch.isfinite(lg_p).all()


def _f32_mixtral(dev, zero_router=False, **changes):
    """(cfg, CPU model, card model) of the reduced mixtral in float32 with
    the same weights on both devices."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    cfg = dataclasses.replace(ARCHS["mixtral-8x22b"].reduced(), **changes)
    tree = init_params(api.layout(cfg), torch.Generator().manual_seed(0),
                       device="cpu", dtype=torch.float32)
    if zero_router:
        tree["blocks"]["moe"]["router"].zero_()

    def to_card(t):
        return t.to(dev) if torch.is_tensor(t) else {k: to_card(v)
                                                     for k, v in t.items()}
    return cfg, api.build(cfg, tree), api.build(cfg, to_card(tree))


@pytest.mark.parametrize("zero_router", [False, True],
                         ids=["random_router", "zeroed_router"])
def test_reduced_moe_f32_on_card_equals_its_cpu_run(dev, zero_router):
    """Float32 on the card against the port's CPU run (which the CPU tests
    hold equal to JAX): expert loads, dropped tokens and greedy tokens.  A
    zeroed router ties every gate: the card must pick experts 0 and 1."""
    from repro_torch.models import api, moe
    cfg, cpu, card = _f32_mixtral(dev, zero_router)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (3, 40)))
    lg, aux = api.forward(cpu, cfg, {"tokens": toks})
    lg_c, aux_c = api.forward(card, cfg, {"tokens": toks.to(dev)})
    _eq(aux_c["expert_load"], aux["expert_load"])
    _eq(lg_c.argmax(-1), lg.argmax(-1))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    plan = moe.build_plan(cfg)
    _, st = moe.moe_ffn(cpu.blocks[0].moe, cfg, plan, x)
    _, st_c = moe.moe_ffn(card.blocks[0].moe, cfg, plan, x.to(dev))
    _eq(st_c["expert_load"], st["expert_load"])
    assert int(st_c["dropped_tokens"]) == int(st["dropped_tokens"])
    if zero_router:
        assert st_c["expert_load"][:2].tolist() == [128, 128]
        assert int(aux_c["expert_load"][2:].sum()) == 0


def test_reduced_moe_f32_decode_across_a_window_on_card(dev):
    """Prefill 3 tokens, then 6 greedy decode steps past a sliding window of
    4 on the card: the same greedy tokens as the CPU run."""
    from repro_torch.models import api
    cfg, cpu, card = _f32_mixtral(dev, sliding_window=4)
    B, S, Smax = 2, 3, 12
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    cache = api.init_cache(cfg, B, Smax, torch.float32, device="cpu")
    cache_c = api.init_cache(cfg, B, Smax, torch.float32, device=dev)
    lg, cache = api.prefill(cpu, cfg, {"tokens": toks}, cache)
    lg_c, cache_c = api.prefill(card, cfg, {"tokens": toks.to(dev)}, cache_c)
    nxt = lg[:, -1].argmax(-1).to(torch.int32)
    _eq(lg_c[:, -1].argmax(-1).to(torch.int32), nxt)
    for step in range(6):
        pos = torch.full((B,), S + step, dtype=torch.int32)
        lg, cache = api.decode_step(cpu, cfg, cache, {"tokens": nxt[:, None]},
                                    pos)
        lg_c, cache_c = api.decode_step(card, cfg, cache_c,
                                        {"tokens": nxt[:, None].to(dev)},
                                        pos.to(dev))
        nxt = lg[:, -1].argmax(-1).to(torch.int32)
        _eq(lg_c[:, -1].argmax(-1).to(torch.int32), nxt)
    assert S + 5 >= cfg.sliding_window + 4


def test_reduced_moe_train_step_on_card_equals_its_cpu_run(dev):
    """Three train steps of the float32 reduced mixtral with 8-bit states
    (remat="full") on the card against the same steps on the CPU: loss,
    zloss and grad_norm within rtol 1e-4 (the card sums in other orders),
    lr_scale within 1e-7, expert_load and `step` equal; segment_histogram
    launched twice a layer (the forward and its recompute) by each host
    pass that launches kernels: the eager first step and the capture of
    the second (the replays of the second and third launch it from the
    graph)."""
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import build_train_step
    cfg, cpu, card = _f32_mixtral(dev)
    assert cfg.remat == "full"
    ocfg = AdamWConfig(lr=1e-2, state_bits=8)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    runs = {}
    for name, model, device in (("cpu", cpu, "cpu"), ("card", card, dev)):
        fns = build_train_step(cfg, ocfg, device=device, total_steps=10,
                               warmup_steps=1)
        opt = adamw.init(model.tree(), ocfg)
        ops.reset_launches()
        ms = []
        for _ in range(3):
            model, opt, m = fns.step(model, opt, batch)
            ms.append({k: v.cpu() for k, v in m.items()})
        torch.cuda.synchronize()
        runs[name] = (ms, dict(ops.LAUNCHES), int(opt["step"]))
        passes = fns.compiled.eager_calls + fns.compiled.captures
    (cpu_ms, cpu_l, cpu_step), (card_ms, card_l, card_step) = (
        runs["cpu"], runs["card"])
    assert cpu_l["segment_histogram"] == 0
    assert passes == 2
    assert card_l["segment_histogram"] == passes * 2 * cfg.n_layers
    assert cpu_step == card_step == 3
    for a, b in zip(card_ms, cpu_ms):
        for k in ("loss", "zloss", "grad_norm"):
            assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-4), k
        assert float(a["lr_scale"]) == pytest.approx(float(b["lr_scale"]),
                                                     abs=1e-7)
        _eq(a["expert_load"], b["expert_load"])


# The ssm, hybrid, encdec and vlm families at reduced size in float32: the
# stock reduced configs, and zamba2 / the vision model at 7 layers, which
# apply the shared block and the cross-attention the stock ones skip.
FAMILY_CASES = {"mamba2-370m": {}, "zamba2-7b": {"n_layers": 7,
                                                 "attn_every": 2},
                "seamless-m4t-medium": {},
                "llama-3.2-vision-90b": {"n_layers": 7,
                                         "cross_attn_every": 2}}


def _f32_family(dev, name):
    """(cfg, CPU model, card model) with the same float32 weights: the
    layout's init plus noise, and values off the zeros / ones init in the
    SSM leaves and the vision gate (as the CPU tests' random leaves)."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(ARCHS[name].reduced(),
                              **FAMILY_CASES.get(name, {}))
    g = torch.Generator().manual_seed(0)
    tree = init_params(api.layout(cfg), g, device="cpu", dtype=torch.float32)
    ranges = {"A_log": (-2.0, 1.0), "dt_bias": (-1.0, 1.0), "D": (0.5, 1.5),
              "gate": (0.3, 0.9)}

    def leaves(t):
        for k, v in t.items():
            if isinstance(v, dict):
                leaves(v)
            elif k in ranges:
                lo, hi = ranges[k]
                v.uniform_(lo, hi, generator=g)
            else:
                v.add_(0.05 * torch.randn(v.shape, generator=g))

    leaves(tree)
    return (cfg, api.build(cfg, tree),
            api.build(cfg, tree_map(lambda t: t.to(dev, copy=True), tree)))


def _family_batch(cfg, B, S, seed):
    from repro_torch.launch.train import frontend_shapes
    g = torch.Generator().manual_seed(seed)
    out = {k: torch.randint(0, cfg.vocab, (B, S), generator=g,
                            dtype=torch.int32) for k in ("tokens", "labels")}
    for k, shape in frontend_shapes(cfg, B, S).items():
        out[k] = torch.randn(shape, generator=g)
    return out


def _close(a, b, tol=1e-4):
    torch.testing.assert_close(a.cpu(), b.cpu(), atol=tol, rtol=tol)


@pytest.mark.parametrize("name", list(FAMILY_CASES))
def test_family_f32_forward_on_card_equals_its_cpu_run(dev, name):
    from repro_torch.models import api
    cfg, cpu, card = _f32_family(dev, name)
    b = _family_batch(cfg, 2, 40, 1)
    lg, _ = api.forward(cpu, cfg, b)
    lg_c, _ = api.forward(card, cfg, {k: v.to(dev) for k, v in b.items()})
    _close(lg_c, lg)


@pytest.mark.parametrize("name", list(FAMILY_CASES))
def test_family_f32_decode_on_card_equals_its_cpu_run(dev, name):
    """A prefill of 4 tokens (encdec: k, v and enc_out filled; vlm: the
    vision tokens), then 6 greedy decode steps; zamba2 at max_seq 6, so
    its shared block's ring (6 slots) wraps.  Logits and every cache leaf
    within 1e-4 of the CPU run's, the same greedy tokens."""
    from repro_torch.models import api
    from repro_torch.tree import flatten
    cfg, cpu, card = _f32_family(dev, name)
    B, S, Smax = 2, 4, 6 if cfg.family == "hybrid" else 12
    b = _family_batch(cfg, B, S, 2)
    del b["labels"]
    cache = api.init_cache(cfg, B, Smax, torch.float32, device="cpu")
    cache_c = api.init_cache(cfg, B, Smax, torch.float32, device=dev)
    lg, cache = api.prefill(cpu, cfg, b, cache)
    lg_c, cache_c = api.prefill(card, cfg, {k: v.to(dev) for k, v in
                                            b.items()}, cache_c)
    _close(lg_c, lg)
    nxt = lg[:, -1].argmax(-1).to(torch.int32)
    for step in range(6):
        pos = torch.full((B,), S + step, dtype=torch.int32)
        lg, cache = api.decode_step(cpu, cfg, cache, {"tokens": nxt[:, None]},
                                    pos)
        lg_c, cache_c = api.decode_step(card, cfg, cache_c,
                                        {"tokens": nxt[:, None].to(dev)},
                                        pos.to(dev))
        _close(lg_c, lg)
        nxt = lg[:, -1].argmax(-1).to(torch.int32)
        _eq(lg_c[:, -1].argmax(-1).to(torch.int32), nxt)
    got, want = flatten(cache_c), flatten(cache)
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is not None:
            _close(got[k], want[k])


@pytest.mark.parametrize("name", list(FAMILY_CASES))
def test_family_f32_train_step_on_card_equals_its_cpu_run(dev, name):
    """One train step (remat "full", float32 states): loss, zloss and
    grad_norm within rtol 1e-4.  (The updated parameters are not compared:
    AdamW's first step moves an element by lr·g/(|g| + eps), and where
    |g| is near eps the card's other summation order can move it by more
    than 1e-4 at lr 1e-2.)"""
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import build_train_step
    cfg, cpu, card = _f32_family(dev, name)
    assert cfg.remat == "full"
    ocfg = AdamWConfig(lr=1e-2)
    b = _family_batch(cfg, 2, 24, 3)
    runs = {}
    for label, model, device in (("cpu", cpu, "cpu"), ("card", card, dev)):
        fns = build_train_step(cfg, ocfg, device=device, total_steps=10,
                               warmup_steps=0)
        opt = adamw.init(model.tree(), ocfg)
        model, opt, m = fns.step(model, opt, b)
        runs[label] = ({k: v.cpu() for k, v in m.items()}, int(opt["step"]))
    (m_cpu, s_cpu), (m_card, s_card) = runs["cpu"], runs["card"]
    assert s_cpu == s_card == 1
    for k in ("loss", "zloss", "grad_norm"):
        assert float(m_card[k]) == pytest.approx(float(m_cpu[k]), rel=1e-4), k


# -- the captured serve steps --------------------------------------------------

# The six families at reduced size in float32 (_f32_family's weights): the
# dense and MoE ones stock, the others as FAMILY_CASES has them.
GRAPH_CASES = ["qwen2-0.5b", "mixtral-8x22b", *FAMILY_CASES]


def _card_cache(cfg, B, Smax, seed):
    """A float32 cache on the card, its cross-attention source (encdec's
    enc_out, vlm's vis) filled with values, so decode reads it."""
    from repro_torch.models import api
    cache = api.init_cache(cfg, B, Smax, torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    for key in ("enc_out", "vis"):
        if key in cache:
            cache[key].normal_(generator=g)
    return cache


def _clone_tree(t):
    if isinstance(t, dict):
        return {k: _clone_tree(v) for k, v in t.items()}
    return None if t is None else t.clone()


def _plain_decode(model, cfg, cache, toks, pos):
    """The eager step on the card with the plain versions (the oracle)."""
    from repro_torch.models import api
    model.use_kernels = False
    try:
        lg, _ = api.decode_step(model, cfg, cache, {"tokens": toks.cuda()},
                                pos.cuda())
    finally:
        model.use_kernels = True
    return lg[:, -1].argmax(-1).to(torch.int32)


def _same_tree(a, b):
    from repro_torch.tree import flatten
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert (fa[k] is None) == (fb[k] is None), k
        if fa[k] is not None:
            assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("name", GRAPH_CASES)
def test_graph_decode_equals_eager_on_card(dev, name):
    """Eight greedy steps through `build_decode_step` on the card (the
    first eager, the second captured, six replays) against the eager step
    on the plain versions: `torch.equal` tokens every step and every cache
    leaf after (zamba2's ring of 6 slots wraps); the MoE histogram
    launched from the host at the eager call and the capture only."""
    from repro_torch.serve import build_decode_step
    cfg, _, card = _f32_family(dev, name)
    B, Smax = 2, 6 if cfg.family == "hybrid" else 12
    fns = build_decode_step(cfg, B, Smax, device=dev)
    cache = _card_cache(cfg, B, Smax, 1)
    want_cache = _clone_tree(cache)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, 1)).astype(np.int32))
    ops.reset_launches()
    for step in range(8):
        pos = torch.full((B,), step, dtype=torch.int32)
        nxt, got = fns.decode(card, cache, toks, pos)
        want = _plain_decode(card, cfg, want_cache, toks, pos)
        assert got is cache and nxt.dtype == torch.int32
        _eq(nxt, want)
        toks = want[:, None].cpu()
    torch.cuda.synchronize()
    _same_tree(cache, want_cache)
    assert (fns.eager_calls, fns.captures, fns.replays) == (1, 1, 7)
    layers = cfg.n_layers if cfg.family == "moe" else 0
    assert ops.LAUNCHES["segment_histogram"] == 2 * layers


def test_dryrun_predicts_a_decode_cells_peak(dev):
    """The dry run's total_per_device of qwen2-0.5b's decode step at full
    depth (32 slots, an 8,192-position cache: 3.2 GB of bf16 keys and
    values) within ±10 % of the measured peak over the weights, the cache
    and one eager tick of the plain versions."""
    from repro_torch.configs import ARCHS, ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.models import api
    from repro_torch.serve import build_decode_step
    cfg, B, S = ARCHS["qwen2-0.5b"], 32, 8192
    want = dryrun.size(cfg, ShapeCell("decode_8k", S, B, "decode"))[
        "memory"]["total_per_device"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    model.use_kernels = False
    fns = build_decode_step(cfg, B, S, device=dev)
    cache = api.init_cache(cfg, B, S, device=dev)
    toks = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    fns.decode(model, cache, toks, pos)
    torch.cuda.synchronize()
    got = torch.cuda.max_memory_allocated() - base
    assert abs(want / got - 1) <= 0.10, (want, got)


@pytest.mark.parametrize("name", GRAPH_CASES)
def test_graph_engine_gives_the_eager_engines_tokens(dev, name):
    """Seven requests on three slots: the engine on the graph and one on
    the eager step of the plain versions (`use_kernels=False`), the same
    tokens for every request."""
    from repro_torch.serve import ServingEngine, build_decode_step
    cfg, _, card = _f32_family(dev, name)
    rng = np.random.default_rng(5)
    requests = [(rng.integers(0, cfg.vocab, n).tolist(), int(m))
                for n, m in zip(rng.integers(1, 6, 7), rng.integers(2, 9, 7))]
    outs = {}
    for graph in (True, False):
        fns = build_decode_step(cfg, 3, 24, device=dev)
        eng = ServingEngine(cfg, 3, 24, card, fns, device=dev)
        reqs = [eng.submit(p, m) for p, m in requests]
        card.use_kernels = graph
        try:
            eng.run()
        finally:
            card.use_kernels = True
        assert all(r.done and len(r.out) == m
                   for r, (_, m) in zip(reqs, requests))
        outs[graph] = [r.out for r in reqs]
        assert fns.captures == int(graph)
        assert fns.replays == (eng.ticks - 1 if graph else 0)
    assert outs[True] == outs[False]


@pytest.mark.parametrize("name", ["seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_graph_decode_recaptures_on_other_tensors(dev, name):
    """A call with another cache, or after `api.prefill` replaced the
    cache's enc_out (encdec) or vis (vlm), runs eagerly and its next call
    captures anew; the old graph is freed, and every call's tokens equal
    the plain eager step's."""
    import weakref
    from repro_torch.models import api
    from repro_torch.serve import build_decode_step
    cfg, _, card = _f32_family(dev, name)
    B, Smax = 2, 12
    fns = build_decode_step(cfg, B, Smax, device=dev)
    caches = {"a": _card_cache(cfg, B, Smax, 1),
              "b": _card_cache(cfg, B, Smax, 2)}
    want = {k: _clone_tree(c) for k, c in caches.items()}
    step = {"a": 0, "b": 0}
    toks = torch.tensor([[3], [11]], dtype=torch.int32)

    def call(k):
        pos = torch.full((B,), step[k], dtype=torch.int32)
        step[k] += 1
        nxt, _ = fns.decode(card, caches[k], toks, pos)
        _eq(nxt, _plain_decode(card, cfg, want[k], toks, pos))
        return (fns.eager_calls, fns.captures, fns.replays)

    assert [call("a") for _ in range(3)] == [(1, 0, 0), (1, 1, 1), (1, 1, 2)]
    old = weakref.ref(fns.compiled.graph)
    assert call("b") == (2, 1, 2)           # another cache: eager
    assert old() is None
    assert call("b") == (2, 2, 3)           # captured anew
    assert call("a") == (3, 2, 3)           # back: eager again
    b = _family_batch(cfg, B, 4, 3)
    del b["labels"]
    b = {k: v.cuda() for k, v in b.items()}
    for cache in (caches["a"], want["a"]):
        api.prefill(card, cfg, b, cache)     # replaces enc_out / vis
    step["a"] = 4
    assert call("a") == (4, 2, 3)
    assert call("a") == (4, 3, 4)
    assert call("a") == (4, 3, 5)
    _same_tree(caches["a"], want["a"])


# -- the captured train step ----------------------------------------------------

# (name, n_micro, AdamW state bits): the three families of the train graph's
# card test, at reduced size in float32 (_f32_family's weights).
TRAIN_GRAPH_CASES = [("qwen2-0.5b", 2, 32), ("mixtral-8x22b", 1, 8),
                     ("mamba2-370m", 1, 32)]


def _train_run(dev, name, n_micro, bits, graph, steps=3, model=None,
               opt=None, fns=None):
    """`steps` train steps on the card of `model` (a fresh _f32_family one
    by default), on the graph (`use_kernels`) or eagerly on the plain
    versions, each step on a batch of its own: (model, opt, fns, each
    step's metrics on the host)."""
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import build_train_step
    if model is None:
        _, _, model = _f32_family(dev, name)
    cfg = model.cfg
    ocfg = AdamWConfig(lr=1e-2, state_bits=bits)
    opt = adamw.init(model.tree(), ocfg) if opt is None else opt
    fns = fns or build_train_step(cfg, ocfg, n_micro=n_micro, device=dev,
                                  total_steps=10, warmup_steps=1)
    model.use_kernels = graph
    ms = []
    try:
        for i in range(steps):
            b = _family_batch(cfg, 4, 16, 10 + int(opt["step"]))
            model, opt, m = fns.step(model, opt, b)
            ms.append({k: v.cpu() for k, v in m.items()})
    finally:
        model.use_kernels = True
    torch.cuda.synchronize()
    return model, opt, fns, ms


def _same_run(a, b):
    """Two runs' metrics every step and their final parameters and states:
    bit for bit."""
    from repro_torch.tree import flatten
    (ma, oa, _, msa), (mb, ob, _, msb) = a, b
    for x, y in zip(msa, msb):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for fa, fb in ((flatten(ma.tree()), flatten(mb.tree())),
                   (flatten(oa), flatten(ob))):
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("name,n_micro,bits", TRAIN_GRAPH_CASES)
def test_graph_train_step_equals_eager_on_card(dev, name, n_micro, bits):
    """Three steps through `build_train_step` on the card (the first
    eager, the second captured, the third a replay, each on a batch of its
    own) against the eager step on the plain versions: the same losses,
    grad_norm, lr_scale and expert_load every step, and the same
    parameters and optimizer states after, bit for bit.  Two eager runs
    first show that the eager step repeats itself bit for bit.  The graph
    step replaces none of the tensors it was given; the MoE histogram is
    launched from the host by the eager step and the capture only."""
    eager = _train_run(dev, name, n_micro, bits, False)
    _same_run(eager, _train_run(dev, name, n_micro, bits, False))
    assert (eager[2].compiled.eager_calls, eager[2].compiled.captures) == \
        (3, 0)
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.tree import flatten
    cfg, _, card = _f32_family(dev, name)
    opt = adamw.init(card.tree(), AdamWConfig(lr=1e-2, state_bits=bits))
    given = [(t, t.data_ptr()) for t in [*card.parameters(),
                                         *flatten(opt).values()]]
    ops.reset_launches()
    graph = _train_run(dev, name, n_micro, bits, True, model=card, opt=opt)
    c = graph[2].compiled
    assert (c.eager_calls, c.captures, c.replays) == (1, 1, 2)
    now = [*card.parameters(), *flatten(opt).values()]
    assert all(a is t and t.data_ptr() == p for (t, p), a in zip(given, now))
    assert int(opt["step"]) == 3
    layers = cfg.n_layers if cfg.family == "moe" else 0
    assert ops.LAUNCHES["segment_histogram"] == 2 * 2 * layers
    _same_run(graph, eager)


def test_graph_train_step_recaptures_on_a_restored_model(dev, tmp_path):
    """Three graph steps, a checkpoint, the model and state restored from
    it (new tensors): the restored model's first step runs eagerly and
    frees the old graph, its second captures anew, its third replays; all
    six steps equal an eager run's on the plain versions, bit for bit."""
    import weakref
    from repro_torch.ckpt import Checkpointer
    from repro_torch.models import api
    name, n_micro, bits = TRAIN_GRAPH_CASES[0]
    eager = _train_run(dev, name, n_micro, bits, False, steps=6)
    model, opt, fns, ms = _train_run(dev, name, n_micro, bits, True)
    old = weakref.ref(fns.compiled.graph)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"params": model.tree(), "opt": opt}, blocking=True)
    # The abstract tree is the float32 run's own (the step's abstract
    # parameters are bf16).
    state = ck.restore(3, {"params": model.tree(), "opt": opt}, dev)
    model = api.build(model.cfg, state["params"])
    model, opt, fns, more = _train_run(dev, name, n_micro, bits, True,
                                       steps=1, model=model,
                                       opt=state["opt"], fns=fns)
    assert old() is None
    c = fns.compiled
    assert (c.eager_calls, c.captures, c.replays) == (2, 1, 2)
    model, opt, fns, rest = _train_run(dev, name, n_micro, bits, True,
                                       steps=2, model=model, opt=opt,
                                       fns=fns)
    assert (c.eager_calls, c.captures, c.replays) == (2, 2, 4)
    _same_run((model, opt, fns, ms + more + rest), eager)


def test_checkpoint_of_card_tensors_round_trips(dev, tmp_path):
    """bf16, int8, float32 and a scalar int32 saved from the card restore
    bit for bit onto the card and onto the CPU."""
    from repro_torch.ckpt import Checkpointer
    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"p": torch.randn(3, 5, generator=g, device=dev).to(torch.bfloat16),
            "mu": {"m_q": torch.randint(-127, 128, (3, 5), generator=g,
                                        device=dev).to(torch.int8),
                   "m_s": torch.rand(3, 1, generator=g, device=dev)},
            "step": torch.tensor(11, dtype=torch.int32, device=dev)}
    ck = Checkpointer(str(tmp_path))
    ck.save(11, tree)
    ck.wait()
    abstract = {"p": tree["p"], "mu": tree["mu"], "step": tree["step"]}
    for device in (dev, "cpu"):
        got = ck.restore(11, abstract, device)
        for a, b in ((got["p"], tree["p"]), (got["step"], tree["step"]),
                     (got["mu"]["m_q"], tree["mu"]["m_q"]),
                     (got["mu"]["m_s"], tree["mu"]["m_s"])):
            assert a.device.type == torch.device(device).type
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


def _healing_case(k=32):
    q = two_way()
    data = skewed_join_dataset(q, 2000, 500, skew={"B": 1.2}, seed=52)
    return data, plan_skew_join(q, data, k)


def _all_keys_equal(got, want):
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("fields", [{}, {"fuse_map": False,
                                         "hash_reduce": False}],
                         ids=["fused+hash", "staged+sort"])
@pytest.mark.parametrize("chunks", [2, 7])
def test_chunked_exchange_on_card_equals_cpu(dev, chunks, fields):
    """overlap_shuffle = C on the card (the two-stream path) gives the CPU
    run's result under the same C bit for bit, launching scatter_pack (or
    the staged pack) once a chunk."""
    data, plan = _healing_case()
    results = []
    for device in (dev, "cpu"):
        cfg = ExecutorConfig(out_capacity=1 << 16, overlap_shuffle=chunks,
                             **fields)
        ops.reset_launches()
        res = ShardedJoinExecutor(plan, 8, cfg, device=device).run(data)
        assert res["shuffle_overflow"].sum() == 0
        assert res["join_overflow"].sum() == 0
        results.append(res)
        if device is dev:
            packer = "scatter_pack" if not fields else "bucket_pack"
            assert ops.LAUNCHES[packer] == 2 * chunks
    _all_keys_equal(*results)
    np.testing.assert_array_equal(
        canonical(results[0]["rows"][results[0]["valid"]]),
        reference_join(two_way(), data))


def test_chunked_batches_back_to_back_with_allocations_between(dev):
    """Ten chunked batches with tensors allocated and freed between them
    (the caching allocator reusing blocks) give identical results: the
    side stream's copies are ordered after each pack and before the
    reduce, and a send buffer is not reused while its copy runs."""
    data, plan = _healing_case()
    ex = ShardedJoinExecutor(plan, 8, ExecutorConfig(out_capacity=1 << 16,
                                                     overlap_shuffle=4),
                             device=dev)
    s = ex.session().prepare(data)
    first = s.run_batch()
    want = {key: first[key] for key in first}
    results = []
    for i in range(10):
        junk = [torch.full((1 << 16, 3), i, dtype=torch.int32, device=dev)
                for _ in range(8)]
        results.append(s.run_batch())
        del junk
    torch.cuda.synchronize()
    for res in results:
        _all_keys_equal({key: res[key] for key in res}, want)
    assert ex.compile_count == 1


def test_retry_and_refold_on_card_equal_cpu(dev):
    """run_with_retry from squeezed caps, then a refold over 7 survivors:
    the same caps, counters and rows on the card as on the CPU."""
    from repro_torch.core.placement import lpt_placement
    data, plan = _healing_case()
    trails = []
    for device in (dev, "cpu"):
        ex = ShardedJoinExecutor(plan, 8, ExecutorConfig(out_capacity=1 << 16),
                                 device=device)
        probe = ex.session().prepare(data)
        caps = {r: max(1, c // 8) for r, c in probe.caps.items()}
        s = ex.session().prepare(data, caps=caps, placement=probe.placement)
        res = s.run_with_retry()
        trail = [dict(s.caps), s.cap_out, s.stats["retries"],
                 s.stats["escalations"], s.stats["shuffle_overflow"].copy(),
                 {key: res[key] for key in res}]
        survivors = [d for d in range(8) if d != 3]
        s.refold(lpt_placement(s.cell_loads(), 8, devices=survivors))
        res = s.run_batch()
        assert res["recv_counts"][3] == 0
        trail += [dict(s.caps), {key: res[key] for key in res}]
        trails.append(trail)
    card, cpu = trails
    assert card[2] >= 1
    for got, want in zip(card, cpu):
        if isinstance(got, dict) and "rows" in got:
            _all_keys_equal(got, want)
        else:
            np.testing.assert_array_equal(got, want)


# The captured step (a CUDA graph a (shapes, caps, cap_out) key) against
# the same plan and data run eagerly on the CPU.
def _counters(ex):
    return ex.compile_count, ex.step_hits, ex.evicted_steps


def _permuted(placement, shift=3):
    """The placement with its devices relabelled (d -> d + shift mod n):
    the same per-device loads, so the same derived caps, another table."""
    from repro_torch.core.placement import CellPlacement
    return CellPlacement((placement.table + shift) % placement.n_devices,
                         placement.n_devices)


@pytest.mark.parametrize("fuse_map,hash_reduce", list(ARM_KERNELS))
@pytest.mark.parametrize("chunks", [1, 2, 7])
def test_graph_step_equals_cpu(dev, fuse_map, hash_reduce, chunks):
    """A key's first batch runs the step eagerly, its second captures one
    graph (each step kernel launched once more) and replays it, a third
    replays it and launches nothing from the host; all three results are
    the CPU run's bit for bit."""
    from repro_torch.core.executor import _GraphStep
    data, plan = _healing_case()
    results = []
    for device in (dev, "cpu"):
        cfg = ExecutorConfig(out_capacity=1 << 16, overlap_shuffle=chunks,
                             fuse_map=fuse_map, hash_reduce=hash_reduce)
        ex = ShardedJoinExecutor(plan, 8, cfg, device=device)
        ops.reset_launches()
        s = ex.session().prepare(data)
        got = [s.run_batch()]
        launches = [dict(ops.LAUNCHES)]
        for _ in range(2):
            got.append(s.run_batch())
            launches.append(dict(ops.LAUNCHES))
        assert _counters(ex) == (1, 2, 0)
        results.append(got)
        if device is dev:
            (step,) = ex._step_cache.values()
            assert isinstance(step, _GraphStep) and ex.captures == 1
            once = expected_launches(ex, max(chunks, 1), prepare=False)
            assert launches[0] == expected_launches(ex, max(chunks, 1))
            assert {k: launches[1][k] - launches[0][k]
                    for k in launches[0]} == once
            assert launches[2] == launches[1]
        else:
            assert ex.captures == 0
    for got, want in zip(*results):
        _all_keys_equal(got, want)
    last = results[0][-1]
    np.testing.assert_array_equal(
        canonical(last["rows"][last["valid"]]),
        reference_join(two_way(), data))


def _graph_counter_trail(device):
    """prepare, two batches, a refold onto relabelled devices (same caps:
    no build), then a retry from R's cap halved (the halved key built,
    the escalation back to the prepared caps a replay): counters, caps
    and results after each, and the executor."""
    data, plan = _healing_case()
    ex = ShardedJoinExecutor(plan, 8, ExecutorConfig(out_capacity=1 << 16,
                                                     capacity_factor=1.0),
                             device=device)
    s = ex.session().prepare(data)
    caps = dict(s.caps)
    trail = [_counters(ex)]
    for _ in range(2):
        res = s.run_batch()
        trail += [_counters(ex), {key: res[key] for key in res}]
    s.refold(_permuted(s.placement))
    assert s.caps == caps
    res = s.run_batch()
    trail += [_counters(ex), {key: res[key] for key in res}]
    s.caps["R"] = caps["R"] // 2
    res = s.run_with_retry()
    trail += [_counters(ex), dict(s.caps), s.stats["retries"],
              s.stats["escalations"], {key: res[key] for key in res}]
    return trail, ex


def test_graph_step_counters_through_refold_and_retry(dev):
    """compile_count counts builds, step_hits lookups of a cached step:
    prepare builds nothing, the first batch builds the step (run eagerly),
    the second captures it; a refold builds none (the table is an input)
    and replays; a retry escalating one cap builds its one new key, which
    runs once and is never captured.  The same counters and results as
    the CPU run."""
    (card, ex), (cpu, _) = _graph_counter_trail(dev), _graph_counter_trail(
        "cpu")
    assert card[0] == (0, 0, 0) and card[1] == (1, 0, 0)
    assert card[3] == (1, 1, 0) and card[5] == (1, 2, 0)
    assert card[7] == (2, 3, 0) and card[9] == 1
    assert ex.captures == 1
    for got, want in zip(card, cpu):
        if isinstance(got, dict) and "rows" in got:
            _all_keys_equal(got, want)
        else:
            assert got == want


def _held_results(device):
    """Three batches of one session, all results held before any is read:
    the prepared data, the same rows in another order, the prepared data
    (the first run eagerly, the second a capture, the third a replay)."""
    data, plan = _healing_case()
    rng = np.random.default_rng(1)
    other = {name: rows[rng.permutation(len(rows))]
             for name, rows in data.items()}
    ex = ShardedJoinExecutor(plan, 8, ExecutorConfig(out_capacity=1 << 16),
                             device=device)
    s = ex.session().prepare(data)
    first = s.run_batch()
    second = s.run_batch(other)
    third = s.run_batch()
    return [first, second, third], ex


def test_graph_results_held_at_once_stay_right(dev):
    """A replay overwrites the graph's outputs, so each live result gets
    its own copy first: results held across later batches keep their own
    rows, equal to the CPU run's (and on the card, not only on the host)."""
    card, ex = _held_results(dev)
    cpu, _ = _held_results("cpu")
    assert not torch.equal(card[1].tensors[0], card[2].tensors[0])
    for got, want in zip(card, cpu):
        assert got.tensors[0].is_cuda
        _all_keys_equal(got, want)
    assert _counters(ex) == (1, 2, 0) and ex.captures == 1


def _stats_trail(device, n_batches=70):
    """n_batches over two keys, every third at R's cap quartered (which
    overflows): the session's lifetime stats after them."""
    data, plan = _healing_case()
    ex = ShardedJoinExecutor(plan, 8, ExecutorConfig(out_capacity=1 << 16),
                             device=device)
    s = ex.session().prepare(data)
    caps = dict(s.caps)
    squeezed = dict(caps, R=max(1, caps["R"] // 4))
    rows = 0
    for i in range(n_batches):
        s.caps = dict(squeezed if i % 3 == 0 else caps)
        res = s.run_batch()
        rows += int(res["valid"].sum())
    st = s.stats
    return (st["batches"], st["shuffle_overflow"].copy(),
            st["join_overflow"].copy(), rows, _counters(ex))


def test_graph_stats_right_after_70_batches(dev):
    """`stats` drains overflow parked a batch (past the 64-batch drain):
    after 70 replays with overflow in every third it is the CPU run's."""
    card, cpu = _stats_trail(dev), _stats_trail("cpu")
    assert card[1].sum() > 0
    assert card[4] == (2, 68, 0)
    for got, want in zip(card, cpu):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_steps", [1, 2])
def test_graph_eviction_frees_its_memory(dev, max_steps):
    """Two keys, each run twice (so captured).  With max_cached_steps=1
    the second key evicts the first graph and the memory it held returns
    (allocated bytes back to one graph's); with room for both, both stay
    held."""
    import gc
    data, plan = _healing_case()
    ex = ShardedJoinExecutor(plan, 8, ExecutorConfig(
        out_capacity=1 << 18, max_cached_steps=max_steps), device=dev)
    s = ex.session().prepare(data)
    caps = dict(s.caps)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for _ in range(2):
        s.run_batch()
    torch.cuda.synchronize()
    one = torch.cuda.memory_allocated() - base
    s.caps = {name: 2 * c for name, c in caps.items()}
    for _ in range(2):
        s.run_batch()
    gc.collect()
    torch.cuda.synchronize()
    now = torch.cuda.memory_allocated() - base
    assert one > 8 * (1 << 18) * 3 * 4           # the output rows at least
    assert ex.captures == 2
    if max_steps == 1:
        assert _counters(ex) == (2, 2, 1)
        assert now < 1.5 * one
    else:
        assert _counters(ex) == (2, 2, 0)
        assert now > 1.75 * one


def _two_placements(device):
    """One executor, two sessions on the same data: LPT and the relabelled
    devices.  Interleaved batches, results held; rows and received counts
    after each."""
    data, plan = _healing_case()
    ex = ShardedJoinExecutor(plan, 8, ExecutorConfig(out_capacity=1 << 16),
                             device=device)
    a = ex.session().prepare(data)
    b = ex.session().prepare(data, caps=a.caps,
                             placement=_permuted(a.placement))
    held = [a.run_batch(), b.run_batch(), a.run_batch(), b.run_batch()]
    return held, ex, (a.placement.table, b.placement.table)


def test_graph_shared_by_sessions_with_other_placements(dev):
    """Sessions of one executor with different placements share one graph
    (the table is an input) and each gives its own rows: the CPU's."""
    card, ex, tables = _two_placements(dev)
    cpu, _, _ = _two_placements("cpu")
    assert not np.array_equal(*tables)
    assert _counters(ex) == (1, 3, 0) and ex.captures == 1
    assert not np.array_equal(card[2]["recv_counts"], card[3]["recv_counts"])
    for got, want in zip(card, cpu):
        _all_keys_equal(got, want)


def _adapt_trail(device, scenario):
    """`tests/test_adapt.py`'s mild-drift or new-HH schedule through the
    port's SelfHealingSession(adapt=) on `device`: after each batch the
    adaptation counters, placement, caps, plan HHs and result."""
    from _torch_adapt_cases import (CAP_OUT, E2E_POL, HOT_A, HOT_MILD,
                                    K_PLAN, drift_batch)
    from repro_torch.core import AdaptPolicy
    from repro_torch.serve import SelfHealingSession
    data0 = drift_batch(HOT_A, seed=1)
    ex = ShardedJoinExecutor(plan_skew_join(two_way(), data0, K_PLAN), 8,
                             ExecutorConfig(out_capacity=CAP_OUT),
                             device=device)
    eng = SelfHealingSession(ex, adapt=AdaptPolicy(**E2E_POL)).prepare(data0)
    if scenario == "mild":
        batches = ([drift_batch(HOT_A, seed=20 + i) for i in range(3)]
                   + [drift_batch(HOT_MILD, seed=30 + i) for i in range(6)])
    else:
        batches = ([drift_batch(HOT_A, seed=60 + i) for i in range(3)]
                   + [drift_batch(HOT_A, seed=70 + i, extra_hh={"B": 256})
                      for i in range(4)])
    trail = []
    for batch in batches:
        res = eng.run_batch(batch)
        st = eng.stats
        trail.append(dict(
            counters=[st[k] for k in ("batches", "retries", "replacements",
                                      "replace_compiles", "replans",
                                      "replan_compiles")],
            table=eng.session.placement.table.tolist(),
            caps=dict(eng.session.caps), cap_out=eng.session.cap_out,
            hhs=dict(eng.executor.plan.hhs.per_attr),
            history=list(eng.detector.history),
            result={key: res[key] for key in res}))
    rows = trail[-1]["result"]
    np.testing.assert_array_equal(
        canonical(rows["rows"][rows["valid"]]),
        reference_join(two_way(), batches[-1]))
    return trail


@pytest.mark.parametrize("scenario", ["mild", "new_hh"])
def test_adapt_on_card_equals_cpu(dev, scenario):
    """Drift adaptation on the card: the same re-placements, re-plans,
    placement tables, caps and rows as the CPU run (itself held equal to
    the JAX package's in tests/test_torch_adapt_session.py)."""
    card, cpu = _adapt_trail(dev, scenario), _adapt_trail("cpu", scenario)
    assert len(card) == len(cpu)
    for got, want in zip(card, cpu):
        _all_keys_equal(got.pop("result"), want.pop("result"))
        assert got == want
    counters = card[-1]["counters"]
    if scenario == "mild":
        assert counters[2] >= 1 and counters[4] == 0 and counters[3] == 0
    else:
        assert counters[4] >= 1 and counters[5] >= 1
        assert 1 in card[-1]["hhs"]["B"]


def _engine_trail(device):
    from repro_torch.data import mixed_workload
    from repro_torch.serve import JoinServingEngine
    eng = JoinServingEngine(8, device=device)
    reqs = [(eng.submit(t, q, d), q, d) for t, q, d in mixed_workload(9)]
    eng.run()
    for req, q, d in reqs:
        np.testing.assert_array_equal(canonical(req.rows),
                                      canonical(reference_join(q, d)))
    return [(r.tenant, r.bucket, r.rows) for r, _, _ in reqs], eng.stats


def test_join_engine_on_card_equals_cpu(dev):
    """Nine mixed_workload requests through the multi-tenant engine on the
    card: the CPU engine's rows (in order), buckets and stats."""
    (card, card_stats), (cpu, cpu_stats) = _engine_trail(dev), \
        _engine_trail("cpu")
    for (t, b, rows), (t_c, b_c, rows_c) in zip(card, cpu):
        assert (t, b) == (t_c, b_c)
        np.testing.assert_array_equal(rows, rows_c)
    assert card_stats == cpu_stats


def _pruned_trail(device):
    from _torch_adapt_cases import pruned_pair
    from repro_torch.serve import JoinServingEngine
    eng = JoinServingEngine(8, device=device)
    pair = pruned_pair()
    reqs = [eng.submit("t", two_way(), d) for d in pair]
    eng.run()
    for req, d in zip(reqs, pair):
        np.testing.assert_array_equal(canonical(req.rows),
                                      canonical(reference_join(two_way(), d)))
    return [r.rows for r in reqs], eng.stats


def test_join_engine_replans_a_pruned_combination_on_card(dev):
    """A request filling a combination its tenant's plan pruned re-plans
    the tenant on the card as on the CPU: equal rows, one re-plan."""
    (card, card_stats), (cpu, cpu_stats) = _pruned_trail(dev), \
        _pruned_trail("cpu")
    for rows, rows_c in zip(card, cpu):
        np.testing.assert_array_equal(rows, rows_c)
    assert card_stats == cpu_stats
    assert card_stats["tenants"]["t"]["replans"] == 1


def test_full_sized_request_rows_leave_the_card_compacted(dev, monkeypatch):
    """A request at the full-size cell (two_way, 2^21 rows a relation, k =
    256): its valid rows are compacted on the card and only they are
    copied to the host; the (n_dev·cap_out, w) buffer and its flags never
    are (no read of the result's host keys 'rows' or 'valid')."""
    from repro_torch.core.executor import BatchResult, RetryPolicy
    from repro_torch.data import drifting_join_batch
    from repro_torch.serve import JoinServingEngine
    data = drifting_join_batch(two_way(), 1 << 21, 12288, 1 << 20, (), 0,
                               seed=0)
    cr, cs = np.bincount(data["R"][:, 1]), np.bincount(data["S"][:, 0])
    m = min(len(cr), len(cs))
    exact = int((cr[:m].astype(np.int64) * cs[:m]).sum())
    read = []
    getitem = BatchResult.__getitem__

    def spy(self, key):
        read.append(key)
        return getitem(self, key)

    monkeypatch.setattr(BatchResult, "__getitem__", spy)
    eng = JoinServingEngine(8, k=256, retry=RetryPolicy(max_retries=16),
                            device=dev)
    req = eng.submit("full", two_way(), data)
    eng.run()
    assert req.rows.shape == (exact, 3) and req.rows.dtype == np.int32
    assert "rows" not in read and "valid" not in read
    assert 0 < req.copy_s < req.latency_s
    st = eng.stats["tenants"]["full"]
    assert st["overflow"] > 0 and st["rows_out"] == exact


# The executor over a mesh of ranks on the one card (tests/_torch_mesh_cases
# holds the spawned ranks' functions, torch-only).
@pytest.mark.parametrize("backend,world,chunks", [("gloo", 2, (1, 2)),
                                                  ("nccl", 1, (1, 2))])
def test_mesh_on_card_equals_one_process(dev, tmp_path, backend, world,
                                         chunks):
    """W = 2 gloo ranks sharing cuda:0, and one NCCL rank: on fused + hash
    and staged + sort at C = 1 and 2, each rank's rows `torch.equal` to
    the one-process card session's rows of its destinations, the same
    counters, caps, placement and result_rows."""
    import time
    import _torch_mesh_cases as mc
    from repro_torch.kernels import _build
    _build.lib()                  # built once, before the ranks load it
    ctx = mc.spawn_ranks(mc.card_rank, world, backend,
                         str(tmp_path / "store"), chunks)
    mc.join_ranks(ctx, time.monotonic() + mc.DEADLINE_S)


def test_make_join_mesh_refuses_two_nccl_ranks_on_one_card(dev, tmp_path):
    """Two NCCL ranks naming cuda:0 are refused on both (the rendezvous
    store sees one card twice), and rank 1's default card cuda:1 does not
    exist on a one-card host."""
    import time
    import _torch_mesh_cases as mc
    from repro_torch.core.executor import ExecutorError
    from repro_torch.launch.mesh import make_join_mesh
    ctx = mc.spawn_ranks(mc.nccl_shared_card_rank, 2,
                         str(tmp_path / "store"))
    mc.join_ranks(ctx, time.monotonic() + mc.DEADLINE_S)
    if torch.cuda.device_count() == 1:
        with pytest.raises(ExecutorError, match="would share a card"):
            make_join_mesh(init_method=f"file://{tmp_path / 'other'}",
                           rank=1, world_size=2)
