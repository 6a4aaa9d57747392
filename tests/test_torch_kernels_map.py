"""Plain torch versions of the map-side kernels (map_count, scatter_pack)
vs the JAX package.

The same numpy inputs go through the JAX functions (the `*_host` twins, the
Pallas kernels in interpret mode at tiny sizes, the ref.py oracles) and the
port's torch counterparts on the CPU; int32 outputs must be bit-identical.
The port's functions carry a leading batch axis (sources or destinations):
each slice is held against one call of the single-device JAX function.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan_skew_join as jax_plan
from repro.core import running_example as jax_running_example
from repro.core.executor import _build_routes as jax_build_routes
from repro.core.executor import _route_specs as jax_route_specs
from repro.data import skewed_join_dataset as jax_dataset
from repro.kernels import map_pack as jmp
from repro.kernels import ref as jref
from repro.kernels import scatter_pack as jsp
from repro_torch.kernels import map_pack as tmp
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scatter_pack as tsp

SEED_A, SEED_B = 0x9E3779B1, 0x85EBCA77


def _synthetic_routes(k):
    """Two residual routes: hashed attrs, replication, eq / not-in sets."""
    if k == 1:
        return ((((0, SEED_A, 1, 1),), (0,), 0, (), ()),)
    half, quarter = max(k // 2, 1), max(k // 4, 1)
    return (
        (((0, SEED_A, half, 1),), (0, half), 0, (), ((1, (7, 13)),)),
        (((0, SEED_B, quarter, 1), (2, SEED_A, 2, quarter)), (0,), quarter,
         ((1, 7),), ()),
    )


@functools.lru_cache(maxsize=None)
def _plan_routes(k):
    """Route specs of a real SkewShares plan (fanout > 1, HH constraints)."""
    q = jax_running_example()
    data = jax_dataset(q, 3000, 1 << 14, skew={"B": 1.5}, seed=11)
    plan = jax_plan(q, data, k)
    return {n: jax_route_specs(r) for n, r in jax_build_routes(plan).items()}


def _rows(rng, n, w, domain=50, invalid_frac=0.1):
    rows = rng.integers(0, domain, size=(n, w)).astype(np.int32)
    rows[rng.random(n) < invalid_frac] = -1
    return rows


def _np(x):
    return np.asarray(x)


ROUTE_CASES = [("synthetic", 1), ("synthetic", 8), ("synthetic", 256),
               ("plan", 8), ("plan", 64)]


def _route_sets(kind, k):
    if kind == "synthetic":
        return [(_synthetic_routes(k), 3)]
    widths = {"R": 2, "S": 3, "T": 2}
    return [(spec, widths[name]) for name, spec in _plan_routes(k).items()]


# n = 13 < 8 sources · 2 rows: rows_per_src = 1, rows 8.. count nowhere.
@pytest.mark.parametrize("kind,k,n", [c + (n,) for c in ROUTE_CASES
                                      for n in (0, 400)]
                         + [("synthetic", 8, 13), ("plan", 8, 13)])
def test_map_count_matches_jax(kind, k, n):
    rng = np.random.default_rng(n + k)
    for routes, w in _route_sets(kind, k):
        rows = _rows(rng, n, w)
        got = tmp.map_count_host(torch.from_numpy(rows), routes, k, 8)
        want = jmp.map_count_host(jnp.asarray(rows), routes=routes, k=k,
                                  n_src=8)
        np.testing.assert_array_equal(got.numpy(), _np(want))
        np.testing.assert_array_equal(
            tref.map_count_ref(torch.from_numpy(rows), routes, k, 8).numpy(),
            _np(jref.map_count_ref(jnp.asarray(rows), routes, k, 8)))
        np.testing.assert_array_equal(
            ops.map_count(torch.from_numpy(rows), routes, k, 8).numpy(),
            _np(want))


def test_map_count_matches_interpret_kernel():
    rng = np.random.default_rng(3)
    routes = _synthetic_routes(8)
    rows = _rows(rng, 40, 3)
    want = jmp.map_count(jnp.asarray(rows), routes=routes, k=8, n_src=4,
                         interpret=True)
    got = tmp.map_count_host(torch.from_numpy(rows), routes, 8, 4)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def _pack_both(rows3, routes, ptable, k, n_dev, cap):
    got_buf, got_over = tsp.scatter_pack_host(
        torch.from_numpy(rows3), routes, torch.from_numpy(ptable), k, n_dev,
        cap)
    for s in range(rows3.shape[0]):
        buf, over = jsp.scatter_pack_host(
            jnp.asarray(rows3[s]), jnp.asarray(ptable), routes=routes, k=k,
            n_dev=n_dev, cap=cap)
        np.testing.assert_array_equal(got_buf[s].numpy(), _np(buf))
        assert int(got_over[s]) == int(over)
    return got_buf, got_over


@pytest.mark.parametrize("kind,k", ROUTE_CASES)
@pytest.mark.parametrize("n_loc,cap", [(0, 4), (25, 64), (60, 3)])
def test_scatter_pack_matches_jax(kind, k, n_loc, cap):
    rng = np.random.default_rng(n_loc * 7 + k + cap)
    n_dev = min(k, 8)
    ptable = rng.integers(0, n_dev, size=k).astype(np.int32)
    for routes, w in _route_sets(kind, k):
        rows3 = _rows(rng, 4 * n_loc, w).reshape(4, n_loc, w)
        _, over = _pack_both(rows3, routes, ptable, k, n_dev, cap)
        if cap == 3 and n_loc:
            assert int(over.sum()) > 0          # forced overflow engaged


def test_scatter_pack_all_invalid_and_interpret_kernel():
    routes = _synthetic_routes(8)
    ptable = np.arange(8, dtype=np.int32) % 4
    dead = np.full((2, 10, 3), -1, np.int32)
    buf, over = _pack_both(dead, routes, ptable, 8, 4, 5)
    assert (buf.numpy() == -1).all() and int(over.sum()) == 0
    rows = _rows(np.random.default_rng(9), 30, 3)
    kbuf, kover = jsp.scatter_pack(jnp.asarray(rows), jnp.asarray(ptable),
                                   routes=routes, k=8, n_dev=4, cap=6,
                                   interpret=True)
    tbuf, tover = tsp.scatter_pack_host(torch.from_numpy(rows)[None], routes,
                                        torch.from_numpy(ptable), 8, 4, 6)
    np.testing.assert_array_equal(tbuf[0].numpy(), _np(kbuf))
    assert int(tover[0]) == int(kover)
    rbuf, rover = tref.scatter_pack_ref(torch.from_numpy(rows), torch.from_numpy(
        ptable), routes, 8, 4, 6)
    np.testing.assert_array_equal(rbuf.numpy(), _np(kbuf))
    assert int(rover) == int(kover)


def test_route_desc_layout():
    routes = _synthetic_routes(8)
    desc = tmp.route_desc(routes)
    fanout = tmp.route_fanout(routes)
    assert desc[:2] == [fanout, len(routes)]
    assert desc[2:2 + 2 * fanout] == [0, 0, 0, 4, 1, 2]
    rec0 = desc[desc[2 + 2 * fanout]:]
    assert rec0[:3] == [1, 0, 2]                 # 1 hashed, 0 eq, 2 not-in
    assert rec0[3:7] == [0, SEED_A, 2, 1]        # share 4 -> 2 bits


@pytest.mark.parametrize("routes", [
    _synthetic_routes(8),
    # A route with no reps between two that have some.
    ((((0, SEED_A, 4, 1),), (0, 4), 0, (), ()),
     (((0, SEED_B, 2, 1),), (), 8, (), ()),
     (((1, SEED_B, 2, 1),), (0, 1, 2), 9, ((0, 3),), ())),
], ids=["synthetic", "empty-route"])
def test_scatter_desc_words(routes):
    """The CUDA scatter_pack's descriptor: route_desc's words as the int32
    the kernel truncates them to (seeds past 2^31 wrap), then each route's
    first copy and the fanout."""
    desc = tmp.route_desc(routes)
    words = tsp.scatter_desc_tensor(routes, torch.device("cpu"))
    assert words.dtype == torch.int32
    assert len(words) == len(desc) + len(routes) + 1
    assert [w % (1 << 32) for w in words[:len(desc)].tolist()] == \
        [d % (1 << 32) for d in desc]
    first = words[len(desc):].tolist()
    reps = [len(r[1]) for r in routes]
    assert first == [sum(reps[:i]) for i in range(len(routes) + 1)]
    assert first[-1] == tmp.route_fanout(routes)
    # The copies of route r are [first[r], first[r + 1]) in route_desc.
    for r in range(len(routes)):
        assert all(desc[2 + 2 * j] == r for j in range(first[r], first[r + 1]))


@pytest.mark.parametrize("w,want", [(1, 1024), (2, 1024), (8, 1024),
                                    (9, 910), (300, 27), (8192, 1),
                                    (9000, 1)])
def test_scatter_tile_rows(w, want):
    """The CUDA scatter_pack's tile: 1,024 rows, fewer where their words
    would pass the kernels' 8,192-word shared-memory copy, one at least."""
    assert tsp.scatter_tile_rows(w) == want
    assert want == 1 or want * w <= tsp.SCATTER_ROW_WORDS


def test_map_pack_scratch_geometry_and_refusals():
    """The CUDA map_pack's tiles are scatter_pack's, with a sentinel bin
    (each tile's non-member copies) past the devices; it refuses what its
    kernels do not take: n_dev outside [1, MAX_PACK_BINS), a source of
    2^31 copies or more, rows of no column."""
    rows = torch.empty((3, 2049, 2), dtype=torch.int32)
    tile_rows, n_tiles, th = tmp.pack_scratch(rows, 17, 8)
    assert (tile_rows, n_tiles, tuple(th.shape)) == (1024, 3, (3, 9, 3))
    wide = torch.empty((1, 5, 9000), dtype=torch.int32)
    assert tmp.pack_scratch(wide, 2, 4)[:2] == (1, 5)
    for n_dev in (0, tmp.MAX_PACK_BINS):
        with pytest.raises(ValueError):
            tmp.pack_scratch(rows, 17, n_dev)
    tmp.pack_scratch(rows, 17, tmp.MAX_PACK_BINS - 1)
    huge = torch.empty((1, 1 << 27, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tmp.pack_scratch(huge, 16, 8)                    # 2^31 copies
    tmp.pack_scratch(huge, 15, 8)
    with pytest.raises(ValueError):
        tmp.pack_scratch(torch.empty((1, 5, 0), dtype=torch.int32), 2, 4)
