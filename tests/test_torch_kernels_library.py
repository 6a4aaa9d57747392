"""Plain torch versions of the join kernel library (map_pack,
hash_partition, match_counts, first_match) and their ref.py oracles vs the
JAX package.

The same numpy inputs go through the JAX functions (the Pallas kernels in
interpret mode, the `*_host` twins, the ref.py oracles) and the port's
torch counterparts on the CPU; int32 outputs must be bit-identical.  The
port's map_pack carries a leading axis (source shards): each slice is held
against one call of the single-device JAX function, and the whole against
the port's staged route -> fold -> pack and its scatter_pack.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_stub import given, settings, st
from repro.core import multiply_shift as jax_multiply_shift
from repro.core.executor import _Route, _build_routes, _route_specs
from repro.core.placement import lpt_placement, modulo_placement
from repro.kernels import build_probe as jbpr
from repro.kernels import hash_partition as jhp
from repro.kernels import map_pack as jmp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import executor as tex
from repro_torch.core.hypercube import multiply_shift
from repro_torch.kernels import build_probe as bpr
from repro_torch.kernels import hash_partition as hp
from repro_torch.kernels import map_pack as mp
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scatter_pack as sp

SHAPES = [1, 7, 128, 1000, 1024, 4096, 5000]
DTYPES = [np.int32, np.uint32, np.int16]
SEEDS = [1, 2654435761, 0x9E3779B1]
SEED_A, SEED_B = 0x9E3779B1, 0x85EBCA77


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# hash_partition
# ---------------------------------------------------------------------------

def _assert_hash_partition(keys, seed, nb):
    """Port plain version, oracle and ops == JAX Pallas kernel (interpret
    mode) and oracle; returns the port's (ids, hist)."""
    ids, hist = hp.hash_partition_host(_t(keys), seed, nb)
    assert ids.dtype == torch.int32 and hist.dtype == torch.int32
    k_ids, k_hist = jops.hash_partition(jnp.asarray(keys), seed=seed,
                                        nbuckets=nb)
    r_ids, r_hist = jref.hash_partition_ref(jnp.asarray(keys), seed, nb)
    for want_ids, want_hist in ((k_ids, k_hist), (r_ids, r_hist),
                                tref.hash_partition_ref(_t(keys), seed, nb),
                                ops.hash_partition(_t(keys), seed, nb)):
        np.testing.assert_array_equal(ids.numpy(), _np(want_ids))
        np.testing.assert_array_equal(hist.numpy(), _np(want_hist))
    return ids, hist


@pytest.mark.parametrize("n", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nbuckets", [1, 2, 16, 128])
def test_hash_partition_matches_jax(n, dtype, nbuckets):
    rng = np.random.default_rng(n * nbuckets)
    keys = rng.integers(0, np.iinfo(np.int16).max, size=n).astype(dtype)
    ids, hist = _assert_hash_partition(keys, SEEDS[0], nbuckets)
    assert int(hist.sum()) == n
    assert int(ids.min()) >= 0 and int(ids.max()) < nbuckets


@pytest.mark.parametrize("dtype", DTYPES)
def test_hash_partition_keys_hash_as_their_uint32_cast(dtype):
    """Negative int16 keys sign-extend; uint32 keys past 2^31 keep their
    bits."""
    if dtype == np.uint32:
        keys = np.array([0, 1, 2**31, 2**32 - 1, 2**31 + 7], np.uint32)
    else:
        keys = np.array([0, -1, -2, 7, np.iinfo(dtype).min], dtype)
    for nb in (2, 64, 1 << 16):
        _assert_hash_partition(keys, SEEDS[2], nb)
    want = multiply_shift(keys.astype(np.int64), SEEDS[2], 64)
    np.testing.assert_array_equal(
        hp.hash_partition_host(_t(keys), SEEDS[2], 64)[0].numpy(), want)


def test_hash_partition_matches_numpy_router():
    """Port hash == core.hypercube.multiply_shift (one hash family
    everywhere), and == the JAX package's."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**15, size=2048, dtype=np.int64)
    for seed in SEEDS:
        for nb in (1, 8, 64, 128):
            want = multiply_shift(keys, seed, nb)
            np.testing.assert_array_equal(want,
                                          jax_multiply_shift(keys, seed, nb))
            for got, _ in (hp.hash_partition_host(_t(keys), seed, nb),
                           ops.hash_partition(_t(keys), seed, nb)):
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nb", [1 << 15, 1 << 16])
def test_hash_partition_multi_pass_bit_identical(nb):
    """Past MAX_ONEHOT_BUCKETS the JAX package takes its factored
    histogram kernel; the port has one version for every nb."""
    assert nb > jhp.MAX_ONEHOT_BUCKETS
    rng = np.random.default_rng(9)
    seed = 0x9E3779B1
    keys = rng.integers(0, 1 << 31, size=1537).astype(np.int32)
    ids, hist = _assert_hash_partition(keys, seed, nb)
    shift = 32 - (nb.bit_length() - 1)
    want = ((keys.astype(np.uint32) * np.uint32(seed))
            * np.uint32(jref.MULT)) >> np.uint32(shift)
    np.testing.assert_array_equal(ids.numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(hist.numpy(),
                                  np.bincount(want, minlength=nb))
    assert int(hist.sum()) == len(keys)


def test_hash_partition_rejects_a_bucket_count_not_a_power_of_two():
    keys = np.arange(10, dtype=np.int32)
    for nb in (3, 100, 0):
        with pytest.raises(ValueError, match="power of two"):
            hp.hash_partition_host(_t(keys), 1, nb)
    with pytest.raises(ValueError):
        jhp.hash_partition(jnp.asarray(keys), seed=1, nbuckets=100,
                           interpret=True)
    with pytest.raises(TypeError):
        hp.hash_partition_host(_t(keys.astype(np.float32)), 1, 8)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 3000), logb=st.integers(0, 8),
       seed=st.integers(1, 2**31 - 1))
def test_hash_partition_property(n, logb, seed):
    seed |= 1
    keys = np.random.default_rng(n).integers(
        0, 2**31 - 1, size=n, dtype=np.int64).astype(np.int32)
    _assert_hash_partition(keys, seed, 1 << logb)
    if n > 1:
        ids, _ = hp.hash_partition_host(_t(np.full(n, keys[0], np.int32)),
                                        seed, 1 << logb)
        assert len(torch.unique(ids)) == 1


# ---------------------------------------------------------------------------
# match_counts and first_match
# ---------------------------------------------------------------------------

def _assert_matches(probe, build):
    """Port plain versions, oracles and ops == JAX Pallas kernels
    (interpret mode) and oracles, on inputs without -1 keys."""
    counts = bpr.match_counts_host(_t(probe), _t(build))
    first = bpr.first_match_host(_t(probe), _t(build))
    jp, jb = jnp.asarray(probe, jnp.int32), jnp.asarray(build, jnp.int32)
    for want in (jops.match_counts(jnp.asarray(probe), jnp.asarray(build)),
                 jref.match_counts_ref(jp, jb),
                 tref.match_counts_ref(_t(probe), _t(build)),
                 ops.match_counts(_t(probe), _t(build))):
        np.testing.assert_array_equal(counts.numpy(), _np(want))
    for want in (jops.first_match(jnp.asarray(probe), jnp.asarray(build)),
                 jref.first_match_ref(jp, jb),
                 tref.first_match_ref(_t(probe), _t(build)),
                 ops.first_match(_t(probe), _t(build))):
        np.testing.assert_array_equal(first.numpy(), _np(want))
    assert counts.dtype == torch.int32 and first.dtype == torch.int32
    return counts, first


@pytest.mark.parametrize("np_, nb", [(1, 1), (17, 523), (512, 512),
                                     (1000, 100), (2048, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_match_counts_matches_jax(np_, nb, dtype):
    rng = np.random.default_rng(np_ + nb)
    probe = rng.integers(0, 50, size=np_).astype(dtype)
    build = rng.integers(0, 50, size=nb).astype(dtype)
    counts, _ = _assert_matches(probe, build)
    assert int(counts.sum()) == sum(int((build == p).sum()) for p in probe)


@pytest.mark.parametrize("np_, nb", [(17, 523), (512, 512), (1000, 1500)])
def test_first_match_matches_jax(np_, nb):
    rng = np.random.default_rng(np_)
    probe = rng.integers(0, 30, size=np_).astype(np.int32)
    build = rng.integers(0, 30, size=nb).astype(np.int32)
    _, first = _assert_matches(probe, build)
    for i in np.flatnonzero(first.numpy() >= 0)[:50]:
        j = int(first[i])
        assert build[j] == probe[i] and not (build[:j] == probe[i]).any()


@pytest.mark.parametrize("case", ["all_equal", "all_distinct", "no_match"])
def test_matches_edge_keys(case):
    n = 700
    if case == "all_equal":
        probe, build = np.full(n, 4, np.int32), np.full(600, 4, np.int32)
    elif case == "all_distinct":
        probe = np.arange(n, dtype=np.int32)
        build = np.random.default_rng(1).permutation(n).astype(np.int32)
    else:
        probe, build = np.arange(n, dtype=np.int32), np.full(9, n, np.int32)
    counts, first = _assert_matches(probe, build)
    want = {"all_equal": 600, "all_distinct": 1, "no_match": 0}[case]
    assert (counts.numpy() == want).all()


def test_matches_with_an_empty_side():
    probe, build = _t(np.arange(5, dtype=np.int32)), _t(np.zeros(0, np.int32))
    assert (bpr.match_counts_host(probe, build) == 0).all()
    assert (bpr.first_match_host(probe, build) == -1).all()
    for fn in (bpr.match_counts_host, bpr.first_match_host):
        assert fn(build, probe).shape == (0,)
        with pytest.raises(ValueError):
            fn(probe[None], probe)


def test_matches_chunk_the_probe_side(monkeypatch):
    """Equality tiles smaller than the build side's row count still give
    the oracle's answers (chunks of one probe key)."""
    monkeypatch.setattr(bpr, "MATCH_TILE_ELEMS", 300)
    rng = np.random.default_rng(4)
    probe = rng.integers(0, 20, size=77).astype(np.int32)
    build = rng.integers(0, 20, size=500).astype(np.int32)
    _assert_matches(probe, build)


def test_pad_keys_follow_the_oracles_not_the_pallas_kernels():
    """The Pallas kernels pad the build side with -1 to a multiple of 512,
    so a probe key of -1 counts the pads and finds a pad index past the
    build; the port pads nothing and follows match_counts_ref and
    first_match_ref on every key, -1 and -2 included."""
    probe = np.array([-1, 3, -2, 5], np.int32)
    build = np.array([3, 3, 5], np.int32)
    jp, jb = jnp.asarray(probe), jnp.asarray(build)
    np.testing.assert_array_equal(
        _np(jbpr.match_counts(jp, jb, interpret=True)), [509, 2, 0, 1])
    np.testing.assert_array_equal(
        _np(jbpr.first_match(jp, jb, interpret=True)), [3, 0, -1, 2])
    want_counts, want_first = [0, 2, 0, 1], [-1, 0, -1, 2]
    np.testing.assert_array_equal(_np(jref.match_counts_ref(jp, jb)),
                                  want_counts)
    np.testing.assert_array_equal(_np(jref.first_match_ref(jp, jb)),
                                  want_first)
    for fn, want in ((bpr.match_counts_host, want_counts),
                     (tref.match_counts_ref, want_counts),
                     (bpr.first_match_host, want_first),
                     (tref.first_match_ref, want_first)):
        np.testing.assert_array_equal(fn(_t(probe), _t(build)).numpy(), want)
    # -1 and -2 on both sides are data.
    probe2 = np.array([-1, -2, 0, -1], np.int32)
    build2 = np.array([-2, -1, -1, 7, -2], np.int32)
    np.testing.assert_array_equal(
        bpr.match_counts_host(_t(probe2), _t(build2)).numpy(), [2, 2, 0, 2])
    np.testing.assert_array_equal(
        bpr.first_match_host(_t(probe2), _t(build2)).numpy(), [1, 0, -1, 1])
    np.testing.assert_array_equal(
        _np(jref.match_counts_ref(jnp.asarray(probe2), jnp.asarray(build2))),
        [2, 2, 0, 2])


@settings(max_examples=20, deadline=None)
@given(np_=st.integers(1, 600), nb=st.integers(1, 600),
       dom=st.integers(1, 40), seed=st.integers(0, 2**31 - 1))
def test_match_counts_property(np_, nb, dom, seed):
    rng = np.random.default_rng(seed)
    probe = rng.integers(0, dom, size=np_).astype(np.int32)
    build = rng.integers(0, dom, size=nb).astype(np.int32)
    counts, _ = _assert_matches(probe, build)
    assert int(counts.sum()) == sum(int((build == p).sum()) for p in probe)


# ---------------------------------------------------------------------------
# map_pack
# ---------------------------------------------------------------------------

def _routes_for(k):
    """Synthetic multi-residual recipe (the JAX package's test_map_pack
    recipe): hashed attributes, fanout > 1 by replication, eq and not-in
    constraints."""
    if k == 1:
        return [_Route("T", ((0, SEED_A, 1, 1),), (0,), 0, k, (), ())]
    half, quarter = max(k // 2, 1), max(k // 4, 1)
    return [
        _Route("T", ((0, SEED_A, half, 1),), (0, half), 0, k, (),
               ((1, (7, 13)),)),
        _Route("T", ((0, SEED_B, quarter, 1), (2, SEED_A, 2, quarter)),
               (0,), quarter, k, ((1, 7),), ()),
    ]


def _rand_rows(rng, m, w=3, domain=50, invalid_frac=0.1):
    rows = rng.integers(0, domain, size=(m, w)).astype(np.int32)
    rows[rng.random(m) < invalid_frac] = -1
    return rows


def _staged(rows3, spec, ptable, k, n_dev, cap):
    """The port's staged route -> fold -> pack on its plain versions."""
    dest, tagged = tex._route_relation(rows3, spec, k, False)
    phys = tex._fold_dests(dest, ptable, False)
    return tex._pack_buckets(phys, tagged, n_dev, cap, False)


def _assert_map_pack(rows, routes, ptable, k, n_dev, cap, n_src=2,
                     jax_paths=("kernel", "host", "ref")):
    """Port map_pack (plain, ops) == its staged pack == its scatter_pack,
    and each source slice == the JAX `jax_paths`: the Pallas kernel
    (interpret mode), the host twin and the oracle."""
    spec = _route_specs(routes)
    rows3 = _t(rows.reshape(n_src, -1, rows.shape[1]))
    pt = _t(np.asarray(ptable, np.int32))
    buf, over = mp.map_pack_host(rows3, spec, pt, k, n_dev, cap)
    assert buf.dtype == torch.int32 and over.dtype == torch.int32
    for name, (want_buf, want_over) in {
            "staged": _staged(rows3, spec, pt, k, n_dev, cap),
            "scatter_pack": sp.scatter_pack_host(rows3, spec, pt, k, n_dev,
                                                 cap),
            "ops": ops.map_pack(rows3, spec, pt, k, n_dev, cap)}.items():
        assert torch.equal(buf, want_buf), name
        assert torch.equal(over, want_over), name
    jpt = jnp.asarray(np.asarray(ptable, np.int32))
    for s in range(n_src):
        jr = jnp.asarray(rows3[s].numpy())
        paths = {
            "kernel": lambda: jmp.map_pack(jr, jpt, routes=spec, k=k,
                                           n_dev=n_dev, cap=cap,
                                           interpret=True),
            "host": lambda: jmp.map_pack_host(jr, jpt, routes=spec, k=k,
                                              n_dev=n_dev, cap=cap),
            "ref": lambda: jref.map_pack_ref(jr, jpt, spec, k, n_dev, cap)}
        for name in jax_paths:
            want_buf, want_over = paths[name]()
            np.testing.assert_array_equal(buf[s].numpy(), _np(want_buf),
                                          err_msg=f"{name} source {s}")
            assert int(over[s]) == int(want_over), f"{name} source {s}"
    return buf, over


@pytest.mark.parametrize("k,n_dev", [(1, 1), (8, 4), (256, 8)])
@pytest.mark.parametrize("m", [0, 1, 63, 257])
def test_map_pack_matches_staged_and_jax(k, n_dev, m):
    rng = np.random.default_rng(m * 1000 + k)
    routes = _routes_for(k)
    ptable = lpt_placement(rng.uniform(0, 100, k), n_dev).table
    rows = _rand_rows(rng, 2 * m)
    fanout = mp.route_fanout(_route_specs(routes))
    assert k == 1 or fanout > 1
    cap = max(4, (2 * m * fanout) // max(n_dev, 1))
    _assert_map_pack(rows, routes, ptable, k, n_dev, cap)


@pytest.mark.parametrize("k,n_dev", [(8, 4), (256, 8)])
def test_map_pack_all_invalid(k, n_dev):
    buf, over = _assert_map_pack(np.full((140, 3), -1, np.int32),
                                 _routes_for(k),
                                 modulo_placement(k, n_dev).table, k, n_dev, 4)
    assert (over == 0).all() and (buf == -1).all()


@pytest.mark.parametrize("k,n_dev", [(8, 4), (256, 8)])
def test_map_pack_overflow_parity(k, n_dev):
    rng = np.random.default_rng(k)
    rows = _rand_rows(rng, 300, invalid_frac=0.0)
    _, over = _assert_map_pack(rows, _routes_for(k),
                               modulo_placement(k, n_dev).table, k, n_dev, 2)
    assert (over > 0).all()


def test_map_pack_every_cell_on_one_device():
    k, n_dev = 32, 8
    rows = _rand_rows(np.random.default_rng(3), 240)
    buf, _ = _assert_map_pack(rows, _routes_for(k), np.zeros(k, np.int32), k,
                              n_dev, 1024)
    assert (buf[:, 1:] == -1).all()


def test_map_pack_real_plan_routes():
    """Recipes of a real SkewShares plan (multi-residual, HH constraints)."""
    from repro.core import plan_skew_join, two_way
    from repro.data import skewed_join_dataset
    k, n_dev = 64, 8
    q = two_way()
    data = skewed_join_dataset(q, 400, 40, skew={"B": 1.6}, seed=41)
    plan = plan_skew_join(q, data, k)
    assert len(plan.residuals) >= 2
    routes = _build_routes(plan)
    ptable = lpt_placement(np.asarray(plan.cell_loads(data), float),
                           n_dev).table
    for rel in ("R", "S"):
        rows = np.concatenate(
            [data[rel], np.full((10, 2), -1)]).astype(np.int32)
        _assert_map_pack(rows, routes[rel], ptable, k, n_dev, 2048,
                         jax_paths=("host", "ref"))


def test_map_pack_rank_carry_across_tiles():
    """The JAX kernel carries its histogram across grid steps; small
    block_copies force many.  The port's ranks match at every tiling."""
    k, n_dev, cap = 8, 4, 512
    rows = _rand_rows(np.random.default_rng(8), 300)
    routes = _routes_for(k)
    spec = _route_specs(routes)
    ptable = modulo_placement(k, n_dev).table
    buf, over = mp.map_pack_host(_t(rows[None]), spec,
                                 _t(np.asarray(ptable, np.int32)), k, n_dev,
                                 cap)
    for bc in (8, 64, 1024):
        k_buf, k_over = jmp.map_pack(jnp.asarray(rows), jnp.asarray(ptable),
                                     routes=spec, k=k, n_dev=n_dev, cap=cap,
                                     block_copies=bc, interpret=True)
        np.testing.assert_array_equal(buf[0].numpy(), _np(k_buf),
                                      err_msg=f"block_copies={bc}")
        assert int(over[0]) == int(k_over)


def test_map_pack_streams_are_the_pallas_kernels():
    """The plain streams: d is the placement of a member copy's wrapped
    cell (n_dev for non-members), tag its unwrapped cell (-1), rank its
    stable arrival rank within d, hist the (n_dev + 1,) counts."""
    k, n_dev = 8, 4
    rng = np.random.default_rng(12)
    rows = _rand_rows(rng, 50)
    spec = _route_specs(_routes_for(k))
    ptable = rng.integers(0, n_dev, k).astype(np.int32)
    tag, d, rank, hist = mp.route_streams(_t(rows[None]), spec, _t(ptable), k,
                                          n_dev)
    logical, valid = jmp._route_block(jnp.asarray(rows), spec, k)
    logical, valid = _np(logical).reshape(-1), _np(valid).reshape(-1)
    np.testing.assert_array_equal(tag[0].numpy(), logical)
    want_d = np.where(valid, ptable[np.where(valid, logical % k, 0)], n_dev)
    np.testing.assert_array_equal(d[0].numpy(), want_d)
    for b in range(n_dev + 1):
        np.testing.assert_array_equal(rank[0].numpy()[want_d == b],
                                      np.arange((want_d == b).sum()))
    np.testing.assert_array_equal(hist[0].numpy(),
                                  np.bincount(want_d, minlength=n_dev + 1))
    assert all(t.dtype == torch.int32 for t in (tag, d, rank, hist))


@pytest.mark.parametrize("k,n_dev", [(1, 1), (8, 4), (256, 8)])
def test_scatter_pack_host_equals_map_pack_host(k, n_dev):
    rng = np.random.default_rng(k + 5)
    spec = _route_specs(_routes_for(k))
    rows3 = _t(_rand_rows(rng, 3 * 150).reshape(3, 150, 3))
    pt = _t(np.asarray(lpt_placement(rng.uniform(0, 100, k), n_dev).table,
                       np.int32))
    for cap in (2, 64, 1024):
        a = sp.scatter_pack_host(rows3, spec, pt, k, n_dev, cap)
        b = mp.map_pack_host(rows3, spec, pt, k, n_dev, cap)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@settings(max_examples=8, deadline=None)
@given(st.integers(min_value=0, max_value=250),
       st.sampled_from([(1, 1), (8, 4), (256, 8)]),
       st.integers(min_value=1, max_value=10),
       st.integers(min_value=0, max_value=2**31 - 1))
def test_map_pack_property_bit_identical_to_staged(m, kn, cap, seed):
    k, n_dev = kn
    rng = np.random.default_rng(seed)
    ptable = lpt_placement(rng.uniform(0, 100, k), n_dev).table
    _assert_map_pack(_rand_rows(rng, 2 * m), _routes_for(k), ptable, k,
                     n_dev, cap, jax_paths=("host",))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_library_wrappers_take_the_plain_versions_on_cpu():
    ops.reset_launches()
    keys = _t(np.arange(100, dtype=np.int32))
    ops.hash_partition(keys, 1, 16)
    ops.match_counts(keys, keys[:10])
    ops.first_match(keys, keys[:10])
    spec = _route_specs(_routes_for(8))
    ops.map_pack(_t(np.zeros((2, 5, 3), np.int32)), spec,
                 _t(np.zeros(8, np.int32)), 8, 4, 4)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    assert {"map_pack", "hash_partition", "match_counts",
            "first_match"} <= set(ops.KERNELS)
