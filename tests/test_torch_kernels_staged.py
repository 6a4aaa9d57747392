"""Plain torch versions of the staged map's kernels (route_cells,
fold_cells, bucket_rank / bucket_pack), their ref.py oracles and the
executor's staged stages vs the JAX package.

The same numpy inputs go through the JAX functions (the Pallas kernels in
interpret mode, the `*_host` twins, the ref.py oracles) and the port's
torch counterparts on the CPU; int32 outputs must be bit-identical.  The
port's batched functions carry a leading axis (source shards): each slice
is held against one call of the single-device JAX function.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan_skew_join as jax_plan
from repro.core import running_example as jax_running_example
from repro.core import executor as jex
from repro.data import skewed_join_dataset as jax_dataset
from repro.kernels import bucket_pack as jbp
from repro.kernels import ref as jref
from repro.kernels import route_cells as jrc
from repro_torch.core import executor as tex
from repro_torch.kernels import bucket_pack as tbp
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import route_cells as trc

SEED_A, SEED_B, SEED_C = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rows(rng, n, w, domain=1 << 15, invalid_frac=0.1):
    rows = rng.integers(0, domain, size=(n, w)).astype(np.int32)
    rows[rng.random(n) < invalid_frac] = -1
    return rows


# (recipe, width): share-1 axes, one axis, three axes, all share 1.
RECIPES = [
    (((0, SEED_A, 8, 1),), 2),
    (((0, SEED_A, 1, 4), (1, SEED_B | 1, 4, 1)), 2),
    (((0, SEED_A, 4, 1), (1, SEED_B | 1, 2, 4), (2, SEED_C | 1, 16, 8)), 3),
    (((1, SEED_A, 1, 1),), 2),
]


@pytest.mark.parametrize("ri", range(len(RECIPES)))
@pytest.mark.parametrize("n", [0, 1, 300])
def test_route_cells_matches_jax(ri, n):
    recipe, w = RECIPES[ri]
    rows = _rows(np.random.default_rng(n + ri), n, w)
    got = trc.route_cells_host(_t(rows), recipe)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(
        got.numpy(), _np(jref.route_cells_ref(jnp.asarray(rows), recipe)))
    np.testing.assert_array_equal(
        tref.route_cells_ref(_t(rows), recipe).numpy(), got.numpy())
    np.testing.assert_array_equal(
        ops.route_cells(_t(rows), recipe).numpy(), got.numpy())
    if n:
        kern = jrc.route_cells(jnp.asarray(rows), recipe=recipe, block=128,
                               interpret=True)
        np.testing.assert_array_equal(got.numpy(), _np(kern))


def test_route_cells_rejects_a_share_not_a_power_of_two():
    rows = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        trc.route_cells_host(rows, ((0, SEED_A, 6, 1),))
    with pytest.raises(ValueError, match="power of two"):
        jrc.route_cells(jnp.asarray(rows.numpy()),
                        recipe=((0, SEED_A, 6, 1),), interpret=True)


@pytest.mark.parametrize("k,m", [(1, 1), (8, 0), (8, 257), (256, 1000)])
def test_fold_cells_matches_jax(k, m):
    rng = np.random.default_rng(k + m)
    table = rng.integers(0, 8, size=k).astype(np.int32)
    dest = rng.integers(-1, k, size=m).astype(np.int32)
    got = trc.fold_cells_host(_t(dest), _t(table))
    want = _np(jref.fold_cells_ref(jnp.asarray(dest), jnp.asarray(table)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.fold_cells_ref(_t(dest), _t(table)).numpy(), want)
    np.testing.assert_array_equal(
        ops.fold_cells(_t(dest), _t(table)).numpy(), want)
    if m:
        kern = jrc.fold_cells(jnp.asarray(dest), jnp.asarray(table),
                              block=128, interpret=True)
        np.testing.assert_array_equal(got.numpy(), _np(kern))


def test_fold_cells_past_the_table_follows_the_pallas_kernel():
    """dest ≥ k: the Pallas kernel's one-hot sum gives 0 and the plain
    version follows it; the oracles clamp to the last entry."""
    table = np.array([5, 6, 7, 3], np.int32)
    dest = np.array([-1, 0, 3, 4, 9, 2], np.int32)
    kern = _np(jrc.fold_cells(jnp.asarray(dest), jnp.asarray(table),
                              block=8, interpret=True))
    np.testing.assert_array_equal(kern, [-1, 5, 3, 0, 0, 7])
    np.testing.assert_array_equal(
        trc.fold_cells_host(_t(dest), _t(table)).numpy(), kern)
    clamped = [-1, 5, 3, 3, 3, 7]
    np.testing.assert_array_equal(
        _np(jref.fold_cells_ref(jnp.asarray(dest), jnp.asarray(table))),
        clamped)
    np.testing.assert_array_equal(
        tref.fold_cells_ref(_t(dest), _t(table)).numpy(), clamped)


def _dests(rng, b, m, k, case):
    if case == "random":
        return rng.integers(-1, k + 2, size=(b, m)).astype(np.int32)
    if case == "all_equal":
        return np.full((b, m), k // 2, np.int32)
    if case == "all_invalid":
        return np.full((b, m), -1, np.int32)
    if case == "distinct":                        # m = k: every bucket once
        return np.stack([rng.permutation(k) for _ in range(b)]).astype(
            np.int32)
    return np.tile(np.arange(m, dtype=np.int32) % (k + 2) - 1, (b, 1))


@pytest.mark.parametrize("k", [1, 7, 33, 256])
@pytest.mark.parametrize("m,case", [(0, "random"), (1, "random"),
                                    (257, "random"), (100, "all_equal"),
                                    (70, "all_invalid"), (300, "cycle"),
                                    (None, "distinct")])
def test_bucket_rank_and_pack_match_jax(k, m, case):
    m = k if case == "distinct" else m
    rng = np.random.default_rng(k * 1000 + m)
    dest = _dests(rng, 3, m, k, case)
    rows = rng.integers(0, 10_000, size=(3, m, 3)).astype(np.int32)
    cap = max(2, (2 * m) // max(k, 1))
    rank, hist = tbp.bucket_rank_host(_t(dest), k)
    buf, over = tbp.bucket_pack_host(_t(dest), _t(rows), k, cap)
    o_buf, o_over = ops.bucket_pack(_t(dest), _t(rows), k, cap)
    assert torch.equal(o_buf, buf) and torch.equal(o_over, over)
    for b in range(3):
        jd, jr = jnp.asarray(dest[b]), jnp.asarray(rows[b])
        for want_rank, want_hist in (jbp.bucket_rank_host(jd, k=k),
                                     jref.bucket_rank_ref(jd, k)):
            np.testing.assert_array_equal(rank[b].numpy(), _np(want_rank))
            np.testing.assert_array_equal(hist[b].numpy(), _np(want_hist))
        t_rank, t_hist = tref.bucket_rank_ref(_t(dest[b]), k)
        np.testing.assert_array_equal(t_rank.numpy(), rank[b].numpy())
        np.testing.assert_array_equal(t_hist.numpy(), hist[b].numpy())
        for want_buf, want_over in (jbp.bucket_pack_host(jd, jr, k=k, cap=cap),
                                    jref.bucket_pack_ref(jd, jr, k, cap)):
            np.testing.assert_array_equal(buf[b].numpy(), _np(want_buf))
            assert int(over[b]) == int(want_over)
        r_buf, r_over = tref.bucket_pack_ref(_t(dest[b]), _t(rows[b]), k, cap)
        np.testing.assert_array_equal(r_buf.numpy(), buf[b].numpy())
        assert int(r_over) == int(over[b])


@pytest.mark.parametrize("n_bins,shared", [(1, True), (9, True),
                                            (4096, True), (4097, False),
                                            (20001, False)])
def test_bucket_geometry(n_bins, shared):
    """csrc/bucket_pack.cu's geometry: 2,048-item tiles whatever the row
    width (records are copied in place, never staged, so no width limit);
    counters in shared memory up to 4,096 bins (k, or k + 1 with
    bucket_rank's sentinel), past it in device memory."""
    assert tbp.bucket_geometry(n_bins) == (2048, shared)


@pytest.mark.parametrize("k,m,cap", [(7, 300, 40), (33, 700, 3)])
def test_bucket_pack_matches_interpret_kernel_with_overflow(k, m, cap):
    """Forced overflow: the ranks decide which rows are dropped, so they
    must be the kernel's exactly; blocks of 64 make the carry cross tiles."""
    rng = np.random.default_rng(k + m)
    dest = rng.integers(-1, k, size=(1, m)).astype(np.int32)
    dest[0, : m // 4] = 2                         # one hot bucket
    rows = rng.integers(0, 10_000, size=(1, m, 2)).astype(np.int32)
    buf, over = tbp.bucket_pack_host(_t(dest), _t(rows), k, cap)
    assert int(over[0]) > 0
    jd, jr = jnp.asarray(dest[0]), jnp.asarray(rows[0])
    k_rank, k_hist = jbp.bucket_rank(jd, k=k, block=64, interpret=True)
    rank, hist = tbp.bucket_rank_host(_t(dest), k)
    np.testing.assert_array_equal(rank[0].numpy(), _np(k_rank))
    np.testing.assert_array_equal(hist[0].numpy(), _np(k_hist))
    k_buf, k_over = jbp.bucket_pack(jd, jr, k=k, cap=cap, block=64,
                                    interpret=True)
    np.testing.assert_array_equal(buf[0].numpy(), _np(k_buf))
    assert int(over[0]) == int(k_over)


# ---------------------------------------------------------------------------
# The executor's staged stages against the reference's
# ---------------------------------------------------------------------------

def _jax_routes(k):
    q = jax_running_example()
    data = jax_dataset(q, 3000, 1 << 14, skew={"B": 1.5}, seed=11)
    plan = jax_plan(q, data, k)
    return jex._build_routes(plan)


@pytest.mark.parametrize("k", [8, 64])
def test_staged_map_stages_match_jax(k):
    """_route_relation, _fold_dests and _pack_buckets per source shard,
    on both sides' kernel and plain paths."""
    rng = np.random.default_rng(k)
    routes = _jax_routes(k)
    widths = {"R": 2, "S": 3, "T": 2}
    ptable = rng.integers(0, 8, size=k).astype(np.int32)
    for name, rroutes in routes.items():
        spec = jex._route_specs(rroutes)
        rows = _rows(rng, 4 * 40, widths[name], domain=200)
        rows3 = rows.reshape(4, 40, widths[name])
        dest, tagged = tex._route_relation(_t(rows3), spec, k, True)
        phys = tex._fold_dests(dest, _t(ptable), True)
        cap = 12
        buf, over = tex._pack_buckets(phys, tagged, 8, cap, True)
        for s in range(4):
            j_dest, j_tagged = jex._route_relation(jnp.asarray(rows3[s]),
                                                   rroutes, False)
            np.testing.assert_array_equal(dest[s].numpy(), _np(j_dest))
            np.testing.assert_array_equal(tagged[s].numpy(), _np(j_tagged))
            j_phys = jex._fold_dests(j_dest, jnp.asarray(ptable), False)
            np.testing.assert_array_equal(phys[s].numpy(), _np(j_phys))
            j_buf, j_over = jex._pack_buckets(j_phys, j_tagged, 8, cap, False)
            np.testing.assert_array_equal(buf[s].numpy(), _np(j_buf))
            assert int(over[s]) == int(j_over)
    # The kernel arms of the reference's stages, on one relation.
    spec = jex._route_specs(routes["S"])
    rows3 = _rows(rng, 30, 3, domain=200).reshape(1, 30, 3)
    dest, tagged = tex._route_relation(_t(rows3), spec, k, True)
    j_dest, j_tagged = jex._route_relation(jnp.asarray(rows3[0]),
                                           routes["S"], True)
    np.testing.assert_array_equal(dest[0].numpy(), _np(j_dest))
    np.testing.assert_array_equal(tagged[0].numpy(), _np(j_tagged))
