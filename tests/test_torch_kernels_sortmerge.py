"""Plain torch versions of the sort-merge reduce's kernel (segment_scan /
run_lengths), their ref.py oracles and the executor's sort-merge probe
(_lexsort_rows, _group_ids, _probe_sort) vs the JAX package.

The same numpy inputs go through the JAX functions (the Pallas kernel in
interpret mode, the ref.py oracles, the executor's helpers) and the port's
torch counterparts on the CPU; int32 outputs must be bit-identical.  The
port's functions carry a leading batch axis (destinations): each slice is
held against one call of the single-device JAX function.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executor as jex
from repro.kernels import build_probe as jbpr
from repro.kernels import ref as jref
from repro_torch.core import executor as tex
from repro_torch.kernels import build_probe as tbpr
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _sorted_keys(rng, b, n, w, case):
    """(b, n, w) keys sorted lexicographically within each batch row."""
    if case == "all_equal":
        return np.full((b, n, w), 7, np.int32)
    if case == "all_distinct":
        return np.tile(np.arange(n * w, dtype=np.int32).reshape(1, n, w),
                       (b, 1, 1))
    out = []
    for _ in range(b):
        keys = rng.integers(-3, max(n // 6, 2), size=(n, w)).astype(np.int32)
        out.append(keys[np.lexsort(keys.T[::-1])])
    return np.stack(out) if out else np.zeros((0, n, w), np.int32)


CASES = [(0, 2, "random"), (1, 1, "random"), (1, 3, "random"),
         (37, 2, "random"), (300, 1, "random"), (300, 3, "random"),
         (300, 2, "all_equal"), (300, 2, "all_distinct")]


@pytest.mark.parametrize("n,w,case", CASES)
def test_segment_scan_and_run_lengths_match_jax(n, w, case):
    keys = _sorted_keys(np.random.default_rng(n + w), 3, n, w, case)
    seg, start = tbpr.segment_scan_host(_t(keys))
    r_seg, r_start, length = tbpr.run_lengths_host(_t(keys))
    assert torch.equal(seg, r_seg) and torch.equal(start, r_start)
    for got, want in zip(ops.run_lengths(_t(keys)), (seg, start, length)):
        assert torch.equal(got, want)
    for b in range(3):
        jk = jnp.asarray(keys[b])
        for got, want in zip((seg[b], start[b]), jref.segment_scan_ref(jk)):
            np.testing.assert_array_equal(got.numpy(), _np(want))
        for got, want in zip((seg[b], start[b], length[b]),
                             jref.run_lengths_ref(jk)):
            np.testing.assert_array_equal(got.numpy(), _np(want))
        for got, want in zip((seg[b], start[b], length[b]),
                             tref.run_lengths_ref(_t(keys[b]))):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
        for got, want in zip((seg[b], start[b]),
                             tref.segment_scan_ref(_t(keys[b]))):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    if case == "all_equal":
        assert int(seg.max()) == 0 and int(start.max()) == 0
        assert (length == n).all()
    if case == "all_distinct":
        assert (seg == torch.arange(n, dtype=torch.int32)).all()
        assert (start == seg).all() and (length == 1).all()


def _edge_keys(rng, n, block, w, case):
    """(1, n, w) sorted keys for one of the scan's edge shapes."""
    if case == "mid_run":            # a long run mid-way
        keys = _sorted_keys(rng, 1, n, w, "random")
        keys[0, n // 3: 2 * n // 3] = keys[0, n // 3]
    elif case == "one_run":          # one run across every block
        keys = np.full((1, n, w), -3, np.int32)
    elif case == "block_edges":
        # Runs that start at a block's first row, runs of one row at a
        # block's first and last rows, and a block with no run start.
        cuts = np.zeros(n, np.int32)
        for e in range(block, n, block):
            if (e // block) % 3 != 2:
                cuts[e] = 1
                cuts[min(e + 1, n - 1)] = 1
                cuts[e - 1] = 1
        ids = np.cumsum(cuts, dtype=np.int32)
        keys = np.repeat(ids[None, :, None], w, 2)
    else:                            # "sentinels": -2, -3 and INT32_MIN
        vals = np.array([-2**31, -3, -2, 0, 5], np.int32)
        keys = vals[rng.integers(0, len(vals), (1, n, w))]
    return np.ascontiguousarray(keys[:, np.lexsort(keys[0].T[::-1])])


@pytest.mark.parametrize("n,block,w,case", [
    pytest.param(1, 8, 2, "mid_run", id="1-8"),
    pytest.param(45, 8, 2, "mid_run", id="45-8"),
    pytest.param(64, 16, 2, "mid_run", id="64-16"),
    pytest.param(300, 32, 2, "mid_run", id="300-32"),
    (40, 8, 1, "one_run"), (45, 8, 2, "one_run"),
    (48, 8, 1, "block_edges"), (45, 8, 2, "block_edges"),
    (70, 16, 4, "block_edges"), (50, 8, 4, "sentinels"),
    (45, 8, 1, "sentinels"), (64, 8, 3, "sentinels")])
def test_segment_scan_matches_interpret_kernel(n, block, w, case):
    """Blocks smaller than the runs: the carry crosses block boundaries,
    runs start and end at blocks' edges, and n not a multiple of the
    block leaves a ragged last block."""
    keys = _edge_keys(np.random.default_rng(n), n, block, w, case)
    jk = jnp.asarray(keys[0])
    seg, start, length = tbpr.run_lengths_host(_t(keys))
    for got, want in zip((seg[0], start[0], length[0]),
                         jbpr.run_lengths(jk, block=block, interpret=True)):
        np.testing.assert_array_equal(got.numpy(), _np(want))
    for got, want in zip((seg[0], start[0]),
                         jbpr.segment_scan(jk, block=block, interpret=True)):
        np.testing.assert_array_equal(got.numpy(), _np(want))
    if case == "one_run":
        assert int(seg.max()) == 0 and (length == n).all()


# ---------------------------------------------------------------------------
# The executor's sort-merge probe against the reference's
# ---------------------------------------------------------------------------

def _probe_inputs(rng, n_l, n_r, w, domain):
    lk = rng.integers(0, domain, size=(2, n_l, w)).astype(np.int32)
    rk = rng.integers(0, domain, size=(2, n_r, w)).astype(np.int32)
    lv = rng.random((2, n_l)) > 0.2
    rv = rng.random((2, n_r)) > 0.2
    return lk, lv, rk, rv


@pytest.mark.parametrize("n_l,n_r,w,domain", [(1, 1, 1, 3), (200, 300, 2, 12),
                                              (300, 250, 3, 5),
                                              (150, 400, 2, 1)])
def test_sort_merge_probe_matches_jax(n_l, n_r, w, domain):
    rng = np.random.default_rng(n_l + n_r + w)
    lk, lv, rk, rv = _probe_inputs(rng, n_l, n_r, w, domain)
    perm = tex._lexsort_rows(_t(np.concatenate([lk, rk], 1)))
    g_l, g_r = tex._group_ids(_t(lk), _t(rk), True)
    counts, lo, order = tex._probe_sort(_t(lk), _t(lv), _t(rk), _t(rv), True)
    for b in range(2):
        comb = jnp.asarray(np.concatenate([lk[b], rk[b]]))
        np.testing.assert_array_equal(perm[b].numpy(),
                                      _np(jex._lexsort_rows(comb)))
        j_gl, j_gr = jex._group_ids(jnp.asarray(lk[b]), jnp.asarray(rk[b]),
                                    False)
        np.testing.assert_array_equal(g_l[b].numpy(), _np(j_gl))
        np.testing.assert_array_equal(g_r[b].numpy(), _np(j_gr))
        for got, want in zip((counts[b], lo[b], order[b]),
                             jex._probe_sort(jnp.asarray(lk[b]),
                                             jnp.asarray(lv[b]),
                                             jnp.asarray(rk[b]),
                                             jnp.asarray(rv[b]), False)):
            np.testing.assert_array_equal(got.numpy(), _np(want))
    assert int(counts.sum()) > 0 or n_l == 1


def test_sort_merge_probe_kernel_arm_of_the_reference():
    """The reference's kernel arm (interpret-mode segment_scan) gives the
    same (counts, lo, perm) as its plain arm and as the port."""
    rng = np.random.default_rng(5)
    lk, lv, rk, rv = _probe_inputs(rng, 60, 80, 2, 6)
    counts, lo, order = tex._probe_sort(_t(lk), _t(lv), _t(rk), _t(rv), True)
    for got, want in zip((counts[0], lo[0], order[0]),
                         jex._probe_sort(jnp.asarray(lk[0]),
                                         jnp.asarray(lv[0]),
                                         jnp.asarray(rk[0]),
                                         jnp.asarray(rv[0]), True)):
        np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("w,rows", [(0, 2048), (1, 2048), (4, 2048),
                                    (5, 1024), (9, 512), (16, 512),
                                    (33, 256), (9000, 256)])
def test_seg_tile_rows(w, rows):
    """The scan tile: 2,048 rows, halved while their words pass 8,192,
    never below one round of 32 rows for each of the block's 8 warps."""
    assert tbpr.seg_tile_rows(w) == rows
