"""The fused expansion (`expand_rows` with `cols`) against the JAX package.

`expand_rows_host(..., cols=...)` must equal, bit for bit, JAX's
`expand_rows` followed by the epilogue of the JAX `_local_join`
(src/repro/core/executor.py: the step's columns carved out of the expanded
rows, the -1 fill of rows past the matches, and on the last step the
query's attribute order), per destination.  `EXPAND_CASES` and
`expand_inputs` are shared with the card tests (tests/test_torch_cuda.py),
which hold the CUDA kernel against this plain version; JAX is imported only
inside the tests here.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import scatter_pack as tsp

INVALID = -1
# Two-way's last step: acc (A, B, cell) ++ S (B, C, cell); the step keeps
# A, B, C, cell and the query's order (A, B, C) drops the cell.
TWO_WAY_STEP = ([0, 1, 4, 2], [0, 1, 2])
# name -> (step columns, order or None): the composed map is
# [step[i] for i in order].
EXPAND_CASES = {
    "identity": ([0, 1, 2, 3, 4, 5], None),
    "reorder": ([4, 0, 5, 2, 1, 3], None),
    "drop_cell": TWO_WAY_STEP,
    "overflow": TWO_WAY_STEP,
    "all_counts_zero": TWO_WAY_STEP,
    "zero_run": TWO_WAY_STEP,
    "single_rows": TWO_WAY_STEP,
}


def composed_cols(name):
    step, order = EXPAND_CASES[name]
    return tuple(step) if order is None else tuple(step[i] for i in order)


def random_probe(rng, b, n_l, n_r, p_hit=0.6):
    """A probe's (counts, lo, perm), numpy int32 (b, ·): the right side cut
    into contiguous groups of a random permutation; each left row hits one
    group (or none) and reads it whole."""
    counts = np.zeros((b, n_l), np.int32)
    lo = np.zeros((b, n_l), np.int32)
    perm = np.zeros((b, n_r), np.int32)
    for i in range(b):
        n_cut = min(n_r - 1, max(n_r // 3, 0))
        cuts = np.sort(rng.choice(np.arange(1, n_r), n_cut, replace=False)) \
            if n_cut else np.zeros(0, np.int64)
        starts = np.concatenate([[0], cuts])
        lens = np.diff(np.concatenate([starts, [n_r]]))
        g = rng.integers(0, len(starts), n_l)
        hit = rng.random(n_l) < p_hit
        lo[i] = starts[g]
        counts[i] = np.where(hit, lens[g], 0)
        perm[i] = rng.permutation(n_r)
    return counts, lo, perm


def rows(rng, b, n, w, domain=1000):
    return rng.integers(0, domain, (b, n, w)).astype(np.int32)


def expand_inputs(name, seed=0):
    """(left, right, counts, lo, perm, cap) of a case, as CPU tensors."""
    rng = np.random.default_rng(seed)
    b, wl, wr = 2, 3, 3
    if name == "zero_run":
        # 10^4 zero-count left rows between two matches.
        n_l, n_r = 10_002, 5
        counts = np.zeros((b, n_l), np.int32)
        lo = rng.integers(0, n_r, (b, n_l)).astype(np.int32)
        counts[:, 0], lo[:, 0] = 3, 0
        counts[:, -1], lo[:, -1] = 2, 3
        perm = np.stack([rng.permutation(n_r) for _ in range(b)]
                        ).astype(np.int32)
        cap = 9
    elif name == "single_rows":
        n_l = n_r = 1
        counts = np.array([[1], [0]], np.int32)
        lo = np.zeros((b, 1), np.int32)
        perm = np.zeros((b, 1), np.int32)
        cap = 3
    else:
        n_l, n_r = 120, 90
        counts, lo, perm = random_probe(rng, b, n_l, n_r)
        if name == "all_counts_zero":
            counts[:] = 0
        total = int(counts.sum(1).max())
        cap = max(total // 2, 1) if name == "overflow" else total + 37
    left, right = rows(rng, b, n_l, wl), rows(rng, b, n_r, wr)
    return tuple(torch.from_numpy(x) for x in (left, right, counts, lo, perm)
                 ) + (cap,)


def jax_expand_then_epilogue(jsp, jnp, left, right, counts, lo, perm, cap,
                             step, order):
    """JAX `expand_rows` (its host twin) and `_local_join`'s epilogue on one
    destination: static column slices, the -1 fill, the final order."""
    exp, valid = jsp.expand_rows_host(*(jnp.asarray(x.numpy()) for x in
                                        (left, right, counts, lo, perm)),
                                      cap=cap)
    new_rows = jnp.concatenate([exp[:, c:c + 1] for c in step], axis=1)
    acc = jnp.where(valid[:, None], new_rows, INVALID)
    if order is not None:
        acc = acc[:, jnp.asarray(order)]
    return np.asarray(acc), np.asarray(valid)


@pytest.mark.parametrize("name", list(EXPAND_CASES))
def test_fused_expansion_equals_jax_expand_and_epilogue(name):
    import jax.numpy as jnp
    from repro.kernels import scatter_pack as jsp
    left, right, counts, lo, perm, cap = expand_inputs(name)
    step, order = EXPAND_CASES[name]
    cols = composed_cols(name)
    out, valid = tsp.expand_rows_host(left, right, counts, lo, perm, cap,
                                      cols=cols)
    assert out.shape == (left.shape[0], cap, len(cols))
    assert out.dtype == torch.int32 and valid.dtype == torch.bool
    for b in range(left.shape[0]):
        want, want_valid = jax_expand_then_epilogue(
            jsp, jnp, left[b], right[b], counts[b], lo[b], perm[b], cap,
            step, order)
        np.testing.assert_array_equal(out[b].numpy(), want)
        np.testing.assert_array_equal(valid[b].numpy(), want_valid)
    # Through the dispatch, and the full expansion unchanged by cols.
    got = ops.expand_rows(left, right, counts, lo, perm, cap, cols=cols)
    assert torch.equal(got[0], out) and torch.equal(got[1], valid)
    full, full_valid = tsp.expand_rows_host(left, right, counts, lo, perm,
                                            cap)
    assert torch.equal(full_valid, valid)
    assert torch.equal(torch.where(valid[..., None], full[..., list(cols)],
                                   INVALID), out)


@pytest.mark.parametrize("cols", [(), tuple(range(17)), (6,), (-1,)])
def test_expand_rows_rejects_cols_it_does_not_take(cols):
    left, right, counts, lo, perm, cap = expand_inputs("drop_cell")
    with pytest.raises(ValueError):
        ops.expand_rows(left, right, counts, lo, perm, cap, cols=cols)


def test_expand_rows_on_empty_sides_with_cols():
    left = torch.zeros((2, 0, 3), dtype=torch.int32)
    right = torch.zeros((2, 4, 3), dtype=torch.int32)
    out, valid = ops.expand_rows(left, right, torch.zeros((2, 0), dtype=torch.int32),
                                 torch.zeros((2, 0), dtype=torch.int32),
                                 torch.arange(4, dtype=torch.int32).expand(2, 4),
                                 5, cols=(0, 4))
    assert out.shape == (2, 5, 2) and bool((out == INVALID).all())
    assert not valid.any()
