"""Plain torch versions of the reduce-side kernels (join_hash, build_table,
expand_rows) and probe_tables vs the JAX package.

The same numpy inputs go through the JAX functions (the `*_host` twins, the
Pallas kernels in interpret mode at tiny sizes, the ref.py oracles) and the
port's torch counterparts on the CPU; int32 outputs must be bit-identical.
The port's functions carry a leading batch axis (sources or destinations):
each slice is held against one call of the single-device JAX function.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import join_probe as jjp
from repro.kernels import ref as jref
from repro.kernels import scatter_pack as jsp
from repro_torch.kernels import join_probe as tjp
from repro_torch.kernels import ref as tref
from repro_torch.kernels._build import KernelError
from repro_torch.kernels import scatter_pack as tsp


def _np(x):
    return np.asarray(x)


def _keys(rng, b, n, w, domain, invalid_frac=0.2):
    keys = rng.integers(0, domain, size=(b, n, w)).astype(np.int32)
    valid = rng.random((b, n)) > invalid_frac
    return keys, valid


def _case(n, w, bits, recipe="few", id_=None):
    return pytest.param(n, w, bits, recipe,
                        id=id_ or f"{n}-{w}-{bits}-{recipe}")


@pytest.mark.parametrize("n,w,bits,recipe", [
    _case(0, 2, 3, id_="0-2-3"), _case(37, 1, 1, id_="37-1-1"),
    _case(200, 2, 2, id_="200-2-2"), _case(300, 3, 7, id_="300-3-7"),
    _case(500, 2, 12, id_="500-2-12"),
    # the shapes the card tests give the CUDA build: every valid row in one
    # bucket (the heavy hitter's), and only the sentinel
    _case(300, 2, 7, "one_bucket"), _case(500, 2, 12, "one_bucket"),
    _case(300, 3, 7, "invalid"), _case(500, 2, 12, "invalid")])
def test_join_hash_and_build_table_match_jax(n, w, bits, recipe):
    rng = np.random.default_rng(n + bits)
    keys, valid = _keys(rng, 2, n, w, 30)
    valid[1, : n // 3] = False
    if recipe == "one_bucket":
        keys[:] = keys[0, 0]
    if recipe == "invalid":
        valid[:] = False
    tk, tv = torch.from_numpy(keys), torch.from_numpy(valid)
    t_hash = tjp.join_hash_host(tk, tv, bits)
    t_bkt, t_rank, t_hist = tjp.build_table_host(tk, tv, bits)
    for b in range(2):
        jk, jv = jnp.asarray(keys[b]), jnp.asarray(valid[b])
        np.testing.assert_array_equal(
            t_hash[b].numpy(), _np(jjp.join_hash_host(jk, jv, n_bits=bits)))
        np.testing.assert_array_equal(
            t_hash[b].numpy(), tref.join_hash_ref(tk[b], tv[b], bits).numpy())
        for got, want in zip((t_bkt[b], t_rank[b], t_hist[b]),
                             jjp.build_table_host(jk, jv, n_bits=bits)):
            np.testing.assert_array_equal(got.numpy(), _np(want))
        for got, want in zip((t_bkt[b], t_rank[b], t_hist[b]),
                             tref.build_table_ref(tk[b], tv[b], bits)):
            np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("n_bits", [1, 8, 10, 11, 16, 20, 21, 30])
def test_build_digits_cover_the_bucket_in_fewest_passes(n_bits):
    """The CUDA build's digit plan: as few digits of at most MAX_DIGIT_BITS
    bits as cover n_bits, the top digit keeping 1 to digit_bits of them."""
    passes, digit_bits = tjp.build_digits(n_bits)
    assert passes == -(-n_bits // tjp.MAX_DIGIT_BITS)
    assert 1 <= digit_bits <= tjp.MAX_DIGIT_BITS
    assert 1 <= n_bits - (passes - 1) * digit_bits <= digit_bits


@pytest.mark.parametrize("n_bits", [0, 31])
def test_build_digits_refuse_bits_past_the_range(n_bits):
    with pytest.raises(KernelError, match=f"n_bits {n_bits}"):
        tjp.build_digits(n_bits)


@pytest.mark.parametrize("multi_pass", [False, True])
def test_build_table_matches_interpret_kernel(multi_pass):
    rng = np.random.default_rng(4)
    keys, valid = _keys(rng, 1, 70, 2, 12)
    valid[0, :5] = False
    for bits in (2, 4):
        jk, jv = jnp.asarray(keys[0]), jnp.asarray(valid[0])
        want = jjp.build_table(jk, jv, n_bits=bits, multi_pass=multi_pass,
                               interpret=True)
        got = tjp.build_table_host(torch.from_numpy(keys),
                                   torch.from_numpy(valid), bits)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), _np(w_))
        np.testing.assert_array_equal(
            got[0][0].numpy(),
            _np(jjp.join_hash(jk, jv, n_bits=bits, interpret=True)))


@pytest.mark.parametrize("n_l,n_r,bits,domain", [
    (0, 5, 3, 4), (6, 0, 3, 4), (50, 40, 1, 6), (120, 90, 2, 10),
    (200, 300, 9, 25), (100, 100, 7, 3)])
def test_probe_and_expand_match_jax(n_l, n_r, bits, domain):
    rng = np.random.default_rng(n_l * 13 + n_r + bits)
    lk, lv = _keys(rng, 2, n_l, 2, domain)
    rk, rv = _keys(rng, 2, n_r, 2, domain)
    tlk, trk = torch.from_numpy(lk), torch.from_numpy(rk)
    tlv, trv = torch.from_numpy(lv), torch.from_numpy(rv)
    bl = tjp.join_hash_host(tlk, tlv, bits)
    br, rank, hist = tjp.build_table_host(trk, trv, bits)
    counts, lo, perm = tjp.probe_tables(tlk, bl, trk, br, rank, hist, bits)
    left = torch.cat([tlk, tlk * 5 + 1], -1)
    right = torch.cat([trk, trk - 7], -1)
    cap = max(8, int(counts.sum(1).max()) - 3)      # ragged: may truncate
    out, valid = tsp.expand_rows_host(left, right, counts, lo, perm, cap)
    for b in range(2):
        jl, jr = jnp.asarray(lk[b]), jnp.asarray(rk[b])
        jlv, jrv = jnp.asarray(lv[b]), jnp.asarray(rv[b])
        jbl = jjp.join_hash_host(jl, jlv, n_bits=bits)
        jbr, jrank, jhist = jjp.build_table_host(jr, jrv, n_bits=bits)
        jc, jlo, jperm = jjp.probe_tables(jl, jbl, jr, jbr, jrank, jhist, bits)
        np.testing.assert_array_equal(counts[b].numpy(), _np(jc))
        np.testing.assert_array_equal(lo[b].numpy(), _np(jlo))
        np.testing.assert_array_equal(perm[b].numpy(), _np(jperm))
        jleft = jnp.asarray(left[b].numpy())
        jright = jnp.asarray(right[b].numpy())
        jout, jvalid = jsp.expand_rows_host(jleft, jright, jc, jlo, jperm,
                                            cap=cap)
        np.testing.assert_array_equal(out[b].numpy(), _np(jout))
        np.testing.assert_array_equal(valid[b].numpy(), _np(jvalid))
        rout, rvalid = tref.expand_rows_ref(left[b], right[b], counts[b],
                                            lo[b], perm[b], cap)
        np.testing.assert_array_equal(rout.numpy(), _np(jout))
        np.testing.assert_array_equal(rvalid.numpy(), _np(jvalid))
        if n_l and n_r:
            kout, kvalid = jsp.expand_rows(jleft, jright, jc, jlo, jperm,
                                           cap=cap, interpret=True)
            np.testing.assert_array_equal(out[b].numpy(), _np(kout))
            np.testing.assert_array_equal(valid[b].numpy(), _np(kvalid))


def test_join_probe_ref_matches_jax():
    rng = np.random.default_rng(8)
    lk, lv = _keys(rng, 1, 30, 2, 5)
    rk, rv = _keys(rng, 1, 25, 2, 5)
    got = tref.join_probe_ref(torch.from_numpy(lk[0]), torch.from_numpy(lv[0]),
                              torch.from_numpy(rk[0]), torch.from_numpy(rv[0]),
                              64)
    want = jref.join_probe_ref(jnp.asarray(lk[0]), jnp.asarray(lv[0]),
                               jnp.asarray(rk[0]), jnp.asarray(rv[0]), 64)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w_))
