"""Plain torch versions of the reduce-side kernels (join_hash, build_table,
probe_tables, expand_rows) vs the JAX package.

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
from repro_torch.kernels import ops
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


@pytest.mark.parametrize("n_r,passes", [
    (1, 1), (2, 1), (256, 1), (257, 2), (1 << 16, 2), ((1 << 16) + 1, 3),
    (1 << 20, 3), (1 << 24, 3), ((1 << 24) + 1, 4), (1 << 29, 4)])
def test_probe_passes_cover_every_round(n_r, passes):
    """The CUDA probe's digit plan: enough RANK_DIGIT_BITS-bit digits for
    rounds 0 .. n_r - 1 (a bucket has no more keys than rows)."""
    assert tjp.probe_passes(n_r) == passes
    assert passes <= tjp.PROBE_MAX_PASSES
    assert (n_r - 1) >> (tjp.RANK_DIGIT_BITS * passes) == 0


def test_probe_passes_refuse_rows_past_the_range():
    with pytest.raises(KernelError, match="past"):
        tjp.probe_passes(tjp.MAX_PROBE_ROWS + 1)


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


def _colliding_keys(n_keys, w, bits, rng):
    """n_keys distinct keys (w columns) that all hash to one bucket."""
    first = rng.integers(0, 1 << 20, (1, w)).astype(np.int32)
    want = int(tjp.join_hash_host(torch.from_numpy(first[None]),
                                  torch.ones((1, 1), dtype=torch.bool),
                                  bits)[0, 0])
    cand = rng.integers(0, 1 << 20, (4096, w)).astype(np.int32)
    hit = tjp.join_hash_host(torch.from_numpy(cand[None]),
                             torch.ones((1, 4096), dtype=torch.bool),
                             bits)[0].numpy() == want
    keys = np.unique(np.concatenate([first, cand[hit]]), axis=0)
    assert len(keys) >= n_keys
    return keys[:n_keys]


def _probe_keys(recipe, n_l, n_r, w, bits, domain, seed):
    """(lk, lv, rk, rv) numpy for the probe: "random" keys of `domain`
    values a column; "deep" (few hundred distinct right keys, half the
    left rows copies of right rows); "one_key" / "two_keys" (every valid
    right row one key, or two keys of one bucket interleaved); "absent"
    (left keys from a range the right side never draws)."""
    rng = np.random.default_rng(seed)
    lk, lv = _keys(rng, 2, n_l, w, domain)
    rk, rv = _keys(rng, 2, n_r, w, domain)
    if recipe == "deep":
        pick = rng.integers(0, n_r, (2, n_l // 2))
        lk[:, : n_l // 2] = np.take_along_axis(rk, pick[..., None], 1)
    elif recipe in ("one_key", "two_keys"):
        keys = _colliding_keys(2, w, bits, rng)
        which = np.arange(n_r) % 2 if recipe == "two_keys" else np.zeros(
            n_r, np.int64)
        rk[:] = keys[which]
        lk[:, ::3] = keys[rng.integers(0, 2, (2, len(range(0, n_l, 3))))]
    elif recipe == "absent":
        lk[:, ::2] += domain
    return lk, lv, rk, rv


def _probe_case(n_l, n_r, bits, domain, w=2, recipe="random", id_=None):
    return pytest.param(n_l, n_r, w, bits, domain, recipe,
                        id=id_ or f"{n_l}-{n_r}-{w}-{bits}-{recipe}")


@pytest.mark.parametrize("n_l,n_r,w,bits,domain,recipe", [
    _probe_case(0, 5, 3, 4, id_="0-5-3-4"),
    _probe_case(6, 0, 3, 4, id_="6-0-3-4"),
    _probe_case(50, 40, 1, 6, id_="50-40-1-6"),
    _probe_case(120, 90, 2, 10, id_="120-90-2-10"),
    _probe_case(200, 300, 9, 25, id_="200-300-9-25"),
    _probe_case(100, 100, 7, 3, id_="100-100-7-3"),
    # the inputs the CUDA probe must get right: deep rounds (one bucket
    # of each of two hash values, a few hundred keys), every valid right
    # row in one bucket with one key and with two keys interleaved, w = 1
    # and 3, left keys absent from the right
    _probe_case(150, 400, 1, 1 << 20, recipe="deep"),
    _probe_case(30, 70, 5, 1 << 20, recipe="one_key"),
    _probe_case(30, 70, 4, 1 << 20, w=3, recipe="two_keys"),
    _probe_case(90, 60, 3, 12, w=1), _probe_case(60, 90, 5, 6, w=3),
    _probe_case(80, 50, 4, 8, recipe="absent")])
def test_probe_and_expand_match_jax(n_l, n_r, w, bits, domain, recipe):
    lk, lv, rk, rv = _probe_keys(recipe, n_l, n_r, w, bits, domain,
                                 n_l * 13 + n_r + bits)
    tlk, trk = torch.from_numpy(lk), torch.from_numpy(rk)
    tlv, trv = torch.from_numpy(lv), torch.from_numpy(rv)
    bl = tjp.join_hash_host(tlk, tlv, bits)
    br, rank, hist = tjp.build_table_host(trk, trv, bits)
    counts, lo, perm = tjp.probe_tables_host(tlk, bl, trk, br, rank, hist,
                                             bits)
    if recipe in ("one_key", "two_keys"):
        assert int((hist > 0).sum()) == 2      # one bucket a batch row
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


def test_probe_tables_on_the_cpu_runs_the_plain_version_and_launches_nothing():
    lk, lv, rk, rv = _probe_keys("two_keys", 30, 70, 2, 4, 1 << 20, 3)
    tlk, trk = torch.from_numpy(lk), torch.from_numpy(rk)
    bl = tjp.join_hash_host(tlk, torch.from_numpy(lv), 4)
    table = tjp.build_table_host(trk, torch.from_numpy(rv), 4)
    want = tjp.probe_tables_host(tlk, bl, trk, *table, 4)
    ops.reset_launches()
    for use_kernels in (True, False):
        got = ops.probe_tables(tlk, bl, trk, *table, 4,
                               use_kernels=use_kernels)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)
    assert ops.LAUNCHES["probe_tables"] == 0
    with pytest.raises(KernelError, match="CUDA"):
        tjp.probe_tables_cuda(tlk, bl, trk, *table, 4)


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
