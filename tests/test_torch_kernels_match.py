"""The match kernels' plan and hash on the CPU: `match_plan` (arm, table
size, partitions, grid), `match_slot` (a key's home slot) and
`match_partition`, which csrc/build_probe.cu mirrors, and the tables'
design run in numpy: one table a partition, 64-bit slot words (key << 32 |
count or least index + 1, the word 0 empty), linear probing from the home
slot, inserts in any order.  The kernels themselves run only on the card
(tests/test_torch_cuda.py); the plain versions are held against the JAX
package in test_torch_kernels_library.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.hypercube import multiply_shift
from repro_torch.kernels import build_probe as bpr

INT_MIN, INT_MAX = -2**31, 2**31 - 1
EDGE_KEYS = [INT_MIN, INT_MIN + 1, -2, -1, 0, 1, 2, INT_MAX - 1, INT_MAX]
MULT = 2654435769


def shared_limit():
    """The largest build side whose table fits the shared arm."""
    n_b = 1
    while bpr.match_plan(1, n_b + 1)[0] == bpr.MATCH_SHARED:
        n_b += 1
    return n_b


def keys_with_home(n, n_p, n_b, rng):
    """n distinct int32 keys that all fall in partition 0 of
    match_plan(n_p, n_b) and on its table's last slot, so that their run
    wraps: hashes picked with those bits, then multiplied by MULT's inverse
    mod 2^32."""
    _, slots, pbits, _ = bpr.match_plan(n_p, n_b)
    low = 32 - pbits                     # the hash's bits below the partition
    first = -(-((slots - 1) << 32) // slots) >> pbits   # of the last slot
    h = rng.choice(np.arange(first, 1 << low, dtype=np.int64), n,
                   replace=False)
    keys = (h * pow(MULT, -1, 1 << 32)) & 0xFFFFFFFF
    keys = torch.from_numpy(keys.astype(np.uint32).view(np.int32))
    assert (bpr.match_slot(keys, slots, pbits) == slots - 1).all()
    assert (bpr.match_partition(keys, pbits) == 0).all()
    return keys.numpy()


@pytest.mark.parametrize("n_p", [1, 200, 1024, 1025, 16287, 1 << 21])
@pytest.mark.parametrize("n_b", [1, 2, 7, 767, 4096, 16287, 17919, 17920,
                                 70001, 300000, 1 << 21])
def test_match_plan_invariants(n_p, n_b):
    """The table outgrows the build side at a load under 0.7; the shared
    arm's table fits its bytes, its partitions are no more than the keys
    and its grid a whole number of partitions' slices, none without probe
    keys and no more than the SMs hold at once."""
    arm, slots, pbits, blocks = bpr.match_plan(n_p, n_b)
    assert slots > n_b
    assert n_b / slots < bpr.MATCH_LOAD_NUM / bpr.MATCH_LOAD_DEN
    assert blocks >= 1
    if arm == bpr.MATCH_DEVICE:
        assert 8 * (10 * n_b // 7 + 1) > bpr.MATCH_SHARED_BYTES
        assert pbits == 0 and blocks <= 8 * bpr.SM_COUNT
        return
    assert 8 * slots <= bpr.MATCH_SHARED_BYTES
    assert 0 <= pbits <= bpr.MATCH_MAX_PART_BITS and 1 << pbits <= n_b
    assert blocks % (1 << pbits) == 0
    slices = blocks >> pbits
    per_sm = max(1, min(2, bpr.SM_SHARED_BYTES // (8 * slots + 1024)))
    assert (slices - 1) * bpr.MATCH_SHARED_THREADS < n_p
    assert blocks <= bpr.SM_COUNT * per_sm


@pytest.mark.parametrize("n_p,n_b,want", [
    (16287, 16287, (25600, 5, 128)),    # the tail cell's pair
    (16384, 4096, (16384, 4, 128)),     # the random pair
    (1536, 767, (3068, 4, 32)),         # the heavy cell's pair
    (1 << 21, 3000, (12000, 0, 264)),   # n_p >> n_b: slices only
    (1, 17919, (25600, 7, 128))])       # n_p << n_b: partitions only
def test_match_plan_at_the_library_pairs(n_p, n_b, want):
    assert bpr.match_plan(n_p, n_b) == (bpr.MATCH_SHARED, *want)


def test_match_plan_switches_arm_exactly_at_the_shared_limit():
    lim = shared_limit()
    assert lim == 17919      # 25,599 slots at load 0.7 within 200 KB
    for n_p in (1, 16384):
        assert bpr.match_plan(n_p, lim)[0] == bpr.MATCH_SHARED
        assert bpr.match_plan(n_p, lim + 1)[0] == bpr.MATCH_DEVICE
    assert 8 * bpr.match_plan(1, lim + 1)[1] > bpr.MATCH_SHARED_BYTES


def test_match_plan_refuses_a_table_past_int32():
    n_b = 2**31 * bpr.MATCH_LOAD_NUM // bpr.MATCH_LOAD_DEN
    with pytest.raises(ValueError):
        bpr.match_plan(1, n_b)
    assert bpr.match_plan(1, n_b - 2)[1] < 2**31


@pytest.mark.parametrize("slots", [2, 3, 1096, 23268, 1 << 12, 1 << 20,
                                   2995932, 2**31 - 1])
@pytest.mark.parametrize("pbits", [0, 3, 7])
def test_match_slot_is_the_fast_range_of_multiply_shift(slots, pbits):
    """Edge keys and random keys of every int32 value: numpy's uint64
    fast range of h = uint32(key) * MULT below its top pbits bits, the
    partition those bits; at a power of two, the planner's multiply_shift
    with seed 1 (the hash's top bits)."""
    rng = np.random.default_rng(slots + pbits)
    keys = np.concatenate([EDGE_KEYS, rng.integers(INT_MIN, INT_MAX, 5000,
                                                   endpoint=True)])
    keys = keys.astype(np.int32)
    tk = torch.from_numpy(keys)
    got = bpr.match_slot(tk, slots, pbits).numpy()
    h = keys.astype(np.uint32) * np.uint32(MULT)
    low = (h << np.uint32(pbits)).astype(np.uint64)
    want = (low * np.uint64(slots)) >> np.uint64(32)
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.min() >= 0 and got.max() < slots
    part = bpr.match_partition(tk, pbits).numpy()
    np.testing.assert_array_equal(part, h >> np.uint32(32 - pbits)
                                  if pbits else 0)
    if slots & (slots - 1) == 0 and pbits == 0:
        np.testing.assert_array_equal(got, multiply_shift(keys, 1, slots))


def _table_join(probe, build, first, seed):
    """The kernels' tables in numpy, on match_plan's (slots, pbits): one
    table a partition; build keys inserted in a random order, each claiming
    an empty slot (word 0) or updating its key's word (count added, least
    index + 1 kept); each probe walks its partition's table from its home
    slot to its key or an empty slot.  Returns (counts or first indices,
    the tables' occupied words)."""
    _, slots, pbits, _ = bpr.match_plan(probe.shape[0], build.shape[0])
    tables = {}

    def where(keys):
        tk = torch.from_numpy(keys)
        return (bpr.match_partition(tk, pbits).tolist(),
                bpr.match_slot(tk, slots, pbits).tolist())

    b_part, b_home = where(build)
    for j in np.random.default_rng(seed).permutation(build.shape[0]):
        key, value = int(build[j]), int(j) + 1 if first else 1
        table = tables.setdefault(b_part[j], [0] * slots)
        word = (key & 0xFFFFFFFF) << 32 | value
        h = b_home[j]
        while True:
            cur = table[h]
            if cur == 0:
                table[h] = word
                break
            if cur >> 32 == word >> 32:
                table[h] = min(cur, word) if first else cur + value
                break
            h = (h + 1) % slots
    out = np.empty(probe.shape[0], np.int64)
    p_part, p_home = where(probe)
    for i, key in enumerate(probe):
        table, h = tables.get(p_part[i], [0] * slots), p_home[i]
        while table[h] != 0 and table[h] >> 32 != int(key) & 0xFFFFFFFF:
            h = (h + 1) % slots
        low = table[h] & 0xFFFFFFFF
        out[i] = (low - 1 if table[h] != 0 else -1) if first else low
    return out, [w for t in tables.values() for w in t if w]


@pytest.mark.parametrize("case", ["edge keys", "one slot", "heavy key",
                                  "random"])
def test_table_design_equals_the_plain_versions(case):
    """Whatever the insert order, the tables' answers are the plain
    versions' bit for bit: edge keys (INT_MIN, INT_MAX, 0, -1, -2, whose
    words must never read as empty) on both sides, distinct keys that all
    share one partition and one home slot (a run that wraps), one heavy
    key, and keys of a small domain."""
    rng = np.random.default_rng(len(case))
    if case == "edge keys":
        build = rng.choice(EDGE_KEYS, 600).astype(np.int32)
        probe = np.array(EDGE_KEYS + [3, -3], np.int32)
    elif case == "one slot":
        build = np.repeat(keys_with_home(150, 53, 300, rng), 2)
        probe = np.concatenate([build[::6], [5, 6, 7]]).astype(np.int32)
        assert probe.shape[0] == 53
    elif case == "heavy key":
        build = np.full(700, -1, np.int32)
        build[rng.random(700) < 0.1] = INT_MAX
        probe = np.array([-1, INT_MAX, 0, INT_MIN], np.int32)
    else:
        build = rng.integers(0, 300, 900).astype(np.int32)
        probe = rng.integers(0, 400, 500).astype(np.int32)
    tp, tb = torch.from_numpy(probe), torch.from_numpy(build)
    for first, plain in ((False, bpr.match_counts_host),
                         (True, bpr.first_match_host)):
        want = plain(tp, tb).numpy()
        for seed in (0, 1):
            got, words = _table_join(probe, build, first, seed)
            np.testing.assert_array_equal(got, want)
        assert len(words) == len(np.unique(build))


def test_plain_versions_follow_the_oracles_at_edge_keys():
    """INT_MIN, INT_MAX, 0, -1 and -2 on both sides are data for the plain
    versions as for JAX's match_counts_ref / first_match_ref."""
    rng = np.random.default_rng(9)
    build = rng.choice(EDGE_KEYS, 300).astype(np.int32)
    probe = np.array(EDGE_KEYS + [7], np.int32)
    jp, jb = jnp.asarray(probe), jnp.asarray(build)
    tp, tb = torch.from_numpy(probe), torch.from_numpy(build)
    np.testing.assert_array_equal(bpr.match_counts_host(tp, tb).numpy(),
                                  np.asarray(jref.match_counts_ref(jp, jb)))
    np.testing.assert_array_equal(bpr.first_match_host(tp, tb).numpy(),
                                  np.asarray(jref.first_match_ref(jp, jb)))
