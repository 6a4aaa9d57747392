"""The port's chunked exchange (`overlap_shuffle = C ≥ 2`) and its two
test oracles (`_local_join_dense`, `_pack_buckets_argsort`) vs the JAX
package, n_dev = 8.

The chunked session must equal the JAX session under the same C bit for
bit (fragments arrive chunk-major, then source-major, in both), and
canonically equal the serial path and `reference_join`."""
import functools

import numpy as np
import pytest
import torch

from _torch_port_cases import N_DEV, assert_same_result, out_capacity
from repro.core import plan_skew_join as jax_plan
from repro.core import running_example as jax_running_example
from repro.core import two_way as jax_two_way
from repro.core.executor import ExecutorConfig as JaxConfig
from repro.core.executor import ShardedJoinExecutor as JaxExecutor
from repro.core.executor import _local_join_dense as jax_local_join_dense
from repro.core.executor import _pack_buckets_argsort as jax_pack_argsort
from repro.launch.mesh import make_mesh_compat
from repro_torch.core import (canonical, plan_skew_join, reference_join,
                              running_example, two_way)
from repro_torch.core.executor import (ExecutorConfig, ShardedJoinExecutor,
                                       _local_join, _local_join_dense,
                                       _pack_buckets, _pack_buckets_argsort)
from repro_torch.data import skewed_join_dataset


def _data(seed, n, domain, skew):
    return skewed_join_dataset(two_way(), n, domain, skew={"B": skew},
                               seed=seed)


@functools.lru_cache(maxsize=None)
def _jax_run(seed, n, domain, skew, chunks):
    """The JAX session's caps and first result under overlap_shuffle =
    chunks (made once per case)."""
    data = _data(seed, n, domain, skew)
    ex = JaxExecutor(jax_plan(jax_two_way(), data, 8),
                     make_mesh_compat((N_DEV,), ("cells",)),
                     config=JaxConfig(out_capacity=_cap_out(data),
                                      overlap_shuffle=chunks))
    s = ex.session().prepare(data)
    res = s.run_batch()
    return dict(s.caps), {key: np.asarray(res[key]) for key in res}


def _cap_out(data):
    return out_capacity(two_way(), data)     # holds the whole join


def _port(data, chunks, **cfg):
    plan = plan_skew_join(two_way(), data, 8)
    return ShardedJoinExecutor(
        plan, N_DEV, ExecutorConfig(out_capacity=_cap_out(data),
                                    overlap_shuffle=chunks, **cfg),
        device="cpu")


@pytest.mark.parametrize("chunks", [1, 2, 4, 7])     # 7: ragged tiles
def test_overlap_shuffle_matches_serial_and_reference(chunks):
    """Under the same C the port's result is the JAX session's bit for
    bit; canonically it is the serial path's and reference_join's."""
    case = (21, 601, 40, 1.9)
    data = _data(*case)
    expect = reference_join(two_way(), data)
    got_serial = canonical(_port(data, 0).result_rows(data))
    np.testing.assert_array_equal(got_serial, expect)
    ex = _port(data, chunks)
    s = ex.session().prepare(data)
    jcaps, jres = _jax_run(*case, chunks)
    assert s.caps == jcaps
    res = s.run_batch()
    assert_same_result(res, jres)
    np.testing.assert_array_equal(canonical(res["rows"][res["valid"]]),
                                  got_serial)
    assert ex.compile_count == 1


@pytest.mark.parametrize("arm", [
    dict(fuse_map=False), dict(fuse_map=False, hash_reduce=False),
    dict(hash_reduce=False), dict(fuse_map=False, use_kernels=False)],
    ids=["staged+hash", "staged+sort", "fused+sort", "staged plain"])
def test_overlap_shuffle_staged_and_ref_paths(arm):
    """Chunking composes with the staged map, the sort-merge reduce and
    the plain versions: the JAX fused + hash session's bits at C = 3 (the
    reference pins its arms bit-identical) and reference_join."""
    case = (22, 300, 30, 1.5)
    data = _data(*case)
    res = _port(data, 3, **arm).run(data)
    assert_same_result(res, _jax_run(*case, 3)[1])
    np.testing.assert_array_equal(canonical(res["rows"][res["valid"]]),
                                  reference_join(two_way(), data))


def test_overlap_warm_batches_zero_new_compiles():
    """Chunked sessions stream warm: repeat and smaller batches build no
    step, per-chunk caps hold, results stay reference-exact."""
    data = _data(23, 640, 50, 1.7)
    expect = reference_join(two_way(), data)
    half = {name: arr[: len(arr) // 2] for name, arr in data.items()}
    for chunks in (2, 4):
        ex = _port(data, chunks)
        ses = ex.session().prepare(data)
        ses.run_batch()
        assert ex.compile_count == 1
        for _ in range(3):
            res = ses.run_batch()
        res_half = ses.run_batch(half)
        assert ex.compile_count == 1 and ex.step_hits == 4
        assert res["shuffle_overflow"].sum() == 0
        assert ses.stats["batches"] == 5
        np.testing.assert_array_equal(
            canonical(res["rows"][res["valid"]]), expect)
        np.testing.assert_array_equal(
            canonical(res_half["rows"][res_half["valid"]]),
            reference_join(two_way(), half))


@pytest.mark.parametrize("chunks", [2, 4, 7])
def test_overlap_per_chunk_caps_are_ceil_divided(chunks):
    """Per-chunk caps: the serial quantized cap ceil-divided by C (not
    quantized again), equal to the JAX session's."""
    case = (24, 500, 40, 1.6)
    data = _data(*case)
    caps_serial = _port(data, 0).session().prepare(data).caps
    caps = _port(data, chunks).session().prepare(data).caps
    assert caps == {r: -(-c // chunks) for r, c in caps_serial.items()}
    jex = JaxExecutor(jax_plan(jax_two_way(), data, 8),
                      make_mesh_compat((N_DEV,), ("cells",)),
                      config=JaxConfig(out_capacity=_cap_out(data),
                                       overlap_shuffle=chunks))
    assert caps == jex.session().prepare(data).caps


def _dense_frags(seed):
    """Three destinations' fragments of the running example: small values,
    cell ids 0-2, a quarter of the rows invalid (as the reference test)."""
    rng = np.random.default_rng(seed)
    q = running_example()
    frags = {}
    for rel, n in [("R", 60), ("S", 90), ("T", 40)]:
        w = len(q.relation(rel).attrs)
        rows = rng.integers(0, 8, size=(3, n, w + 1)).astype(np.int32)
        rows[..., -1] = rng.integers(0, 3, size=(3, n))
        rows[rng.random((3, n)) < 0.25] = -1
        frags[rel] = rows
    return frags


@functools.lru_cache(maxsize=None)
def _jax_dense(seed, cap):
    import jax.numpy as jnp
    frags = _dense_frags(seed)
    out = []
    for d in range(3):
        rows, valid, over = jax_local_join_dense(
            {rel: jnp.asarray(f[d]) for rel, f in frags.items()},
            jax_running_example(), cap)
        out.append((np.asarray(rows), np.asarray(valid), int(over)))
    return out


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("hash_reduce", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_local_join_probes_match_dense(use_kernels, hash_reduce, seed):
    """Both probes of the port's `_local_join` equal its dense-matrix
    oracle bit for bit, and that oracle equals JAX's per destination."""
    q = running_example()
    frags = {rel: torch.from_numpy(f) for rel, f in _dense_frags(seed).items()}
    for cap in (16, 4096):                                # overflow + slack
        out, val, ov = _local_join(frags, q, cap, use_kernels, hash_reduce,
                                   None)
        out_d, val_d, ov_d = _local_join_dense(frags, q, cap)
        assert torch.equal(out, out_d) and torch.equal(val, val_d)
        assert torch.equal(ov, ov_d)
        for d, (rows, valid, over) in enumerate(_jax_dense(seed, cap)):
            np.testing.assert_array_equal(out_d[d].numpy(), rows)
            np.testing.assert_array_equal(val_d[d].numpy(), valid)
            assert int(ov_d[d]) == over


@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_buckets_matches_argsort_randomized(seed, k):
    """The counting-sort pack equals the full-argsort oracle on both
    versions, and the oracle equals JAX's per batch row."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    b, m, cap, w = 2, 257, 16, 3
    dest = rng.integers(-1, k, size=(b, m))               # includes -1
    rows = rng.integers(0, 1000, size=(b, m, w))
    d = torch.from_numpy(dest).to(torch.int32)
    r = torch.from_numpy(rows).to(torch.int32)
    buf_ref, over_ref = _pack_buckets_argsort(d, r, k, cap)
    for use_kernels in (True, False):
        buf, over = _pack_buckets(d, r, k, cap, use_kernels)
        assert torch.equal(buf, buf_ref) and torch.equal(over, over_ref)
    for i in range(b):
        jbuf, jover = jax_pack_argsort(jnp.asarray(dest[i], jnp.int32),
                                       jnp.asarray(rows[i], jnp.int32),
                                       k, cap)
        np.testing.assert_array_equal(buf_ref[i].numpy(), np.asarray(jbuf))
        assert int(over_ref[i]) == int(jover)
