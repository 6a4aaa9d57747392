"""Shared cases of the executor comparison tests (tests/test_torch_executor_*):
the same plan and data through the JAX `ExecutorSession` on 8 virtual
devices and through the port's session on the CPU.

The port runs under every `ExecutorConfig` arm (`ARMS`) against the JAX
package's default fused + hash session, which the reference pins
bit-identical to its staged and sort-merge arms; a JAX session is made
once per (query, data, k, config) and reused across arms."""
import hashlib

import numpy as np

from repro.core import plan_skew_join as jax_plan
from repro.core.executor import ExecutorConfig as JaxConfig
from repro.core.executor import ShardedJoinExecutor as JaxExecutor
from repro.launch.mesh import make_mesh_compat
from repro_torch.core import (JoinQuery, canonical, plan_skew_join,
                              reference_join)
from repro_torch.core.executor import (ExecutorConfig, ShardedJoinExecutor,
                                       quantize_capacity, session_from_numpy)

N_DEV = 8
# The port's ExecutorConfig arms: (map, reduce) -> config fields.
ARMS = {"fused+hash": {}, "fused+sort": {"hash_reduce": False},
        "staged+hash": {"fuse_map": False},
        "staged+sort": {"fuse_map": False, "hash_reduce": False}}
_JAX_SESSIONS: dict = {}
RESULT_KEYS = ("rows", "valid", "shuffle_overflow", "shuffle_overflow_by_rel",
               "join_overflow", "recv_counts")


def out_capacity(query, data):
    """A per-device output capacity that holds every cascade step's whole
    intermediate join (the left-deep prefixes R0 ⋈ ... ⋈ Ri)."""
    rels = query.relations
    biggest = max(len(reference_join(JoinQuery(rels[:i]), data))
                  for i in range(2, len(rels) + 1))
    return quantize_capacity(max(biggest, 1))


def jax_session(jq, data, k, cap_out, caps=None, **arm):
    plan = jax_plan(jq, data, k)
    ex = JaxExecutor(plan, make_mesh_compat((N_DEV,), ("cells",)),
                     config=JaxConfig(out_capacity=cap_out, **arm))
    s = ex.session().prepare(data, caps=caps)
    return plan, ex, s, s.run_batch()


def _cached_jax_session(jq, data, k, cap_out, jax_arm):
    digest = hashlib.sha256()
    for name in sorted(data):
        digest.update(name.encode() + np.ascontiguousarray(data[name]).tobytes())
    key = (tuple((r.name, r.attrs) for r in jq.relations), digest.hexdigest(),
           k, cap_out, tuple(sorted(jax_arm.items())))
    if key not in _JAX_SESSIONS:
        _JAX_SESSIONS[key] = jax_session(jq, data, k, cap_out, **jax_arm)
    return _JAX_SESSIONS[key]


def assert_same_result(got, want):
    for key in RESULT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def check_against_jax(jq, tq, data, k, arm="fused+hash", jax_arm=None):
    """Port's planner, prepare and run_batch under `arm` (a key of ARMS) ==
    the JAX session's under `jax_arm` (config fields; default fused +
    hash), bit for bit; rows == reference_join; the second same-shaped
    batch builds no step."""
    cap_out = out_capacity(tq, data)
    jplan, jex, js, jres = _cached_jax_session(jq, data, k, cap_out,
                                               jax_arm or {})
    plan = plan_skew_join(tq, data, k)
    ex = ShardedJoinExecutor(plan, N_DEV,
                             ExecutorConfig(out_capacity=cap_out, **ARMS[arm]),
                             device="cpu")
    assert ex.route_specs == jex.route_specs
    s = ex.session().prepare(data)
    assert s.count_passes == js.count_passes
    np.testing.assert_array_equal(s.placement.table, js.placement.table)
    assert s.caps == js.caps and s.cap_out == js.cap_out
    res = s.run_batch()
    assert_same_result(res, jres)
    assert int(res["shuffle_overflow"].sum()) == 0
    assert int(res["join_overflow"].sum()) == 0
    np.testing.assert_array_equal(canonical(res["rows"][res["valid"]]),
                                  reference_join(tq, data))
    if arm == "fused+hash":
        # The reference's plan state drives a port session to the same result.
        rels = [(r.name, r.attrs) for r in jq.relations]
        s2 = session_from_numpy(rels, k, N_DEV, jex.route_specs,
                                js.placement.table, js.caps, js.cap_out,
                                device="cpu")
        assert_same_result(s2.run_batch(data), jres)
    # Warm path: a second batch of the same shape reuses the step.
    assert ex.compile_count == 1
    half = {name: arr[: len(arr) // 2] for name, arr in data.items()}
    res_half = s.run_batch(half)
    assert ex.compile_count == 1 and ex.step_hits == 1
    np.testing.assert_array_equal(
        canonical(res_half["rows"][res_half["valid"]]),
        reference_join(tq, half))
