"""The port's decode step over a (data, model) mesh of 4 gloo ranks on the
CPU (`build_decode_step(mesh=)`) against the JAX package's pjit decode
step on a mesh of the same shape over virtual devices and against the
port's one-process step: reduced qwen2-0.5b and mamba2-370m at (2, 2),
(1, 4) and (4, 1), and reduced qwen3-14b with two KV heads at (2, 2) and
(1, 4), in
float32 from the same seed-made parameters, 3 greedy steps of 4 slots at
positions that cross the ranks' blocks of the cache.  The reduced configs
hold one KV head, so on a model axis of 2 or 4 their caches split the
sequence over "model" (the reference's fallback); two KV heads at (2, 2)
split the heads, and at (1, 4), where they do not divide, the sequence.  The ranks run every case in one spawn
(tests/_torch_serve_mesh_cases.py); the reference's side and the
tolerances are tests/_serve_mesh_jax.py's (float32 caches; each beside
the worst measured): next tokens equal; logits within 1e-5
(`LOGIT_TOL`); every rank's blocks of the caches within 1e-5 of the
block's largest magnitude (`CACHE_TOL`) of the reference's and the
one-process port's at the same global index, the SSM state within 1e-5
(`STATE_TOL`); each block's shape the reference's shard's on the device
at that mesh position.  The engine, MoE and prefill cases are
tests/test_torch_serve_mesh_engine.py."""
import pytest

import _serve_mesh_jax as sj
import _torch_serve_mesh_cases as sc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sj.run(sc.DECODE, tmp_path_factory, "serve_mesh_decode")


@pytest.mark.parametrize("case", sc.DECODE)
def test_mesh_decode_matches_jax_and_one_process(runs, case):
    ranks, want = runs
    sj.check_decode(ranks, want, case)


@pytest.mark.parametrize("case", sc.DECODE)
def test_mesh_cache_blocks_match_jax(runs, case):
    ranks, want = runs
    sj.check_cache(ranks, want, case)


def test_cache_placements_fall_back_to_the_sequence(runs):
    """One KV head on a model axis of 2 or 4, or two on 4: the cache's
    sequence takes "model"; two KV heads on 2: the heads take it; a model
    axis of one rank splits nothing."""
    ranks, _ = runs
    got = {case: ranks[0][case]["placements"]["k"] for case in sc.DECODE
           if "qwen" in case}
    assert got == {"qwen2_2x2": ("S(1)", "S(2)"), "qwen2_1x4": ("R", "S(2)"),
                   "qwen2_4x1": ("S(1)", "R"),
                   "qwen3_kv2_2x2": ("S(1)", "S(3)"),
                   "qwen3_kv2_1x4": ("R", "S(2)")}, got
