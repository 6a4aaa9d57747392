"""The port's serving of the hybrid (zamba2), enc-dec (seamless-m4t) and
VLM (llama-3.2-vision) families over a mesh of 4 gloo ranks on the CPU,
against the JAX package's pjit decode step, prefill and `ServingEngine`
on a mesh of the same shape over virtual devices and against the port in
one process, float32 from the same seed-made parameters (the VLM's gate
at 0.5; zamba2 and the VLM at 4 layers, one group and one tail).  Decode
(`build_decode_step(mesh=)`): each family at (2, 2) and (1, 4), 3 greedy
steps of 4 slots from a cache seeded non-zero (keys, values, SSM states,
encoder rows, vision tokens) at positions that cross the ranks' blocks;
zamba2's ring with two KV heads at (1, 4), its 64-slot window split into
blocks of 16, decoding across its wrap; chunked cross-attention (chunks
of 2) for the enc-dec and the VLM.  Prefill: `build_prefill(mesh=)` over
prompts and frames or vision embeddings, `api.prefill` over the mesh
filling `enc_out` or `vis` (and the enc-dec's self-attention blocks), 3
decode steps from that cache.  The engine: zamba2's `ServingEngine(mesh=)`
on tests/test_serving_engine.py's five requests.  The ranks run every
case in one spawn (tests/_torch_family_mesh_cases.py); the reference's
side and the tolerances are tests/_family_mesh_jax.py's: tokens equal,
logits within 1e-5, every rank's cache blocks within 1e-5 of the
block's largest magnitude (SSM states 1e-5 absolute), each block's shape
the reference's shard's."""
import pytest

import _family_mesh_jax as fj
import _torch_family_mesh_cases as fc

PREFILL = [c for c in fc.OTHERS if fc.SERVE[c][0] == "prefill"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return fj.run_serve(list(fc.SERVE), tmp_path_factory, "family_mesh_serve")


@pytest.mark.parametrize("case", fc.DECODE)
def test_mesh_decode_matches_jax_and_one_process(runs, case):
    ranks, want = runs
    fj.check_decode(ranks, want, case)


@pytest.mark.parametrize("case", fc.DECODE)
def test_mesh_cache_blocks_match_jax(runs, case):
    ranks, want = runs
    fj.check_cache(ranks, want, case)


def test_cache_placements_of_each_family(runs):
    """The rows over "data"; zamba2's and seamless' four KV heads over
    "model"; the VLM's one KV head cannot take it, so its caches split the
    sequence; zamba2's ring of two KV heads on four ranks splits its
    window; the SSM states split their heads; `enc_out` and `vis` split
    their rows alone."""
    ranks, _ = runs
    got = {case: {k: ranks[0][case]["placements"][k] for k in keys}
           for case, keys in (
               ("zamba2_2x2", ("attn_k", "mamba/ssm", "tail/conv")),
               ("zamba2_ring_kv2_1x4", ("attn_k", "mamba/ssm")),
               ("seamless_1x4", ("k", "enc_out")),
               ("vision_2x2", ("sa_k", "tail_v", "vis")),
               ("vision_1x4", ("sa_k", "vis")))}
    assert got == {
        "zamba2_2x2": {"attn_k": ("S(1)", "S(3)"),
                       "mamba/ssm": ("S(1)", "S(2)"),
                       "tail/conv": ("S(1)", "S(3)")},
        "zamba2_ring_kv2_1x4": {"attn_k": ("R", "S(2)"),
                                "mamba/ssm": ("R", "S(2)")},
        "seamless_1x4": {"k": ("R", "S(3)"), "enc_out": ("R", "R")},
        "vision_2x2": {"sa_k": ("S(1)", "S(2)"), "tail_v": ("S(1)", "S(2)"),
                       "vis": ("S(0)", "R")},
        "vision_1x4": {"sa_k": ("R", "S(2)"), "vis": ("R", "R")}}, got


@pytest.mark.parametrize("case", PREFILL)
def test_prefill_matches_jax_and_one_process(runs, case):
    """`build_prefill(mesh=)`'s logits and `api.prefill`'s last-position
    logits within LOGIT_TOL of the reference's and the one-process port's;
    every rank's blocks of the filled cache (`enc_out` or `vis`, the
    self-attention blocks) within the cache tolerances of both, its
    shards' shapes the reference's."""
    ranks, want = runs
    for rank in ranks:
        got = rank[case]
        assert got["shape"] == want[case]["prefill_logits"].shape
        for part in ("prefill", "api_prefill"):
            assert max(got[part].values()) <= fj.LOGIT_TOL, (part, got[part])
    fj.check_cache(ranks, want, case, "prefilled", "prefilled_shapes")


@pytest.mark.parametrize("case", PREFILL)
def test_decode_from_prefilled_cache_matches_jax(runs, case):
    ranks, want = runs
    fj.check_decode(ranks, want, case)
    fj.check_cache(ranks, want, case)


def test_engine_matches_jax_and_one_process(runs):
    """Every request's tokens on every rank equal the JAX engine's and
    the one-process port engine's; each request got its max_new_tokens;
    every tick ran eagerly; the cache keeps zamba2's nested tree."""
    ranks, want = runs
    for rank in ranks:
        got = rank["zamba2_engine_2x2"]
        assert got["tokens"] == want["zamba2_engine_2x2"]["tokens"]
        assert got["tokens"] == got["one"]
        assert [len(t) for t in got["tokens"]] == [
            m for _, m in fc.ENGINE["requests"]]
        assert got["counts"] == (got["ticks"], 0, 0)
        assert got["cache_keys"] == ["attn_k", "attn_v", "mamba/conv",
                                     "mamba/ssm", "tail/conv", "tail/ssm"]


def test_engine_reused_slot_is_isolated(runs):
    """The last request, served in a slot another request used (its SSM
    states and ring zeroed), gives the tokens it gives alone on a fresh
    mesh engine."""
    ranks, _ = runs
    for rank in ranks:
        got = rank["zamba2_engine_2x2"]
        assert got["tokens"][-1] == got["solo"]
