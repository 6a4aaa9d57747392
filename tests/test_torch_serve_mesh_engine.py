"""The port's serving over a (2, 2) mesh of 4 gloo ranks on the CPU against
the JAX package's on a (2, 2) mesh of virtual devices and against the port
in one process, from the same seed-made float32 parameters:
`ServingEngine(mesh=)` serving tests/test_serving_engine.py's five
requests on 2 slots (reduced qwen2-0.5b, the reference's numpy tree as its
parameters), reduced mixtral-8x22b's decode under the reference's MoE
decode rules (the experts' hidden dimension over "data"), reduced
qwen3-14b's `build_prefill(mesh=)` and `api.prefill` over the mesh filling
the decode step's cache.  Tolerances are tests/_serve_mesh_jax.py's.  (The
hybrid, enc-dec and VLM families over a mesh:
tests/test_torch_family_mesh_serve.py.)"""
import numpy as np
import pytest

import _serve_mesh_jax as sj
import _torch_serve_mesh_cases as sc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sj.run(sc.OTHERS, tmp_path_factory, "serve_mesh_others")


def test_engine_matches_jax_and_one_process(runs):
    """Every request's tokens on every rank equal the JAX engine's and
    the one-process port engine's; each request got its max_new_tokens;
    every tick ran eagerly."""
    ranks, want = runs
    for rank in ranks:
        got = rank["engine_2x2"]
        assert got["tokens"] == want["engine_2x2"]["tokens"]
        assert got["tokens"] == got["one"]
        assert [len(t) for t in got["tokens"]] == [
            m for _, m in sc.ENGINE["requests"]]
        assert got["counts"] == (got["ticks"], 0, 0)


def test_engine_reused_slot_is_isolated(runs):
    """The last request, served in a slot another request used, gives
    the tokens it gives alone on a fresh mesh engine."""
    ranks, _ = runs
    for rank in ranks:
        got = rank["engine_2x2"]
        assert got["tokens"][-1] == got["solo"]


def test_moe_decode_matches_jax_and_one_process(runs):
    ranks, want = runs
    sj.check_decode(ranks, want, "mixtral_2x2")
    sj.check_cache(ranks, want, "mixtral_2x2")


def test_moe_expert_load_on_each_rank_rows(runs):
    """Each rank's `segment_histogram` counts its own rows' routed copies
    (B / data · K a layer), equal to its plain version there; over the
    data ranks of one model column the counts sum to the one-process
    step's, call by call."""
    from repro_torch.configs import ARCHS
    ranks, _ = runs
    cfg = sc.config("mixtral_2x2", ARCHS)
    for col in range(2):
        column = [r["mixtral_2x2"] for r in ranks
                  if r["mixtral_2x2"]["coordinate"][1] == col]
        for t in range(sc.STEPS):
            one = column[0]["loads"]["one"][t]
            assert len(one) == cfg.n_layers
            for call in range(cfg.n_layers):
                parts = [rank["loads"]["mesh"][t][call] for rank in column]
                for n, _, same in parts:
                    assert same and n == sc.B // 2 * cfg.topk
                np.testing.assert_array_equal(
                    sum(out for _, out, _ in parts), one[call][1])


def test_prefill_matches_jax_and_one_process(runs):
    ranks, want = runs
    for rank in ranks:
        got = rank["prefill_2x2"]
        assert got["shape"] == want["prefill_2x2"]["logits"].shape
        assert got["logits"]["ref"] <= sj.LOGIT_TOL, got["logits"]
        assert got["logits"]["one"] <= sj.LOGIT_TOL, got["logits"]


def test_api_prefill_fills_each_rank_block(runs):
    """`api.prefill` over the mesh into a cache of the decode step's
    placements (rows over "data", the sequence over "model": the first
    rank of each row holds the prompt's 16 positions, the second none):
    logits within LOGIT_TOL of the one-process `api.prefill`, every
    block of its cache within CACHE_TOL of the one-process cache's."""
    ranks, _ = runs
    for rank in ranks:
        got = rank["prefill_2x2"]["api_prefill"]
        assert got["placements"]["k"] == ("S(1)", "S(2)")
        assert got["logits"] <= sj.LOGIT_TOL, got
        for key, err in got["cache"].items():
            assert err["one_rel"] <= sj.CACHE_TOL, (key, err)
