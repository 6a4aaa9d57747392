"""tests/test_torch_train_mesh.py's checks on the other two mesh shapes of
4 ranks: reduced qwen3-14b at n_micro 1 and 2 over (1, 4) (tensor
parallel alone: every parameter split over "model" where it divides) and
(4, 1) (data parallel and FSDP alone), against the JAX package's pjit
step on the same shape and the port's one-process step, at that file's
tolerances."""
import pytest

import _lm_mesh_jax as lj
import _torch_lm_mesh_cases as lc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return lj.run(lc.SHAPES, tmp_path_factory, "lm_mesh_shapes")


@pytest.mark.parametrize("case", lc.SHAPES)
def test_mesh_step_matches_jax_and_one_process(runs, case):
    ranks, want = runs
    lj.check_case(ranks, want, case)


@pytest.mark.parametrize("case", lc.SHAPES)
def test_mesh_params_and_states_match_jax(runs, case):
    ranks, want = runs
    lj.check_blocks(ranks, case, want[case], lc.CASES[case][4])
