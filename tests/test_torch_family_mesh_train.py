"""The port's train step for the hybrid (zamba2), enc-dec (seamless-m4t) and
VLM (llama-3.2-vision) families over a mesh of 4 gloo ranks on the CPU at
(2, 2) and (1, 4), against the JAX package's pjit step on a mesh of the
same shape over virtual devices and against the port's one-process step:
reduced configs with zamba2 and the VLM at 4 layers (one group, so the
shared attention block and the gated cross-attention run, and one tail
layer), the VLM's gate at 0.5, chunked attention in two cases (the
encoder's, the decoder's and the cross-attention's), the VLM at (2, 2)
with 8-bit states; float32 from the same seed-made parameters, 3 steps
with a warmup of one, the batch's frames or vision embeddings made from
a seed and split over DP as tokens are.  The ranks run every case in one
spawn (tests/_torch_family_mesh_cases.py); the reference's side is
tests/_family_mesh_jax.py.  The tolerances and checks are
tests/test_torch_train_mesh.py's (tests/_lm_mesh_jax.py): loss, zloss
and grad_norm within rtol 1e-5, parameters within 1e-3 (an element the
reference's float64 update shows ill-conditioned, within its Adam range:
`adam_ranges`), float32 moments
within 1e-5, 8-bit codes within one and scales within rtol 1e-3, every
block's shape the reference's shard's on the device at that mesh
position."""
import pytest

import _family_mesh_jax as fj
import _lm_mesh_jax as lj
import _torch_family_mesh_cases as fc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return fj.run_train(list(fc.TRAIN), tmp_path_factory, "family_mesh_train")


@pytest.mark.parametrize("case", list(fc.TRAIN))
def test_mesh_step_matches_jax_and_one_process(runs, case):
    ranks, want = runs
    lj.check_case(ranks, want, case, fc.TRAIN[case][2])


@pytest.mark.parametrize("case", list(fc.TRAIN))
def test_mesh_params_and_states_match_jax(runs, case):
    ranks, want = runs
    lj.check_blocks(ranks, case, want[case], fc.TRAIN[case][4])
