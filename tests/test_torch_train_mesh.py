"""The port's train step over a (2, 2) mesh of 4 gloo ranks on the CPU
against the JAX package's pjit step on a (2, 2) mesh of virtual devices
and against the port's one-process step: reduced qwen3-14b at n_micro 1
and 2, reduced mixtral-8x22b with 8-bit states, reduced mamba2-370m, in
float32, from the same seed-made parameters (every rank its own block of
them, `params_from_jax(mesh=)`), 3 steps with a warmup of one.  The ranks
run every case in one spawn (tests/_torch_lm_mesh_cases.py); the
reference's side is tests/_lm_mesh_jax.py.  (1, 4) and (4, 1) are
tests/test_torch_train_mesh_shapes.py.

Tolerances: loss, zloss and grad_norm within rtol 1e-5 of the reference
and of the one-process step, as tests/test_torch_train_step.py holds the
one-process step; lr_scale within 1e-7; expert_load equal.  The
parameters after each step: within `PARAM_TOL` of the reference's and of
the one-process step's, a tenth of one step's largest move (lr = 1e-2).
Adam's first update is lr·g/(|g| + eps) per element, so where a gradient
is near eps = 1e-8 its last bits, which the frameworks and the ranks sum
in other orders, move the update by a part of lr: the worst measured
over both files' cases is 4.0e-4 (mamba2's out_proj after the first
update, against the reference; 2.6e-4 against the one-process step).
An element further than that must be one the reference's own float64
update shows ill-conditioned, and within the range AdamW's update can
take there (`adam_ranges`; at most `MAX_EXEMPT` a case, printed).
The float32 moments within `STATE_TOL` (worst measured 1.6e-6, mamba2's
embedding's m);
8-bit codes within one and scales within rtol 1e-3
(test_torch_train_step.py's; worst measured 1.2e-4).  The tolerances
and checks live in tests/_lm_mesh_jax.py (`PARAM_TOL`, `STATE_TOL`,
`check_case`, `check_blocks`) and, for the metrics, in
tests/_torch_lm_mesh_cases.py (`TOL`, `check_metrics`).  The
shapes of every rank's blocks equal the reference's shards on the device
at the same mesh position: the memory is split as the reference splits
it."""
import pytest

import _lm_mesh_jax as lj
import _torch_lm_mesh_cases as lc



@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return lj.run(lc.SQUARE, tmp_path_factory, "lm_mesh_square")


@pytest.mark.parametrize("case", lc.SQUARE)
def test_mesh_step_matches_jax_and_one_process(runs, case):
    ranks, want = runs
    lj.check_case(ranks, want, case)


@pytest.mark.parametrize("case", lc.SQUARE)
def test_mesh_params_and_states_match_jax(runs, case):
    ranks, want = runs
    lj.check_blocks(ranks, case, want[case], lc.CASES[case][4])


def test_loss_and_8bit_update_stay_local(runs):
    """On (2, 2): the loss over logits split along the vocabulary and an
    8-bit update of a leaf split along its last axis issue all-reduces
    alone (of a row's maximum, sums and scalars): nothing is gathered.
    The loss equals the plain one within 1e-6; two updates equal the
    one-process ones bit for bit on every rank's blocks (the gradients'
    norm is below grad_clip, so no summation order enters the clip)."""
    ranks, _ = runs
    for rank in ranks:
        got = rank["comm"]
        assert got["loss"][0] == pytest.approx(got["loss"][1], rel=1e-6)
        for key in ("loss_comms", "update_comms"):
            assert got[key] and all("all_reduce" in op or "allreduce" in op
                                    for op in got[key]), got[key]
        assert all(got["update_same"].values()), got["update_same"]
