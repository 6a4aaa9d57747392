"""Port executor vs the JAX executor on the paper's running example
R(A,B) ⋈ S(B,E,C) ⋈ T(C,D) (two cascade steps), n_dev = 8."""
import pytest

from _torch_port_cases import ARMS, check_against_jax
from repro.core import running_example as jax_running_example
from repro_torch.core import running_example
from repro_torch.data import skewed_join_dataset


@pytest.mark.parametrize("k", [8, 64, 256])
def test_running_example_matches_jax(k):
    data = skewed_join_dataset(running_example(), 200, 60,
                               skew={"B": 1.2, "C": 1.2}, seed=3)
    check_against_jax(jax_running_example(), running_example(), data, k)


@pytest.mark.parametrize("arm", [arm for arm in ARMS if arm != "fused+hash"])
@pytest.mark.parametrize("k", [8, 64, 256])
def test_running_example_arms_match_jax(arm, k):
    data = skewed_join_dataset(running_example(), 200, 60,
                               skew={"B": 1.2, "C": 1.2}, seed=3)
    check_against_jax(jax_running_example(), running_example(), data, k, arm)
