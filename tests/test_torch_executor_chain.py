"""Port executor vs the JAX executor on a 4-way chain
R0(X0,X1) ⋈ R1(X1,X2) ⋈ R2(X2,X3) ⋈ R3(X3,X4), n_dev = 8."""
import pytest

from _torch_port_cases import ARMS, check_against_jax
from repro.data import chain_query as jax_chain_query
from repro_torch.data import chain_query, skewed_join_dataset


@pytest.mark.parametrize("k", [8, 64, 256])
def test_chain_matches_jax(k):
    data = skewed_join_dataset(chain_query(4), 3000, 1 << 16,
                               skew={"X2": 1.5}, seed=3)
    check_against_jax(jax_chain_query(4), chain_query(4), data, k)


@pytest.mark.parametrize("arm", [arm for arm in ARMS if arm != "fused+hash"])
@pytest.mark.parametrize("k", [8, 64, 256])
def test_chain_arms_match_jax(arm, k):
    data = skewed_join_dataset(chain_query(4), 3000, 1 << 16,
                               skew={"X2": 1.5}, seed=3)
    check_against_jax(jax_chain_query(4), chain_query(4), data, k, arm)
