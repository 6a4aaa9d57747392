"""The port's join examples (examples/torch_port/) on the CPU at their own
sizes: each one's joined rows equal the JAX package's `reference_join` on
the same data, as the JAX examples check themselves against it."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.core import canonical as jax_canonical
from repro.core import reference_join as jax_reference_join
from repro.core import running_example as jax_running_example
from repro.core import two_way as jax_two_way

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch_port"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_port_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,query", [
    ("skewed_join_demo", jax_running_example),
    ("quickstart", jax_two_way)])
def test_example_rows_equal_jax_reference_join(name, query, capsys):
    data, rows = _load(name).main(device="cpu")
    out = capsys.readouterr().out
    assert "exact match" in out and "compile_count=1" in out
    np.testing.assert_array_equal(jax_canonical(rows),
                                  jax_reference_join(query(), data))
