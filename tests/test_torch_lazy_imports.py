"""The package imports its subpackages at first use: a process that runs
the join executor alone (a spawned rank of the join's mesh) does not
import the LM's modules, nor torch.distributed.tensor, which they need;
the subpackages stay reachable as attributes of `repro_torch`."""
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"


def _imported(code: str) -> str:
    return subprocess.run(
        [sys.executable, "-c", code], env={"PYTHONPATH": str(SRC)},
        capture_output=True, text=True, check=True).stdout.strip()


def test_join_path_leaves_the_lm_unimported():
    got = _imported(
        "import sys\n"
        "from repro_torch.launch.mesh import make_join_mesh\n"
        "from repro_torch.core.executor import ShardedJoinExecutor\n"
        "print(sorted(m for m in ('torch.distributed.tensor',\n"
        "    'repro_torch.models', 'repro_torch.ckpt', 'repro_torch.optim',\n"
        "    'repro_torch.train') if m in sys.modules))\n")
    assert got == "[]", got


@pytest.mark.parametrize("name", ["ckpt", "configs", "core", "data", "ft",
                                  "kernels", "models", "optim", "serve",
                                  "train"])
def test_subpackage_reachable_as_attribute(name):
    got = _imported(f"import repro_torch\n"
                    f"print(repro_torch.{name}.__name__)\n")
    assert got == f"repro_torch.{name}"
