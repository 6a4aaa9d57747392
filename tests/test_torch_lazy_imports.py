"""The package imports its subpackages at first use, and `serve` its names:
a process that runs the join executor or serves the join alone (a spawned
rank of the join's mesh) does not import the LM's modules, nor
torch.distributed.tensor, which they need; the subpackages stay reachable
as attributes of `repro_torch`, the serving names as attributes of
`repro_torch.serve`."""
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


def test_join_serving_leaves_the_lm_unimported():
    """`repro_torch.serve` loads its names at first use, and the join's
    serving (a `SelfHealingSession` over an executor, a
    `JoinServingEngine`) needs neither the LM's modules nor DTensor: a
    spawned rank of the join's mesh does not import them."""
    got = _imported(
        "import sys\n"
        "from repro_torch.core import plan_skew_join, two_way\n"
        "from repro_torch.core.executor import ShardedJoinExecutor\n"
        "from repro_torch.data import skewed_join_dataset\n"
        "from repro_torch.serve import JoinServingEngine, SelfHealingSession\n"
        "q = two_way()\n"
        "plan = plan_skew_join(q, skewed_join_dataset(q, 100, 20, seed=1), 8)\n"
        "SelfHealingSession(ShardedJoinExecutor(plan, 8, device='cpu'))\n"
        "JoinServingEngine(8, device='cpu')\n"
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


@pytest.mark.parametrize("name", ["Request", "SelfHealingSession",
                                  "ServingEngine", "ExecutableCache",
                                  "JoinRequest", "JoinServingEngine",
                                  "ServeFns", "build_decode_step",
                                  "build_prefill", "cache_placements"])
def test_serve_name_reachable_as_attribute(name):
    got = _imported(f"import repro_torch.serve as s\n"
                    f"print(s.{name}.__name__)\n")
    assert got == name
