"""Import rules of the port and its CUDA-by-default entry points.

`repro_torch` and `chip_smoke.py` import neither JAX nor the JAX package
`repro` (they keep their own copies of what they need); entry points run
on the card unless the caller asks for the CPU, and raise without one."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import plan_skew_join, two_way
from repro_torch.core.executor import (ExecutorConfig, ExecutorError,
                                       ShardedJoinExecutor, resolve_device)
from repro_torch.data import skewed_join_dataset
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)(?!_torch)\b|from\s+(jax|repro)(?!_torch)\b)",
    re.MULTILINE)


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.data\n"
        "import repro_torch.core.executor, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.ref, repro_torch.kernels._build\n"
        "import repro_torch.kernels.route_cells, repro_torch.kernels.bucket_pack\n"
        "import repro_torch.kernels.build_probe\n"
        "import repro_torch.kernels.hash_partition, repro_torch.kernels.map_pack\n"
        "import repro_torch.kernels.scatter_pack, repro_torch.kernels.join_probe\n"
        "import repro_torch.kernels.segment_histogram\n"
        "import repro_torch.configs, repro_torch.core.moe_shares\n"
        "import repro_torch.models.common, repro_torch.models.layers\n"
        "import repro_torch.models.transformer, repro_torch.models.moe\n"
        "import repro_torch.models.api, repro_torch.models.convert\n"
        "import repro_torch.serve.serve_step, repro_torch.serve.engine\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m == 'repro' "
        "or m.startswith('repro.') for m in sys.modules "
        "if sys.modules[m] is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_repro_import(path):
    assert not FORBIDDEN.findall(path.read_text()), path


def test_forbidden_pattern_catches_imports():
    for bad in ("import jax", "from jax import numpy", "import repro.core",
                "from repro.kernels import ops", "  from repro import core"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import plan",
               "import jaxlib_free  # jax"):
        assert not FORBIDDEN.search(ok), ok


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = two_way()
    data = skewed_join_dataset(q, 100, 20, seed=1)
    plan = plan_skew_join(q, data, 8)
    with pytest.raises(ExecutorError, match="CUDA"):
        ShardedJoinExecutor(plan, 8)
    with pytest.raises(ExecutorError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_model_and_serving_entry_points_default_to_cuda(monkeypatch):
    """init_params, init_model, init_cache, params_from_jax,
    build_decode_step, build_prefill and ServingEngine raise without a card
    unless given device="cpu"."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serve import (ServingEngine, build_decode_step,
                                   build_prefill)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["mixtral-8x22b"].reduced()
    gen = torch.Generator()
    tree = init_params(api.layout(cfg), gen, device="cpu")
    model = api.build(cfg, tree)
    numpy_tree = {"embed": {k: v.float().numpy()
                            for k, v in tree["embed"].items()},
                  "blocks": {part: {k: v.float().numpy()
                                    for k, v in sub.items()}
                             for part, sub in tree["blocks"].items()}}
    calls = [
        lambda **kw: init_params(api.layout(cfg), gen, **kw),
        lambda **kw: api.init_model(cfg, gen, **kw),
        lambda **kw: api.init_cache(cfg, 2, 8, **kw),
        lambda **kw: params_from_jax(numpy_tree, cfg, **kw),
        lambda **kw: build_decode_step(cfg, 2, 8, **kw),
        lambda **kw: build_prefill(cfg, **kw),
        lambda **kw: ServingEngine(cfg, 2, 8, model, **kw),
    ]
    for call in calls:
        with pytest.raises(ExecutorError, match="CUDA"):
            call()
        assert call(device="cpu") is not None


def test_unported_config_arms_raise():
    q = two_way()
    plan = plan_skew_join(q, skewed_join_dataset(q, 100, 20, seed=1), 8)
    for shuffle in (2, 4):
        with pytest.raises(NotImplementedError):
            ShardedJoinExecutor(plan, 8, ExecutorConfig(overlap_shuffle=shuffle),
                                device="cpu")


@pytest.mark.parametrize("fuse_map,hash_reduce", [(False, True), (True, False),
                                                  (False, False)])
def test_ported_config_arms_run_on_cpu_with_no_launch(fuse_map, hash_reduce):
    ops.reset_launches()
    q = two_way()
    data = skewed_join_dataset(q, 200, 30, skew={"B": 1.3}, seed=2)
    plan = plan_skew_join(q, data, 64)
    cfg = ExecutorConfig(out_capacity=1 << 14, fuse_map=fuse_map,
                         hash_reduce=hash_reduce)
    res = ShardedJoinExecutor(plan, 8, cfg, device="cpu").run(data)
    assert int(np.asarray(res["valid"]).sum()) > 0
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    ops.reset_launches()
    q = two_way()
    data = skewed_join_dataset(q, 200, 30, skew={"B": 1.3}, seed=2)
    plan = plan_skew_join(q, data, 64)
    ex = ShardedJoinExecutor(plan, 8, ExecutorConfig(out_capacity=1 << 14),
                             device="cpu")
    res = ex.session().prepare(data).run_batch()
    assert int(np.asarray(res["valid"]).sum()) > 0
    assert all(v == 0 for v in ops.LAUNCHES.values())
