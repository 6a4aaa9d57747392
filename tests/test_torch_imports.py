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
        "import repro_torch.graph\n"
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
        "import repro_torch.models.ssm, repro_torch.models.hybrid\n"
        "import repro_torch.models.encdec, repro_torch.models.vlm\n"
        "import repro_torch.models.api, repro_torch.models.convert\n"
        "import repro_torch.serve.serve_step, repro_torch.serve.engine\n"
        "import repro_torch.core.adapt, repro_torch.serve.join_engine\n"
        "import repro_torch.ft, repro_torch.ft.health, repro_torch.ft.chaos\n"
        "import repro_torch.ft.straggler, repro_torch.ft.elastic\n"
        "import repro_torch.data.pipeline, repro_torch.tree\n"
        "import repro_torch.optim, repro_torch.optim.adamw\n"
        "import repro_torch.optim.schedule, repro_torch.optim.grad_compress\n"
        "import repro_torch.train, repro_torch.train.train_step\n"
        "import repro_torch.ckpt, repro_torch.ckpt.checkpoint\n"
        "import repro_torch.launch, repro_torch.launch.train\n"
        "import repro_torch.launch.mesh\n"
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


EXAMPLES = sorted((ROOT / "examples" / "torch_port").glob("*.py"))


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "scripts" / "time_join_step.py"]
                         + EXAMPLES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_repro_import(path):
    assert not FORBIDDEN.findall(path.read_text()), path


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_import_with_jax_and_repro_blocked(path):
    """The port's examples load (their imports run) with JAX and the JAX
    package unimportable, and refuse to start without a card unless asked
    for the CPU."""
    code = (
        "import sys, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        f"spec = importlib.util.spec_from_file_location('ex', {str(path)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "from repro_torch.core.executor import ExecutorError\n"
        "try:\n"
        "    mod.main()\n"
        "except ExecutorError as err:\n"
        "    assert 'CUDA' in str(err)\n"
        "else:\n"
        "    raise SystemExit('ran without a card')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


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


def test_model_and_serving_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """init_params, init_model, init_cache, params_from_jax,
    opt_state_from_jax, build_decode_step, build_prefill, ServingEngine,
    JoinServingEngine, build_train_step, Checkpointer.restore,
    SelfHealingSession (on the device of the executor it is given) and
    make_join_mesh raise without a card unless given device="cpu"."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models.common import init_params
    from repro_torch.ckpt import Checkpointer
    from repro_torch.models.convert import opt_state_from_jax, params_from_jax
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import build_train_step
    from repro_torch.tree import tree_map
    from repro_torch.serve import (JoinServingEngine, SelfHealingSession,
                                   ServingEngine, build_decode_step,
                                   build_prefill)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = two_way()
    plan = plan_skew_join(q, skewed_join_dataset(q, 100, 20, seed=1), 8)
    cfg = ARCHS["mixtral-8x22b"].reduced()
    gen = torch.Generator()
    tree = init_params(api.layout(cfg), gen, device="cpu")
    model = api.build(cfg, tree)
    numpy_tree = {"embed": {k: v.float().numpy()
                            for k, v in tree["embed"].items()},
                  "blocks": {part: {k: v.float().numpy()
                                    for k, v in sub.items()}
                             for part, sub in tree["blocks"].items()}}
    numpy_opt = tree_map(lambda t: t.numpy(), adamw.init(tree, AdamWConfig()))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(2)}, blocking=True)
    calls = [
        lambda **kw: init_params(api.layout(cfg), gen, **kw),
        lambda **kw: api.init_model(cfg, gen, **kw),
        lambda **kw: api.init_cache(cfg, 2, 8, **kw),
        lambda **kw: params_from_jax(numpy_tree, cfg, **kw),
        lambda **kw: opt_state_from_jax(numpy_opt, cfg, **kw),
        lambda **kw: build_decode_step(cfg, 2, 8, **kw),
        lambda **kw: build_prefill(cfg, **kw),
        lambda **kw: ServingEngine(cfg, 2, 8, model, **kw),
        lambda **kw: JoinServingEngine(8, **kw),
        lambda **kw: build_train_step(cfg, **kw),
        lambda **kw: ck.restore(1, {"w": torch.empty(2, device="meta")}, **kw),
        lambda **kw: SelfHealingSession(ShardedJoinExecutor(plan, 8, **kw)),
    ]
    for call in calls:
        with pytest.raises(ExecutorError, match="CUDA"):
            call()
        assert call(device="cpu") is not None
    # make_join_mesh: a rank's device is cuda:LOCAL_RANK unless the caller
    # names the CPU (and gloo with it).
    from repro_torch.launch.mesh import make_join_mesh
    store = f"file://{tmp_path / 'mesh_store'}"
    with pytest.raises(ExecutorError, match="CUDA"):
        make_join_mesh(init_method=store, rank=0, world_size=1)
    mesh = make_join_mesh("gloo", device="cpu", init_method=store, rank=0,
                          world_size=1)
    try:
        assert mesh.device_type == "cpu"
    finally:
        torch.distributed.destroy_process_group()


def test_unported_config_arms_raise():
    """Every arm of the join path is ported; the one refusal left is
    `adapt=` on an executor made by `from_specs`, which has no plan to
    re-plan from.  Executors built from a plan take `adapt=` under the
    serial and the chunked exchange."""
    from repro_torch.core import AdaptPolicy
    from repro_torch.serve import SelfHealingSession
    q = two_way()
    plan = plan_skew_join(q, skewed_join_dataset(q, 100, 20, seed=1), 8)
    for shuffle in (0, 2, 4):
        cfg = ExecutorConfig(overlap_shuffle=shuffle)
        ex = ShardedJoinExecutor(plan, 8, cfg, device="cpu")
        assert SelfHealingSession(ex, adapt=AdaptPolicy()).executor is ex
        bare = ShardedJoinExecutor.from_specs(q, plan.k, ex.route_specs, 8,
                                              cfg, device="cpu")
        with pytest.raises(ValueError, match="planner's plan"):
            SelfHealingSession(bare, adapt=AdaptPolicy())
        assert SelfHealingSession(bare).session.executor is bare


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
