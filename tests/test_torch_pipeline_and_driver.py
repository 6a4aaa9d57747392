"""The port's data pipeline, array for array with the reference's, and its
training driver (`python -m repro_torch.launch.train`) end to end on the
CPU: a simulated node failure with its elastic re-mesh and restore, and
`--resume` (on reduced qwen2-0.5b and on reduced mamba2-370m, the
reference's arch for its resume test); and on reduced
seamless-m4t-medium and the 7-layer vision model, whose stub frontends
(`frames`, `vision_emb`) the driver draws as the reference's does: the
batches and the losses against the reference driver's
(`_torch_family_cases.check_driver`)."""
import sys

import numpy as np
import pytest
import torch

from _torch_family_cases import SEVEN, check_driver
from repro.data import PipelineConfig as JPipelineConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro_torch.ckpt import Checkpointer
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.launch.train import main as train_main


def _losses(out: str) -> list[float]:
    return [float(line.split("loss")[1].split()[0])
            for line in out.splitlines() if line.startswith("step ")]


def test_pipeline_deterministic_and_restartable():
    cfg = PipelineConfig(vocab_size=1000, seq_len=16, global_batch=8, seed=3)
    p1, p2 = TokenPipeline(cfg), TokenPipeline(cfg)
    for step in (0, 5, 5, 100):        # revisiting a step reproduces it exactly
        a, b = p1(step), p2(step)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    assert not np.array_equal(p1(0)["tokens"], p1(1)["tokens"])


@pytest.mark.parametrize("dp_size", [1, 2, 4])
def test_pipeline_equals_the_reference(dp_size):
    """Global batches and every DP rank's shard, array for array."""
    kw = dict(vocab_size=32768, seq_len=24, global_batch=8, seed=5)
    cfg, jcfg = PipelineConfig(**kw), JPipelineConfig(**kw)
    for step in (0, 1, 17):
        g, jg = (TokenPipeline(cfg).global_batch_at(step),
                 JTokenPipeline(jcfg).global_batch_at(step))
        for k in ("tokens", "labels"):
            assert g[k].dtype == jg[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], jg[k])
        for r in range(dp_size):
            a = TokenPipeline(cfg, dp_rank=r, dp_size=dp_size)(step)
            b = JTokenPipeline(jcfg, dp_rank=r, dp_size=dp_size)(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="dp_size 3"):
        TokenPipeline(cfg, dp_size=3)


def test_pipeline_shards_partition_global_batch():
    cfg = PipelineConfig(vocab_size=1000, seq_len=8, global_batch=8, seed=0)
    full = TokenPipeline(cfg).global_batch_at(step=2)
    parts = [TokenPipeline(cfg, dp_rank=r, dp_size=4)(2) for r in range(4)]
    got = np.concatenate([p["tokens"] for p in parts])
    np.testing.assert_array_equal(got, full["tokens"])
    # labels are next-token shifted tokens
    np.testing.assert_array_equal(full["labels"][:, :-1], full["tokens"][:, 1:])


def test_train_driver_end_to_end_with_failure(tmp_path, capsys, monkeypatch):
    """The driver: train -> checkpoint -> inject node failure -> elastic
    re-mesh -> restore -> finish.  Loss must descend end to end."""
    argv = ["train", "--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
            "--steps", "12", "--batch", "8", "--seq", "32",
            "--lr", "3e-3", "--ckpt-every", "4", "--log-every", "1",
            "--ckpt-dir", str(tmp_path), "--fail-at-step", "6"]
    monkeypatch.setattr(sys, "argv", argv)
    train_main()
    out = capsys.readouterr().out
    assert out.startswith("arch=qwen2-0.5b params=0.3M mesh={'data': 2, "
                          "'model': 4}")
    assert "[FT] injecting node failure at step 6" in out
    assert ("[FT] re-meshing {'data': 2, 'model': 4} -> {'data': 1, "
            "'model': 4}, restoring step 4") in out
    losses = _losses(out)
    assert len(losses) >= 10
    assert losses[-1] < losses[0]        # still learning after the failure
    assert "done; final checkpoint at 12" in out
    assert Checkpointer(str(tmp_path)).latest_step() == 12


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m"])
def test_train_driver_resume(tmp_path, capsys, arch):
    """mamba2-370m is the reference's arch for its resume test."""
    base = ["--arch", arch, "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3", "--log-every", "1"]
    train_main(base + ["--steps", "6"])
    first = capsys.readouterr().out
    train_main(base + ["--steps", "9", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out
    assert [line.split()[1] for line in out.splitlines()
            if line.startswith("step ")] == ["6", "7", "8"]
    assert np.isfinite(_losses(first) + _losses(out)).all()
    assert Checkpointer(str(tmp_path)).latest_step() == 9


def test_train_driver_moe_8bit(tmp_path, capsys):
    """Reduced mixtral with 8-bit states: the MoE path, its expert loads
    feeding the re-planner's EMA."""
    train_main(["--arch", "mixtral-8x22b", "--reduced", "--device", "cpu",
                "--steps", "3", "--batch", "2", "--seq", "16",
                "--opt-bits", "8", "--ckpt-dir", str(tmp_path),
                "--log-every", "1"])
    out = capsys.readouterr().out
    assert out.startswith("arch=mixtral-8x22b")
    assert len(_losses(out)) == 3 and np.isfinite(_losses(out)).all()
    assert Checkpointer(str(tmp_path)).latest_step() == 3


def test_train_driver_refuses_to_start_without_a_card(tmp_path, monkeypatch):
    from repro_torch.core.executor import ExecutorError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ExecutorError, match="CUDA"):
        train_main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_train_driver_stub_frontends_match_the_reference(tmp_path, capsys,
                                                         monkeypatch, arch):
    check_driver(arch, tmp_path, capsys, monkeypatch, SEVEN.get(arch))
