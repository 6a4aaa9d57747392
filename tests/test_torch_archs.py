"""The port's model registry against the JAX package's, mirroring
`tests/test_archs_smoke.py`: every architecture's layout and parameter
count equal the reference's (full and reduced), and every one builds,
runs a forward and a decode step and (one per family) takes a train step
at reduced size in bf16 on the CPU, with finite outputs of the
reference's shapes; `input_specs` gives every (arch, shape) cell's inputs
as meta tensors of the reference's shapes and dtypes."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import input_specs as jinput_specs
from repro.models import api as japi
from repro.models.common import count_params as jcount_params
from repro.models.common import map_layout as jmap_layout
from repro_torch.configs import ARCHS, SHAPES, cell_applicable, input_specs
from repro_torch.launch.train import frontend_shapes
from repro_torch.models import api
from repro_torch.models.common import count_params, map_layout
from repro_torch.tree import flatten

ALL_ARCHS = sorted(ARCHS)
B, S = 2, 24


def _batch(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    out = {k: torch.randint(0, cfg.vocab, (B, S), generator=g,
                            dtype=torch.int32) for k in ("tokens", "labels")}
    for k, shape in frontend_shapes(cfg, B, S).items():
        out[k] = torch.randn(shape, generator=g).to(torch.bfloat16)
    return out


def _model(cfg):
    return api.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")


def test_registry_complete():
    assert sorted(ARCHS) == sorted(JARCHS) and len(ARCHS) == 10
    fams = {c.family for c in ARCHS.values()}
    assert fams == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
    for cfg in ARCHS.values():
        api.family_module(cfg)
    with pytest.raises(KeyError):
        api.layout(dataclasses.replace(ARCHS["qwen2-0.5b"], family="rnn"))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ALL_ARCHS)
def test_layout_matches_reference(name, reduced):
    jcfg, cfg = JARCHS[name], ARCHS[name]
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    got = map_layout(api.layout(cfg), lambda p, _: dataclasses.astuple(p))
    want = jmap_layout(japi.layout(jcfg), lambda p, _: dataclasses.astuple(p))
    assert got == want
    assert count_params(api.layout(cfg)) == jcount_params(japi.layout(jcfg))


def test_published_dims_and_param_counts():
    c = ARCHS["zamba2-7b"]
    assert (c.n_layers, c.d_model, c.ssm_state) == (81, 3584, 64)
    expect = {"seamless-m4t-medium": 1.2e9, "mamba2-370m": 0.37e9,
              "zamba2-7b": 7e9, "llama-3.2-vision-90b": 90e9}
    for name, target in expect.items():
        n = count_params(api.layout(ARCHS[name]))
        assert 0.5 * target < n < 1.8 * target, (name, n, target)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_forward_smoke(name):
    """The model's tree holds the layout's paths; a forward gives finite
    logits of (B, S, padded_vocab)."""
    cfg = ARCHS[name].reduced()
    model = _model(cfg)
    want = set(flatten(map_layout(api.layout(cfg), lambda p, _: p)))
    assert set(flatten(model.tree())) == want
    assert {n.replace(".", "/") for n, _ in model.named_parameters()} == want
    logits, aux = api.forward(model, cfg, _batch(cfg, 1))
    assert logits.shape == (B, S, cfg.padded_vocab())
    assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())
    if cfg.family == "moe":
        assert int(aux["expert_load"].sum()) == B * S * cfg.topk * cfg.n_layers
    else:
        assert aux == {}


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_decode_smoke(name):
    """One decode step from a zeroed cache: finite logits, the cache's
    keys, shapes and dtypes kept (its leaves written in place)."""
    cfg = ARCHS[name].reduced()
    model = _model(cfg)
    cache = api.init_cache(cfg, B, 32, device="cpu")
    before = {k: None if v is None else (tuple(v.shape), v.dtype)
              for k, v in flatten(cache).items()}
    tok = torch.randint(0, cfg.vocab, (B, 1), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(2))
    logits, cache2 = api.decode_step(model, cfg, cache, {"tokens": tok},
                                     torch.zeros(B, dtype=torch.int32))
    assert logits.shape == (B, 1, cfg.padded_vocab())
    assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())
    assert cache2 is cache
    assert {k: None if v is None else (tuple(v.shape), v.dtype)
            for k, v in flatten(cache2).items()} == before


@pytest.mark.parametrize("name", ["qwen3-14b", "mixtral-8x22b", "mamba2-370m",
                                  "zamba2-7b", "seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_train_step_smoke(name):
    """One loss + gradient per family representative: finite loss, a
    finite and nonzero gradient."""
    from repro_torch.train import loss_fn
    cfg = ARCHS[name].reduced()
    model = _model(cfg)
    model.requires_grad_(True)
    loss, _ = loss_fn(model, cfg, _batch(cfg, 1))
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    gsum = sum(float(p.grad.float().abs().sum()) for p in model.parameters()
               if p.grad is not None)
    assert np.isfinite(gsum) and gsum > 0


def test_input_specs_cells():
    """All 40 cells well-defined; skip rules match DESIGN.md (the
    reference's test_archs_smoke.py::test_input_specs_cells)."""
    n_run = 0
    for name, cfg in ARCHS.items():
        for shape in SHAPES:
            ok, reason = cell_applicable(cfg, shape)
            if shape == "long_500k":
                assert ok == (cfg.family in ("ssm", "hybrid")), name
            if not ok:
                assert reason
                continue
            spec = input_specs(cfg, shape)
            assert "tokens" in spec
            cell = SHAPES[shape]
            if cell.kind == "decode":
                assert spec["tokens"].shape == (cell.global_batch, 1)
                assert spec["pos"].shape == (cell.global_batch,)
            else:
                assert spec["tokens"].shape == (cell.global_batch, cell.seq_len)
            n_run += 1
    assert n_run == 32    # 40 cells - 8 long_500k skips (ssm+hybrid run theirs)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_input_specs_equal_the_reference(name):
    """Every shape cell of the arch: the same keys, shapes and dtypes as
    the reference's ShapeDtypeStructs, as meta tensors (no storage)."""
    for shape in SHAPES:
        got = input_specs(ARCHS[name], shape)
        want = jinput_specs(JARCHS[name], shape)
        assert list(got) == list(want), shape
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (shape, k)
            assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)
