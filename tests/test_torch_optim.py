"""The port's optimizer substrate (AdamW with float32 and 8-bit states,
the warmup-cosine schedule, error-feedback gradient compression) against
the JAX package: the reference's seven tests of test_optim.py on the
port, and the port's `adamw.apply` against JAX's from equal parameters,
gradients and states.

Tolerances: parameters after 3 steps within atol = rtol = 1e-6 (float32;
the two frameworks' pow, sqrt and reductions differ in the last ulp);
int8 states equal or one quantization step apart; the gradient norm within
rtol 1e-6; the schedule within 1e-7."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.launch.mesh import make_mesh_compat, shard_map_compat
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro_torch.optim import AdamWConfig, adamw, grad_compress
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.tree import flatten

PARAM_TOL = dict(atol=1e-6, rtol=1e-6)


def _quad_problem():
    params = {"w": torch.from_numpy(np.random.default_rng(0).normal(
                  size=(8, 16)).astype(np.float32)),
              "b": torch.zeros(16)}
    target = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 16)).astype(np.float32))

    def loss(p):
        return torch.mean((p["w"] + p["b"] - target) ** 2)

    return params, loss


def _grad(loss, params):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    g = torch.autograd.grad(loss(leaves), list(leaves.values()))
    return dict(zip(leaves, g))


@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_converges(bits):
    cfg = AdamWConfig(lr=5e-2, weight_decay=0.0, state_bits=bits)
    params, loss = _quad_problem()
    state = adamw.init(params, cfg)
    l0 = float(loss(params))
    for _ in range(60):
        g = _grad(loss, params)
        params, state, metrics = adamw.apply(params, state, g, cfg)
    assert float(loss(params)) < 0.05 * l0
    assert int(state["step"]) == 60 and state["step"].dtype == torch.int32
    assert np.isfinite(float(metrics["grad_norm"]))


def test_int8_states_close_to_fp32():
    """Trajectories agree early (quantization noise stays bounded)."""
    outs = {}
    for bits in (32, 8):
        cfg = AdamWConfig(lr=1e-2, weight_decay=0.0, state_bits=bits)
        p, loss = _quad_problem()
        s = adamw.init(p, cfg)
        for _ in range(10):
            p, s, _ = adamw.apply(p, s, _grad(loss, p), cfg)
        outs[bits] = p
    diff = float((outs[8]["w"] - outs[32]["w"]).abs().max())
    scale = float(outs[32]["w"].abs().max())
    assert diff < 0.05 * scale


def test_grad_clip():
    cfg = AdamWConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0)
    params = {"w": torch.ones(4)}
    before = params["w"].clone()
    state = adamw.init(params, cfg)
    g = {"w": torch.full((4,), 1e6)}
    p2, _, m = adamw.apply(params, state, g, cfg)
    assert float(m["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    assert float((p2["w"] - before).abs().max()) < 2.0   # clipped step
    assert p2["w"] is params["w"]                        # updated in place


def test_warmup_cosine_shape():
    assert warmup_cosine(0, warmup=100, total=1000) == 0.0
    assert warmup_cosine(100, warmup=100, total=1000) == pytest.approx(1.0)
    assert warmup_cosine(1000, warmup=100, total=1000) == pytest.approx(0.1)
    mid = warmup_cosine(550, warmup=100, total=1000)
    assert 0.1 < mid < 1.0
    for step in (0, 1, 57, 100, 101, 550, 999, 1000, 2000):
        for kw in (dict(warmup=100, total=1000), dict(warmup=1, total=5),
                   dict(warmup=0, total=0)):
            want = float(jwarmup_cosine(step, **kw))
            got = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
            assert got.dtype == torch.float32 and got.ndim == 0
            assert float(got) == pytest.approx(want, abs=1e-7)
            assert warmup_cosine(step, **kw) == pytest.approx(want, abs=1e-7)


def test_compress_roundtrip_bounded_error():
    rng = np.random.default_rng(0)
    xn = (rng.normal(size=(64, 64)) * 3.0).astype(np.float32)
    x = torch.from_numpy(xn)
    q, s = grad_compress.compress(x)
    err = (grad_compress.decompress(q, s) - x).abs()
    assert q.dtype == torch.int8
    assert float(err.max()) <= float(s) * 0.51 + 1e-6   # half-step rounding
    jq, js = jgc.compress(jnp.asarray(xn))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_error_feedback_accumulates():
    """EF makes the AVERAGE of repeated compressions unbiased, and each
    step's (q, scale, residual) is the reference's."""
    rng = np.random.default_rng(1)
    xn = (rng.normal(size=(256,)) * 1e-3).astype(np.float32)
    x = torch.from_numpy(xn)
    err, jerr = torch.zeros_like(x), jnp.zeros(256, jnp.float32)
    total = torch.zeros_like(x)
    n = 50
    for _ in range(n):
        q, s, err = grad_compress.ef_compress(x, err)
        jq, js, jerr = jgc.ef_compress(jnp.asarray(xn), jerr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-9)
        total = total + grad_compress.decompress(q, s)
    np.testing.assert_allclose((total / n).numpy(), xn,
                               atol=float(np.abs(xn).max()) * 0.05)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_compressed_psum_in_shard_map():
    """compressed_psum over 8 ranks (a leading axis on one device) equals
    the reference's shard_map over an 8-device axis: every rank holds the
    same sum, within 1e-6 of JAX's, and each rank's residual within 1e-6
    of JAX's (a few float32 ulps of the |x| ~ 3 it is taken from: XLA may
    fuse target - q·scale into one rounding)."""
    mesh = make_mesh_compat((8,), ("pod",))
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(8, 32)).astype(np.float32)
    errs = (rng.normal(size=(8, 32)) * 1e-3).astype(np.float32)

    def f(x, e):
        total, new_e = jgc.compressed_psum(x[0], "pod", e[0])
        return total[None], new_e[None]

    want, want_err = jax.jit(shard_map_compat(
        f, mesh=mesh, in_specs=(P("pod"), P("pod")),
        out_specs=(P("pod"), P("pod"))))(jnp.asarray(xs), jnp.asarray(errs))
    got, got_err = grad_compress.compressed_psum(torch.from_numpy(xs),
                                                 torch.from_numpy(errs))
    assert got.shape == (8, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got_err.numpy(), np.asarray(want_err),
                               atol=1e-6)
    expect = (xs + errs).sum(axis=0)
    for d in range(8):
        np.testing.assert_array_equal(got[d].numpy(), got[0].numpy())
        np.testing.assert_allclose(got[d].numpy(), expect,
                                   atol=0.02 * np.abs(expect).max())
    assert grad_compress.init_error({"a": torch.ones(3, 2)})["a"].eq(0).all()


# ---------------------------------------------------------------------------
# The port's apply against JAX's
# ---------------------------------------------------------------------------

def _tree(rng):
    """Parameters of the layouts' shapes: a stacked (layer, slot, rows,
    cols) leaf, a matrix and a vector."""
    return {"blocks": {"w1": rng.normal(size=(2, 3, 5, 12)).astype(np.float32),
                       "norm": rng.normal(size=(2, 12)).astype(np.float32)},
            "embed": {"tok": rng.normal(size=(7, 12)).astype(np.float32)}}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _state_equal_or_one_step(got, want, bits):
    for key, w in flatten(jax.tree.map(np.asarray, want)).items():
        g = flatten(got)[key].numpy()
        if key.endswith(("_q",)):
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, key
        else:
            np.testing.assert_allclose(g, w, **PARAM_TOL, err_msg=key)


@pytest.mark.parametrize("bits", [32, 8])
def test_apply_matches_jax(bits):
    """Three steps from equal parameters, gradients and states (the 8-bit
    state starts from a JAX step, so it is non-zero and its scales are
    read): parameters within 1e-6, `step` equal, int8 states equal or one
    step apart, float32 states and scales within 1e-6, grad_norm within
    rtol 1e-6.  A learning-rate scale below 1 and weight decay on."""
    rng = np.random.default_rng(bits)
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0, state_bits=bits)
    jcfg, cfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    js = jadamw.init(jp, jcfg)
    jp, js, _ = jadamw.apply(jp, js, jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), jp),
        jcfg, 0.5)
    params, state = _to_torch(jax.device_get(jp)), _to_torch(
        jax.device_get(js))
    for i in range(3):
        g = _tree(rng)
        jp, js, jm = jadamw.apply(jp, js, jax.tree.map(jnp.asarray, g),
                                  jcfg, jnp.float32(0.75))
        params, state, m = adamw.apply(params, state, _to_torch(g), cfg,
                                       torch.tensor(0.75))
        assert int(state["step"]) == int(js["step"]) == i + 2
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
        for key, want in flatten(jax.device_get(jp)).items():
            np.testing.assert_allclose(flatten(params)[key].numpy(),
                                       np.asarray(want), **PARAM_TOL,
                                       err_msg=key)
        _state_equal_or_one_step(state["mu"], js["mu"], bits)


@pytest.mark.parametrize("bits", [32, 8])
def test_sliced_update_gives_the_same_bits(monkeypatch, bits):
    """A slice of one row (and of two) updates a stacked leaf to the same
    bits as the whole leaf at once: _q8 scales rows over the last axis."""
    rng = np.random.default_rng(5)
    cfg = AdamWConfig(lr=3e-2, state_bits=bits)
    outs = []
    for slice_elems in (1 << 25, 12, 24):
        monkeypatch.setattr(adamw, "_SLICE", slice_elems)
        rng = np.random.default_rng(5)
        params = _to_torch(_tree(rng))
        state = adamw.init(params, cfg)
        for _ in range(3):
            params, state, m = adamw.apply(params, state,
                                           _to_torch(_tree(rng)), cfg)
        outs.append((flatten(params), flatten(state), float(m["grad_norm"])))
    for p, s, _ in outs[1:]:
        for key, t in outs[0][0].items():
            assert torch.equal(p[key], t), key
        for key, t in outs[0][1].items():
            assert torch.equal(s[key], t), key
    assert outs[1][2] == pytest.approx(outs[0][2], rel=1e-6)


def test_bf16_parameters_keep_their_dtype_and_states_their_layout():
    params = {"w": torch.randn(3, 4, 8).to(torch.bfloat16)}
    for bits, keys in ((32, {"m", "v"}), (8, {"m_q", "m_s", "v_q", "v_s"})):
        cfg = AdamWConfig(lr=1e-2, state_bits=bits)
        s = adamw.init(params, cfg)
        assert set(s["mu"]["w"]) == keys
        if bits == 8:
            assert s["mu"]["w"]["m_q"].dtype == torch.int8
            assert s["mu"]["w"]["m_s"].shape == (3, 4, 1)
        p = {"w": params["w"].clone()}
        p, s, _ = adamw.apply(p, s, {"w": torch.randn(3, 4, 8).to(
            torch.bfloat16)}, cfg, 1.0)
        assert p["w"].dtype == torch.bfloat16
        assert not torch.equal(p["w"], params["w"])
