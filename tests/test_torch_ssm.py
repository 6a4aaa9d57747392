"""The port's SSM family (`models/ssm.py`, mamba2-370m) against the JAX
package: the causal conv, the chunked SSD scan, the Mamba block and its
decode step, the model's forward, prefill, decode, train step and
serving engine, the duality of the chunked and recurrent forms, and the
reference's SSD fault at its published chunk sizes (ROADMAP §3), in
float32 with random values in every leaf (`_torch_family_cases`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family_cases import (MODEL_TOL, MODULE_TOL, as_torch,
                                 batch, carried, cfgs, check_decode,
                                 check_forward, check_train_step, close,
                                 jax_decode, random_params)
from repro.launch.mesh import make_mesh_compat
from repro.models import api as japi
from repro.models import ssm as JM
from repro.serve import ServingEngine as JaxEngine
from repro_torch.models import api, ssm as M
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServingEngine

NAME = "mamba2-370m"


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX params, port model): reduced mamba2-370m
    (2 layers, chunk 16)."""
    return carried(NAME)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("S", [1, 19])
def test_causal_conv(S):
    rng = np.random.default_rng(S)
    x, w, b = _rand(rng, 2, S, 24), _rand(rng, 4, 24), _rand(rng, 24)
    close(M._causal_conv(*map(torch.from_numpy, (x, w, b))),
          JM._causal_conv(*map(jnp.asarray, (x, w, b))), MODULE_TOL)


@pytest.mark.parametrize("group_elems", [None, 2 * 2 * 16 * 16 * 3],
                         ids=["one_group", "groups_of_two"])
@pytest.mark.parametrize("S,chunk", [(32, 16), (40, 16), (7, 16), (56, 16)],
                         ids=["two_chunks", "short_last_chunk",
                              "one_short_chunk", "three_and_a_short"])
def test_ssd_chunked(S, chunk, group_elems, monkeypatch):
    """S not a multiple of the chunk: the port's short last chunk against
    the reference's padded one; the full chunks in one group, and in
    groups of two (a budget of two chunks' decay elements), so a state
    crosses groups.  A's decay keeps the carried state alive across chunks
    (dA between -0.25 and -0.03 a row)."""
    if group_elems:
        monkeypatch.setattr(M, "_SSD_GROUP_ELEMS", group_elems)
    rng = np.random.default_rng(S)
    xh = _rand(rng, 2, S, 3, 8)
    dt = rng.uniform(0.3, 1.0, (2, S, 3)).astype(np.float32)
    A = -rng.uniform(0.1, 0.25, 3).astype(np.float32)
    Bm, Cm = _rand(rng, 2, S, 5), _rand(rng, 2, S, 5)
    got = M._ssd_chunked(*map(torch.from_numpy, (xh, dt, A, Bm, Cm)), chunk)
    want = JM._ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)), chunk)
    close(got, want, MODULE_TOL)
    # Chunked equals the plain recurrence (chunk S: one intra block).
    whole = M._ssd_chunked(*map(torch.from_numpy, (xh, dt, A, Bm, Cm)), S)
    torch.testing.assert_close(got, whole, atol=1e-4, rtol=1e-4)


def test_mamba_block(model):
    jcfg, cfg, jparams, tmodel = model
    x = _rand(np.random.default_rng(1), 2, 40, cfg.d_model)
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"])
    close(M.mamba_block(tmodel.blocks[1], cfg, torch.from_numpy(x)),
          JM.mamba_block(jp, jcfg, jnp.asarray(x)), MODULE_TOL)


@pytest.mark.parametrize("conv_dtype", ["float32", "bfloat16"])
def test_mamba_decode(model, conv_dtype):
    """From a random state, the conv window held in float32 or bf16 (the
    serving cache's dtype): output and new state."""
    jcfg, cfg, jparams, tmodel = model
    rng = np.random.default_rng(2)
    d_inner, H, N, conv_dim = M.dims(cfg)
    x = _rand(rng, 3, 1, cfg.d_model)
    ssm = _rand(rng, 3, H, N, cfg.ssm_head_dim, scale=0.5)
    conv = _rand(rng, 3, cfg.ssm_conv - 1, conv_dim)
    jst = {"ssm": jnp.asarray(ssm),
           "conv": jnp.asarray(conv).astype(getattr(jnp, conv_dtype))}
    tst = {"ssm": torch.from_numpy(ssm),
           "conv": torch.from_numpy(conv).to(getattr(torch, conv_dtype))}
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    want, wst = JM.mamba_decode(jp, jcfg, jnp.asarray(x), jst)
    got, st = M.mamba_decode(tmodel.blocks[0], cfg, torch.from_numpy(x), tst)
    close(got, want, MODULE_TOL)
    close(st["ssm"], wst["ssm"], MODULE_TOL)
    assert st["conv"].dtype == tst["conv"].dtype
    close(st["conv"], wst["conv"].astype(jnp.float32), MODULE_TOL)


def test_forward(model):
    """S = 40 over chunks of 16: two full chunks and a short one."""
    check_forward(*model, S=40)


def test_prefill_returns_the_cache_and_decode_steps(model):
    """Prefill gives the last logits and the cache as it was (the
    reference's trade-off); then 6 decode steps from a zeroed cache."""
    jcfg, cfg, jparams, tmodel = model
    cache = api.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    b = batch(cfg, 2, 20, 7)
    lg, out = api.prefill(tmodel, cfg, {"tokens": as_torch(b)["tokens"]},
                          cache)
    want, _ = japi.prefill(jparams, jcfg, {"tokens": jnp.asarray(b["tokens"])},
                           japi.init_cache(jcfg, 2, 16, jnp.float32))
    close(lg, want, MODEL_TOL)
    assert out is cache and all(bool(v.eq(0).all()) for v in cache.values())
    cache = check_decode(jcfg, cfg, jparams, tmodel, B=2, Smax=16, steps=6)
    assert cache["ssm"].abs().sum() > 0 and cache["conv"].abs().sum() > 0


def _replay(forward_last, decode, init, toks):
    """(forward's last logits, the logits of decode replayed over toks)."""
    cache = init()
    for t in range(toks.shape[1]):
        lg, cache = decode(cache, toks[:, t:t + 1], t)
    return forward_last(), lg


def test_duality_forward_equals_decode_replay(model):
    """The chunked form's last logits equal the recurrence replayed over
    the same 40 tokens (two chunks and a short one, so the carried state is
    used), in both packages, within MODEL_TOL."""
    jcfg, cfg, jparams, tmodel = model
    toks = batch(cfg, 2, 40, 8)["tokens"]
    B = toks.shape[0]
    jdecode = jax_decode(jcfg, jparams)
    want_f, want_d = _replay(
        lambda: japi.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             last_only=True)[0],
        lambda c, t, i: jdecode(c, jnp.asarray(t),
                                jnp.full((B,), i, jnp.int32)),
        lambda: japi.init_cache(jcfg, B, 40, jnp.float32), toks)
    np.testing.assert_allclose(np.asarray(want_d), np.asarray(want_f),
                               **MODEL_TOL)
    got_f, got_d = _replay(
        lambda: api.forward(tmodel, cfg, {"tokens": torch.from_numpy(toks)},
                            last_only=True)[0],
        lambda c, t, i: api.decode_step(tmodel, cfg, c,
                                        {"tokens": torch.from_numpy(t)},
                                        torch.full((B,), i, dtype=torch.int32)),
        lambda: api.init_cache(cfg, B, 40, torch.float32, device="cpu"), toks)
    torch.testing.assert_close(got_d, got_f, **MODEL_TOL)
    close(got_f, want_f, MODEL_TOL)


def test_train_step():
    check_train_step(NAME)


def _loss_and_grads_jax(jcfg, jp, toks):
    def loss(p):
        lg = japi.forward(p, jcfg, {"tokens": toks})[0]
        return jnp.mean(jax.nn.logsumexp(lg.astype(jnp.float32), axis=-1))
    return jax.jit(jax.value_and_grad(loss))(jp)


def _loss_and_grads_port(cfg, jp, toks):
    model = params_from_jax(jax.device_get(jp), cfg, device="cpu")
    model.requires_grad_(True)
    lg = api.forward(model, cfg, {"tokens": torch.from_numpy(toks)})[0]
    loss = torch.logsumexp(lg.float(), dim=-1).mean()
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("chunk", [16, 128])
def test_ssd_gradient_is_finite_where_the_reference_overflows(chunk):
    """ROADMAP §3: the reference takes exp(Δcum) of every (q, k) pair of a
    chunk before masking; for k > q the exponent is positive and over a
    128-row chunk overflows, so its gradient holds inf / nan (the forward
    is right).  A between -2.7 and -1.6 makes Δcum pass 88 (float32's exp
    overflow) inside 128 rows.  At chunk 128 the JAX gradient has
    non-finite entries, the port's none, and the losses agree; at chunk 16
    (no overflow) every gradient agrees within MODEL_TOL."""
    jcfg, cfg = cfgs(NAME, ssm_chunk=chunk)
    jp = random_params(jcfg, 11)
    rng = np.random.default_rng(12)
    jp["blocks"]["A_log"] = rng.uniform(0.5, 1.0, jp["blocks"]["A_log"].shape
                                        ).astype(np.float32)
    toks = np.random.default_rng(13).integers(0, cfg.vocab, (2, 256)
                                              ).astype(np.int32)
    jloss, jgrads = _loss_and_grads_jax(jcfg, jax.tree.map(jnp.asarray, jp),
                                        jnp.asarray(toks))
    loss, grads = _loss_and_grads_port(cfg, jp, toks)
    close(loss, jloss, MODEL_TOL)
    flat = {".".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(flat) == set(grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    bad = sum(int((~np.isfinite(g)).sum()) for g in flat.values())
    if chunk == 128:
        assert bad > 0
    else:
        assert bad == 0
        for n, g in grads.items():
            np.testing.assert_allclose(g.numpy(), flat[n], **MODEL_TOL,
                                       err_msg=n)


def test_serving_engine_matches_the_jax_engine(model):
    """Five requests on two slots (the JAX engine on a 1 x 1 mesh): every
    request's tokens equal, slot reuse zeroing the SSM states through the
    nested reset."""
    jcfg, cfg, jparams, tmodel = model
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, n).tolist(), m)
            for n, m in ((5, 6), (3, 8), (7, 4), (2, 10), (4, 5))]
    jeng = JaxEngine(jcfg, make_mesh_compat((1, 1), ("data", "model")), 2,
                     32, jparams)
    jr = [jeng.submit(p, m) for p, m in reqs]
    jeng.run()
    eng = ServingEngine(cfg, 2, 32, tmodel, device="cpu")
    tr = [eng.submit(p, m) for p, m in reqs]
    eng.run()
    assert [r.out for r in tr] == [r.out for r in jr]
    assert [len(r.out) for r in tr] == [m for _, m in reqs]
    assert eng.ticks == jeng.ticks
    assert eng.cache["ssm"].dtype == torch.float32
    assert eng.cache["conv"].dtype == torch.bfloat16
