"""The port's encoder-decoder family (`models/encdec.py`,
seamless-m4t-medium) against the JAX package, in float32 with random
values in every leaf (`_torch_family_cases`): bidirectional chunked
attention, cross-attention dense and chunked, the forward (dense and
chunked attention), prefill then decode and a train step.  (The driver's
stub `frames` are held against the reference driver's in
test_torch_pipeline_and_driver.py.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family_cases import (MODEL_TOL, MODULE_TOL, carried, cfgs,
                                 check_decode, check_forward,
                                 check_train_step, close)
from repro.models import encdec as JE
from repro.models import layers as JL
from repro_torch.models import encdec as E
from repro_torch.models import layers as L

NAME = "seamless-m4t-medium"


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("S,chunk", [(32, 8), (29, 8)])
def test_bidirectional_chunked_attention(S, chunk):
    """causal=False: every key visible; a short last chunk (S = 29) where
    the reference pads and masks."""
    rng = np.random.default_rng(S)
    q, k, v = _rand(rng, 2, S, 4, 32), _rand(rng, 2, S, 2, 32), \
        _rand(rng, 2, S, 2, 32)
    got = L._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), 0, 0, chunk,
                          causal=False)
    close(got, JL._sdpa_chunked(*map(jnp.asarray, (q, k, v)), 0, 0, chunk,
                                causal=False), MODULE_TOL)
    dense = L._sdpa_dense(*map(torch.from_numpy, (q, k, v)),
                          torch.zeros((S, S)))
    torch.testing.assert_close(got, dense, **MODULE_TOL)


@pytest.mark.parametrize("changes", [{}, {"attn_chunk": 4},
                                     {"attn_chunk": 4, "qk_norm": True}],
                         ids=["dense", "chunked", "chunked_qk_norm"])
def test_cross_attention(changes):
    """Sq·Skv = 12·10 past attn_chunk² = 16: the KV side in chunks of 4
    (10 = 4 + 4 + 2); the optional q/k norm."""
    jcfg, cfg = cfgs(NAME, **changes)
    rng = np.random.default_rng(3)
    lay = L.cross_attention_layout(cfg)
    assert not {"bq", "bk", "bv"} & set(lay)
    p = {k: 0.2 * _rand(rng, *pd.shape) for k, pd in lay.items()}
    x, src = _rand(rng, 2, 12, cfg.d_model), _rand(rng, 2, 10, cfg.d_model)
    got = L.cross_attention({k: torch.from_numpy(v) for k, v in p.items()},
                            cfg, torch.from_numpy(x), torch.from_numpy(src))
    want = JL.cross_attention({k: jnp.asarray(v) for k, v in p.items()},
                              jcfg, jnp.asarray(x), jnp.asarray(src))
    close(got, want, MODULE_TOL)


@pytest.mark.parametrize("changes", [{}, {"attn_chunk": 4}],
                         ids=["dense", "chunked"])
def test_encode_and_forward(changes):
    """The encoder alone, then the model (24 decoder tokens over 6 frames;
    chunked: the encoder's bidirectional chunks, the decoder's causal ones
    and the cross-attention's)."""
    jcfg, cfg, jparams, model = carried(NAME, **changes)
    frames = _rand(np.random.default_rng(4), 2, 6, cfg.d_model)
    close(E.encode(model, cfg, torch.from_numpy(frames)),
          JE.encode(jparams, jcfg, jnp.asarray(frames)), MODEL_TOL)
    check_forward(jcfg, cfg, jparams, model)


def test_prefill_then_decode():
    """Prefill of 8 tokens over 2 frames fills k, v[:, :, :8] and replaces
    enc_out (2 rows, not init_cache's 16 // 4 = 4); then 6 decode steps."""
    jcfg, cfg, jparams, model = carried(NAME)
    cache = check_decode(jcfg, cfg, jparams, model, B=2, Smax=16, steps=6,
                         prompt=8)
    assert cache["enc_out"].shape == (2, 2, cfg.d_model)


def test_train_step():
    check_train_step(NAME)

