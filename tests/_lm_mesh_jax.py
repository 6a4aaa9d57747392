"""The JAX package's side of the LM mesh tests (tests/_torch_lm_mesh_cases.py
holds the ranks' side): the reference's pjit train step on a mesh of the
case's shape over the test session's virtual devices, from the seed-made
float32 parameters; each step's metrics, its parameters and optimizer
state as numpy before each step and after the last (chained or, for an
unchained case, each step from the reference's own state: the same
sequence), and the shape of every leaf's shard on each device, by the
rank at that mesh position (rank r at (r // model, r % model)).

The parameters' check is condition-aware (`adam_ranges`).  AdamW moves
an element by lr·m̂/(√v̂ + eps); where √v̂ is near eps = 1e-8 that move
takes the last bits of the gradient into a share of lr.  Each package's
update equals the float64 update of its own gradient and moments to
float32 rounding; the gradients themselves, float32 sums in other
orders, differ by up to ~40 ulps of the leaf's largest gradient (reduced
zamba2 and seamless-m4t, the first update).  So an element is held to
PARAM_TOL unless the float64 update of the reference's own gradient and
moments shows that an error of GRAD_ULPS ulps of its leaf's largest
gradient moves it further than PARAM_TOL (a gradient of exactly zero, an
embedding row no token selects, sums nothing): such an element is
ill-conditioned and held to the range AdamW's update can take, 2·lr·U a
step from the first step that shows it on (U: the largest |m̂/√v̂|
AdamW's b1, b2 allow after t steps).  Every element past PARAM_TOL must
be ill-conditioned and inside its range; a case exempts at most
MAX_EXEMPT elements.  8-bit states (no float32 moments) keep the flat
bound."""
from __future__ import annotations

import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import _torch_lm_mesh_cases as lc
from repro.configs import ARCHS
from repro.models.common import init_params
from repro.optim import AdamWConfig, adamw
from repro.train import build_train_step


PARAM_TOL = 1e-3
STATE_TOL = 1e-5
# The gradient's float32 error, in ulps of its leaf's largest |g|: the
# B·S = 64 token rows a weight's gradient sums (the n·u bound of a sum of
# n terms); the first update measured ~40 (reduced zamba2, seamless-m4t).
GRAD_ULPS = lc.B * lc.S
MAX_EXEMPT = 8
B1, B2, EPS = 0.9, 0.95, 1e-8
assert lc.PARAM_LISTED == PARAM_TOL


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}{k}/"))
    return out


def jax_case(case: str) -> dict:
    arch, n_micro, bits, shape, _ = lc.CASES[case]
    cfg = ARCHS[arch].reduced()
    return jax_steps(cfg, n_micro, bits, shape, lc.batch(cfg.vocab))


def jax_steps(cfg, n_micro: int, bits: int, shape, batch: dict,
              adjust=None) -> dict:
    """The reference's steps of `cfg` on a mesh of `shape` over `batch`
    (numpy, its keys and shapes the step's), from the seed-made float32
    parameters, `adjust(params)` (numpy leaves) applied to them first
    where given (`jax_case`'s body)."""
    devices = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    mesh = Mesh(devices, ("data", "model"))
    babs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
            for k, v in batch.items()}
    ocfg = AdamWConfig(lr=lc.LR, state_bits=bits)
    fns = build_train_step(cfg, mesh, babs, n_micro=n_micro, opt_cfg=ocfg,
                           donate=False, **lc.STEP_KW)
    params = init_params(fns.layout, jax.random.key(0), jnp.float32)
    if adjust is not None:
        params = adjust(jax.device_get(params))
    params = jax.device_put(params, fns.param_shardings)
    opt = jax.device_put(adamw.init(params, ocfg), fns.opt_shardings)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics, states = [], [jax.device_get((params, opt))]
    for _ in range(lc.STEPS):
        params, opt, m = fns.step(params, opt, jb)
        metrics.append(jax.device_get(m))
        states.append(jax.device_get((params, opt)))
    by_device = {d: r for r, d in enumerate(devices.reshape(-1))}
    shapes = [dict() for _ in by_device]
    for prefix, tree in (("params", params), ("opt", opt)):
        for key, arr in _flat(tree).items():
            for sh in arr.addressable_shards:
                shapes[by_device[sh.device]][f"{prefix}/{key}"] = tuple(
                    sh.data.shape)
    return {"metrics": metrics, "states": states, "batch": batch,
            "shapes": shapes, "opt_step": int(opt["step"])}


def run(cases, tmp_path_factory, name: str) -> tuple[list[dict], dict]:
    """The reference's cases, written for the ranks, then 4 ranks spawned
    over them; (every rank's results, {case: the reference's})."""
    d = tmp_path_factory.mktemp(name)
    want = {}
    for case in cases:
        want[case] = jax_case(case)
        with open(d / f"{case}.pkl", "wb") as f:
            pickle.dump({"states": want[case]["states"],
                         "batch": want[case]["batch"]}, f)
    deadline = time.monotonic() + lc.DEADLINE_S
    import _torch_mesh_cases as mc
    ctx = mc.spawn_ranks(lc.lm_rank, 4, str(d / "store"), str(d),
                         list(cases))
    mc.join_ranks(ctx, deadline)
    return mc.load_ranks(d, 4), want


def check_case(ranks, want, case, shape=None):
    """Every rank's metrics of `case` against the reference's and the
    one-process step's, alike on every rank, its shard shapes the
    reference's, no kernel launched, its mesh coordinate (`shape`: the
    mesh's, by default the LM case's)."""
    shape = shape or lc.CASES[case][3]
    for r, rank in enumerate(ranks):
        got = rank[case]
        lc.check_metrics(got["metrics"], want[case]["metrics"], case)
        lc.check_metrics(got["metrics"], got["one"], case)
        for k, v in got["metrics"][-1].items():   # every rank the same
            np.testing.assert_array_equal(v, ranks[0][case]["metrics"][-1][k])
        assert got["shapes"] == want[case]["shapes"][r], (case, r)
        assert all(v == 0 for v in got["launches"].values())
        assert got["coordinate"] == (r // shape[1], r % shape[1])


def _adam_range(t: int) -> float:
    """The largest |m̂/√v̂| after t AdamW steps from zero moments, over every
    gradient sequence (Cauchy–Schwarz on m's and v's weighted sums)."""
    k = np.arange(t)
    return float((1 - B1) / (1 - B1 ** t)
                 * np.sqrt(np.sum((B1 * B1 / B2) ** k))
                 * np.sqrt((1 - B2 ** t) / (1 - B2)))


def adam_ranges(states, metrics, chained: bool) -> list[dict]:
    """For each step of the reference's run (`states`: its (params, opt)
    before each step and after the last; `metrics`: each step's), {leaf:
    the bound of each element, NaN where it keeps PARAM_TOL} (module
    docstring), in float64 from the reference's own moments: the gradient
    g = (m_t - b1·m_{t-1}) / (1 - b1), the update's sensitivity
    |∂(lr·m̂/(√v̂ + eps))/∂g| through m and v, times GRAD_ULPS ulps of the
    leaf's largest |g|.  Chained, an element once ill-conditioned stays
    held, its range summed over the steps since; unchained (each step from
    the reference's state), each step alone."""
    out, held, span = [], {}, {}
    for i, m in enumerate(metrics[:len(states) - 1]):
        o0, o1 = _flat(states[i][1]), _flat(states[i + 1][1])
        t = int(np.asarray(o1["step"]))
        lr = lc.LR * float(m["lr_scale"])
        b1c, b2c = 1 - B1 ** t, 1 - B2 ** t
        step = {}
        for key in _flat(states[i + 1][0]):
            if f"mu/{key}/m" not in o1:
                continue
            m0 = np.asarray(o0[f"mu/{key}/m"], np.float64)
            m1 = np.asarray(o1[f"mu/{key}/m"], np.float64)
            g = (m1 - B1 * m0) / (1 - B1)
            root = np.sqrt(np.asarray(o1[f"mu/{key}/v"], np.float64) / b2c)
            den = root + EPS
            with np.errstate(divide="ignore", invalid="ignore"):
                via_v = np.where(root > 0, np.abs(m1 / b1c) / den ** 2
                                 * (1 - B2) * np.abs(g) / (b2c * root), 0.0)
            dg = GRAD_ULPS * 2.0 ** -24 * np.abs(g).max(initial=0.0)
            # A gradient of exactly 0 (an embedding row no token selects)
            # sums no term and carries no rounding.
            ill = ((lr * ((1 - B1) / (b1c * den) + via_v) * dg > PARAM_TOL)
                   & (g != 0))
            if not chained or key not in held:
                held[key], span[key] = np.zeros(g.shape, bool), np.zeros(g.shape)
            held[key] = (held[key] | ill) if chained else ill
            span[key] = np.where(held[key], span[key] + 2 * lr * _adam_range(t),
                                 0.0)
            step[key] = np.where(held[key], PARAM_TOL + span[key], np.nan)
        out.append(step)
    return out


def check_blocks(ranks, case, want=None, chained=True):
    """Every rank's blocks after each step against the reference's and
    the one-process step's (module docstring): with the reference's run
    `want`, the parameters past PARAM_TOL against `adam_ranges`; the
    exempted elements printed and counted.  Returns them: {(step, leaf,
    index): (largest difference, its bound)}."""
    ranges = (adam_ranges(want["states"], want["metrics"], chained)
              if want is not None else None)
    exempt = {}
    for rank in ranks:
        for i, step in enumerate(rank[case]["errors"]):
            for part, leaves in step.items():
                for key, err in leaves.items():
                    where = (case, i, part, key, err)
                    if key == "step":
                        assert err["ref"] == err["one"] == 0, where
                    elif key.endswith("_q"):
                        assert max(err["ref"], err["one"]) <= 1, where
                    elif key.endswith("_s"):
                        assert err["ref_rel"] <= 1e-3, where
                    elif part == "params" and ranges is not None and (
                            max(err["ref"], err["one"]) > PARAM_TOL):
                        bound = ranges[i].get(key)
                        assert bound is not None, where
                        assert err["n_over"] == len(err["over"]), where
                        for idx, e_ref, e_one in err["over"]:
                            e = max(e_ref, e_one)
                            assert e <= bound[idx], (where, idx, float(
                                bound[idx]))
                            exempt[(i, key, idx)] = (e, float(bound[idx]))
                    else:
                        tol = PARAM_TOL if part == "params" else STATE_TOL
                        assert max(err["ref"], err["one"]) <= tol, where
    if ranges is not None:
        ill = sum(int(np.isfinite(b).sum()) for b in ranges[-1].values())
        print(f"{case}: {ill} ill-conditioned elements after the last step, "
              f"{len({k[1:] for k in exempt})} exempted: {exempt}")
    assert len({k[1:] for k in exempt}) <= MAX_EXEMPT, (case, exempt)
    return exempt
