"""The port's optimizers (``repro_torch.optim``) against the JAX package's
(``repro.optim``) on the CPU: the same seeded numpy parameters and
gradients go through both for several steps.

Tolerances (parameters of magnitude ~1, learning rates 1e-2):
- every update, parameter and state leaf within 1e-6 after 6 steps.
  Measured: SGD 0, AdamW at most 1.9e-9, Adafactor 2.4e-7. Both compute
  each leaf elementwise in the same f32 expression; what differs is XLA's
  and torch's ``pow``, ``cos``, ``sqrt`` and ``rsqrt`` (an ulp), and the
  order of the means inside Adafactor.
- the schedules within 2 f32 ulps of the peak rate. Measured: 1 (XLA's
  and torch's ``cos`` round differently; near the end ``1 + cos`` cancels,
  so the error is the peak's ulp, not the value's); the global norm and
  the clipped gradients within 1e-6 relative. bf16 ``apply_updates``
  equal bit for bit (one f32 add, one rounding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import optim as J  # noqa: E402
from repro_torch import optim as T  # noqa: E402
from repro_torch.optim.common import leaf_order  # noqa: E402

STEPS = 6
TOL = 1e-6
SHAPES = {"embed": (6, 4), "final_norm": (4,), "layers/attn/bq": (2, 8),
          "layers/attn/wq": (2, 4, 8), "layers/mlp/w_up": (2, 4, 5),
          "lm_head": (4, 6)}


def nest(flat):
    """A flat path-keyed dict as the nested dict JAX's trees are."""
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def unnest(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(unnest(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


OPTIMIZERS = {
    "adamw": lambda m: m.adamw(lr=1e-2),
    "adamw_wd_sched": lambda m: m.adamw(
        lr=m.warmup_cosine(1e-2, 2, STEPS), weight_decay=0.1),
    "adamw_bf16_moments": lambda m: m.adamw(
        lr=1e-2, state_dtype=jnp.bfloat16 if m is J else torch.bfloat16),
    "sgd_momentum": lambda m: m.sgd_momentum(lr=1e-2),
    "adafactor": lambda m: m.adafactor(lr=1e-2),
    "adafactor_sched": lambda m: m.adafactor(lr=m.constant(1e-2),
                                             clip_threshold=0.5),
}


def _max_diff(jtree, ttree):
    jf, tf = unnest(jtree), {k: v.float().numpy() for k, v in ttree.items()}
    assert set(jf) == set(tf)
    return max(float(np.abs(jf[k].astype(np.float32) - tf[k]).max())
               for k in jf)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    jopt, topt = OPTIMIZERS[name](J), OPTIMIZERS[name](T)
    p0 = draw(0)
    jp, tp = nest({k: jnp.asarray(v) for k, v in p0.items()}), \
        {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(STEPS):
        # small gradients in the last steps: Adafactor's eps and the
        # RMS clip both take part
        g = draw(100 + i, scale=1.0 if i < 3 else 1e-3)
        ju, js = jopt.update(nest({k: jnp.asarray(v) for k, v in g.items()}),
                             js, jp)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        jp, tp = J.apply_updates(jp, ju), T.apply_updates(tp, tu)
        assert _max_diff(ju, tu) < TOL, (name, i)
        assert _max_diff(jp, tp) < TOL, (name, i)
    assert int(js.count) == int(ts.count) == STEPS
    for field in ts._fields[1:]:
        assert _max_diff(getattr(js, field), getattr(ts, field)) < TOL, field


@pytest.mark.parametrize("sched", [(3e-4, 10, 50, 0.0), (1e-2, 0, 7, 1e-4),
                                   (1.0, 3, 3, 0.5)])
def test_schedules_match_reference(sched):
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(J.warmup_cosine(*sched)(jnp.asarray(steps)))
    got = T.warmup_cosine(*sched)(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * np.spacing(np.float32(sched[0])))
    c = T.constant(sched[0])(torch.tensor(3, dtype=torch.int32))
    assert c.dtype == torch.float32 and float(c) == np.float32(sched[0])


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    g = draw(7)
    jg = nest({k: jnp.asarray(v) for k, v in g.items()})
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    np.testing.assert_allclose(float(T.global_norm(tg)),
                               float(J.global_norm(jg)), rtol=1e-6)
    (jc, jn), (tc, tn) = J.clip_by_global_norm(jg, max_norm), \
        T.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k, v in unnest(jc).items():
        np.testing.assert_allclose(tc[k].numpy(), v, rtol=1e-6, atol=1e-7)
    # the reference's leaf order: nested dicts flatten in sorted key order
    assert leaf_order(tg) == list(unnest(jg))


def test_apply_updates_rounds_once_to_the_param_dtype():
    rng = np.random.default_rng(3)
    p = rng.standard_normal((64,)).astype(np.float32)
    u = (1e-3 * rng.standard_normal((64,))).astype(np.float32)
    jp = J.apply_updates({"w": jnp.asarray(p, jnp.bfloat16)},
                         {"w": jnp.asarray(u)})["w"]
    tp = T.apply_updates({"w": torch.from_numpy(p).bfloat16()},
                         {"w": torch.from_numpy(u)})["w"]
    assert tp.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp.view(torch.int16).numpy(),
        np.asarray(jp).view(np.int16))
