"""The port's RecSys family against the JAX reference, on the CPU.

The same numpy inputs (``make_batch``'s draws; JAX's ``INIT`` weights
carried across in the reference's checkpoint form) go through
``repro.models.recsys`` and ``repro_torch.models.recsys``, at each arch's
``reduced()`` config, f32.

Tolerances, with the measured maxima on these seeds:
- ``make_batch``: equal bit for bit, every kind and shape kind.
- the substrate (lookups, bags, ``_ln``, the GRU cell, ``_bce``) within
  1e-6; out-of-range ids clip as ``jnp.take(..., mode="clip")`` (exact).
  ``_bce``'s gradient at a logit of exactly 0 (a dead ReLU trunk) is
  JAX's.
- the train losses within 1e-5 (measured 6.0e-8) and every gradient leaf
  within 1e-6 (measured <= 3.4e-8); the serve outputs and the functions
  under them within 1e-5 (measured 1.1e-6); the retrieval and top-k
  scores within 1e-5 (measured 5.4e-7). Matmul and reduction order differ
  between XLA's CPU and torch's, so scores differ by ulps: the ids are
  held equal where neighbouring scores are more than 4 ulp apart, and
  equal as sets inside a run of near-ties (a run that reaches the k-th
  rank holds only its scores).
- 4 AdamW steps (lr 1e-3, the reference's RecSys cell): each step's loss
  and grad norm within 1e-5, the parameters within 2 * sum(lr), their
  mean difference within 1e-6.
- a checkpoint restored across the packages equals the saver's state bit
  for bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import checkpoint as JC  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.configs import get_reduced as tget  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models import recsys as TR  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402

ARCHS = ["bert4rec", "dien", "wide-deep", "dcn-v2"]
SUB_TOL, LOSS_TOL, GRAD_TOL, OUT_TOL, STEP_TOL = 1e-6, 1e-5, 1e-6, 1e-5, 1e-5
LR, STEPS = 1e-3, 4
TIE_ULP = 4
SHAPES = {"train": dict(batch=8), "serve": dict(batch=4),
          "retrieval": dict(batch=1, n_candidates=300)}


def flat_np(tree):
    return {k: np.asarray(v) for k, v in JC._flatten(tree).items()}


@functools.lru_cache(maxsize=None)
def jax_init(arch):
    """The reference's weights from key 0, its init jitted (JAX's eager
    dispatch compiles every draw on its own)."""
    cfg = jget(arch)
    return jax.jit(lambda k: JR.INIT[cfg.kind](k, cfg))(
        jax.random.PRNGKey(0))


def carried(arch):
    jp = jax_init(arch)
    return jp, TR.params_from_numpy(tget(arch), flat_np(jp), device="cpu")


def batches(arch, kind, rng_key=0):
    """The reference's batch (jnp) and the port's (tensors) of one shape
    kind, each made by its own package."""
    return (JR.make_batch(jget(arch), JShape("c", kind, SHAPES[kind]),
                          rng_key=rng_key),
            TR.make_batch(tget(arch), ShapeSpec("c", kind, SHAPES[kind]),
                          rng_key=rng_key, device="cpu"))


def t(a):
    return torch.from_numpy(np.array(a))


def ulps(a, b):
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
            for x in (a, b))
    a = np.where(a < 0, np.int64(-2**31) - a, a)
    b = np.where(b < 0, np.int64(-2**31) - b, b)
    return np.abs(a - b)


def assert_topk(js, ji, ts, ti, label):
    """Scores within OUT_TOL; ids equal outside runs of near-ties (the
    reference's neighbouring scores within TIE_ULP), equal as sets inside
    one; a run that reaches the k-th rank holds only its scores."""
    js, ji = np.asarray(js), np.asarray(ji)
    ts, ti = ts.numpy(), ti.numpy()
    assert ti.dtype == np.int32 and ts.shape == js.shape, label
    np.testing.assert_allclose(ts, js, rtol=0, atol=OUT_TOL, err_msg=label)
    for r in range(js.shape[0]):
        k, lo = js.shape[1], 0
        while lo < k:
            hi = lo + 1
            while hi < k and ulps(js[r, hi - 1], js[r, hi]) <= TIE_ULP:
                hi += 1
            if hi < k:
                assert sorted(ji[r, lo:hi]) == sorted(ti[r, lo:hi]), \
                    (label, r, lo, ji[r, lo:hi], ti[r, lo:hi])
            lo = hi


def value_and_grad(loss, params, batch):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    value = loss(leaves, batch)
    grads = torch.autograd.grad(value, list(leaves.values()),
                                allow_unused=True)
    return value.detach(), {k: torch.zeros_like(v) if g is None else g
                            for (k, v), g in zip(leaves.items(), grads)}


# ---------------------------------------------------------------------------
# batches, init and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "serve", "retrieval"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_bit_equal(arch, kind):
    want = JR.make_batch(jget(arch), JShape("c", kind, SHAPES[kind]),
                         rng_key=3, numpy=True)
    got = TR.make_batch(tget(arch), ShapeSpec("c", kind, SHAPES[kind]),
                        rng_key=3, numpy=True)
    tens = TR.make_batch(tget(arch), ShapeSpec("c", kind, SHAPES[kind]),
                         rng_key=3, device="cpu")

    def leaves(b, pre=""):
        for k, v in b.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{pre}{k}/")
            else:
                yield f"{pre}{k}", v
    w, g, tt = dict(leaves(want)), dict(leaves(got)), dict(leaves(tens))
    assert sorted(w) == sorted(g) == sorted(tt)
    for k in w:
        assert w[k].dtype == g[k].dtype and np.array_equal(w[k], g[k]), k
        assert np.array_equal(tt[k].numpy(), w[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_params_mirror_reference(arch):
    cfg = tget(arch)
    jp = flat_np(jax_init(arch))
    tp = TR.INIT[cfg.kind](0, cfg, device="cpu")
    assert {k: v.shape for k, v in jp.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    for k, v in jp.items():    # zeros and ones exactly; draws at their scale
        if not v.any() or (v == 1).all():
            assert np.array_equal(tp[k].numpy(), v), k
        elif v.size >= 2048:
            assert abs(float(tp[k].std()) / float(v.std()) - 1) < 0.1, k
    back = TR.params_to_numpy(TR.params_from_numpy(cfg, jp, device="cpu"))
    assert all(np.array_equal(back[k], jp[k]) for k in jp)
    with pytest.raises(KeyError, match="keys differ"):
        TR.params_from_numpy(cfg, {k: v for k, v in list(jp.items())[1:]},
                             device="cpu")
    bad = dict(jp)
    k0 = next(iter(bad))
    bad[k0] = bad[k0][:1]
    with pytest.raises(ValueError, match="want"):
        TR.params_from_numpy(cfg, bad, device="cpu")


# ---------------------------------------------------------------------------
# the substrate
# ---------------------------------------------------------------------------

def test_embedding_lookup_clips_ids_past_both_ends():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(11, 5)).astype(np.float32)
    ids = np.array([[-7, -1, 0, 3], [10, 11, 12, 1000]], np.int32)
    want = np.asarray(JR.embedding_lookup(jnp.asarray(table),
                                          jnp.asarray(ids)))
    got = TR.embedding_lookup(t(table), t(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 1], table[0])     # not the last row
    np.testing.assert_array_equal(got[1, 3], table[10])


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(mode, with_valid):
    """Every mode, with and without ``valid`` (``max`` ignores it in the
    reference and in the port); ids past both ends, and a bag with no
    valid id (its mean divides by 1)."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(-3, 53, (7, 4)).astype(np.int32)
    valid = rng.random((7, 4)) < 0.6
    valid[2] = False
    kw = dict(mode=mode)
    want = JR.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                            valid=jnp.asarray(valid) if with_valid else None,
                            **kw)
    tt = t(table).requires_grad_()
    got = TR.embedding_bag(tt, t(ids), valid=t(valid) if with_valid
                           else None, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=SUB_TOL)
    w = rng.normal(size=(7, 6)).astype(np.float32)
    jg = jax.grad(lambda tb: (JR.embedding_bag(
        tb, jnp.asarray(ids), valid=jnp.asarray(valid) if with_valid
        else None, **kw) * w).sum())(jnp.asarray(table))
    g, = torch.autograd.grad((got * t(w)).sum(), tt)
    if mode != "max":        # max's gradient at a duplicated id is a tie
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                   atol=SUB_TOL)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_lookup_matches_reference(n_shards):
    """In range: the reference's ``embedding_lookup``; past either end of
    the table: zeros (the reference's mask: no shard holds the id)."""
    rng = np.random.default_rng(2)
    table = rng.normal(size=(64, 8)).astype(np.float32)
    ids = rng.integers(0, 64, (5, 3)).astype(np.int32)
    got = TR.sharded_lookup(t(table), t(ids), n_shards=n_shards).numpy()
    want = np.asarray(JR.embedding_lookup(jnp.asarray(table),
                                          jnp.asarray(ids)))
    np.testing.assert_array_equal(got, want)
    out = np.array([-5, -1, 64, 70, 1000], np.int32)
    np.testing.assert_array_equal(
        TR.sharded_lookup(t(table), t(out), n_shards=n_shards).numpy(),
        np.zeros((5, 8), np.float32))
    if n_shards > 1:
        with pytest.raises(ValueError, match="split"):
            TR.sharded_lookup(t(table[:63]), t(ids), n_shards=n_shards)


@pytest.mark.parametrize("V,chunk,ties", [(1000, 128, False),
                                          (1000, 300, True),
                                          (257, 64, True)])
def test_chunked_topk_scores_matches_reference(V, chunk, ties):
    """``chunk`` not dividing V (a padded last chunk); with ``ties`` the
    table repeats rows, so equal scores straddle chunks."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    table = rng.normal(size=(V, 8)).astype(np.float32)
    if ties:
        table[rng.integers(0, V, V // 3)] = table[:V // 3]
    js, ji = JR.chunked_topk_scores(jnp.asarray(q), jnp.asarray(table),
                                    k=10, chunk=chunk)
    ts, ti = TR.chunked_topk_scores(t(q), t(table), k=10, chunk=chunk)
    assert_topk(js, ji, ts, ti, "chunked")
    fs, fi = TR.top_k(t(q) @ t(table).T, 10)       # the unchunked top-k
    np.testing.assert_array_equal(ts.numpy(), fs.numpy())
    np.testing.assert_array_equal(ti.numpy(), fi.numpy())


def test_top_k_breaks_ties_toward_the_lower_index():
    s = jnp.asarray([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0]])
    jv, ji = jax.lax.top_k(s, 4)
    tv, ti = TR.top_k(t(s), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_gru_cell_and_augru_gate_match_reference():
    """The hand-written cell (one bias on the x side, no bias on hn, gates
    r, z, n); the AUGRU at attention 0 keeps the state exactly, at 1 it
    moves it."""
    jp = JR._init_gru(jax.random.PRNGKey(0), 4, 6)
    tp = {k: t(v) for k, v in jp.items()}
    tp["b"] = t(np.random.default_rng(4).normal(size=18).astype(np.float32))
    jp = dict(jp, b=jnp.asarray(tp["b"].numpy()))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4)).astype(np.float32)
    h = rng.normal(size=(2, 6)).astype(np.float32)
    for a in (None, np.zeros(2, np.float32), np.ones(2, np.float32),
              np.array([0.3, 0.9], np.float32)):
        want = JR._gru_cell(jp, jnp.asarray(x), jnp.asarray(h),
                            a=None if a is None else jnp.asarray(a))
        got = TR._gru_cell(tp, t(x), t(h), a=None if a is None else t(a))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=SUB_TOL)
    kept = TR._gru_cell(tp, t(x), t(h), a=torch.zeros(2))
    np.testing.assert_array_equal(kept.numpy(), h)
    moved = TR._gru_cell(tp, t(x), t(h), a=torch.ones(2))
    assert np.abs(moved.numpy() - h).max() > 1e-4
    assert set(TR._init_gru(0, 4, 6, device="cpu")) == set(jp)


def test_ln_and_bce_match_reference():
    """``_ln`` is the population variance with eps inside the rsqrt and no
    bias; ``_bce`` the stable logistic loss."""
    rng = np.random.default_rng(6)
    x = (3 + 5 * rng.normal(size=(4, 7, 16))).astype(np.float32)
    g = rng.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(
        TR._ln(t(x), t(g)).numpy(), np.asarray(JR._ln(jnp.asarray(x),
                                                      jnp.asarray(g))),
        rtol=0, atol=SUB_TOL)
    z = (10 * rng.normal(size=64)).astype(np.float32)
    y = rng.random(64).round().astype(np.float32)
    assert abs(float(TR._bce(t(z), t(y))) - float(
        JR._bce(jnp.asarray(z), jnp.asarray(y)))) <= SUB_TOL


# ---------------------------------------------------------------------------
# the four models against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    cfg_j, cfg_t = jget(arch), tget(arch)
    jp, tp = carried(arch)
    jb, tb = batches(arch, "train", 1)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JR.TRAIN_LOSS[cfg_j.kind](p, cfg_j, b)))(jp, jb)
    tl, tg = value_and_grad(
        lambda p, b: TR.TRAIN_LOSS[cfg_t.kind](p, cfg_t, b), tp, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    jf = flat_np(jg)
    assert set(jf) == set(tg)
    for k, g in tg.items():
        np.testing.assert_allclose(g.numpy(), jf[k], rtol=0, atol=GRAD_TOL,
                                   err_msg=k)


# each arch's parts of the serve path, checked beside its output
PARTS = {"bert4rec": ("bert4rec_encode",),
         "dien": ("dien_user_state", "dien_logit"),
         "wide_deep": ("wide_deep_logit",),
         "dcn_v2": ("dcn_v2_trunk", "dcn_v2_logit")}


def _parts(mod, params, cfg, batch):
    out = []
    for fn in PARTS[cfg.kind]:
        arg = batch["items"] if fn == "bert4rec_encode" else batch
        got = getattr(mod, fn)(params, cfg, arg)
        out.extend(got if isinstance(got, tuple) else (got,))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch):
    """``SERVE`` and the functions it stands on (``PARTS``)."""
    cfg_j, cfg_t = jget(arch), tget(arch)
    jp, tp = carried(arch)
    jb, tb = batches(arch, "serve", 2)
    want, want_parts = jax.jit(lambda p, b: (
        JR.SERVE[cfg_j.kind](p, cfg_j, b), _parts(JR, p, cfg_j, b)))(jp, jb)
    got = TR.SERVE[cfg_t.kind](tp, cfg_t, tb)
    if cfg_t.kind == "bert4rec":
        assert_topk(*want, *got, arch)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=OUT_TOL)
    got_parts = _parts(TR, tp, cfg_t, tb)
    assert len(got_parts) == len(want_parts)
    for w, g in zip(want_parts, got_parts):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=OUT_TOL, err_msg=arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_matches_reference(arch):
    cfg_j, cfg_t = jget(arch), tget(arch)
    jp, tp = carried(arch)
    jb, tb = batches(arch, "retrieval", 3)
    want = jax.jit(lambda p, b: JR.RETRIEVAL[cfg_j.kind](p, cfg_j, b))(jp, jb)
    got = TR.RETRIEVAL[cfg_t.kind](tp, cfg_t, tb)
    assert got[0].shape == (1, 100)
    assert_topk(*want, *got, arch)


# ---------------------------------------------------------------------------
# training, checkpoints, the CLI
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_run(arch, steps=STEPS):
    cfg = jget(arch)
    jp, tp = carried(arch)
    jb, tb = batches(arch, "train", 5)
    opt = jadamw(lr=LR)
    step = jax.jit(JTR.make_train_step(
        lambda p, b: JR.TRAIN_LOSS[cfg.kind](p, cfg, b), opt))
    st = JTR.init_train_state(jp, opt)
    states, metrics = [st], []
    for _ in range(steps):
        st, m = step(st, jb)
        states.append(st)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(step=step, states=states, metrics=metrics, tp=tp, jb=jb,
                tb=tb)


def port_step(arch):
    cfg = tget(arch)
    opt = adamw(lr=LR)
    return opt, TTR.make_train_step(
        lambda p, b: TR.TRAIN_LOSS[cfg.kind](p, cfg, b), opt)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    ref = jax_run(arch)
    opt, step = port_step(arch)
    st = TTR.init_train_state(ref["tp"], opt)
    for i in range(STEPS):
        st, m = step(st, ref["tb"])
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - ref["metrics"][i][key]) <= STEP_TOL, \
                (i, key)
        jf = flat_np(ref["states"][i + 1].params)
        d = np.concatenate([np.abs(jf[k] - v.numpy()).ravel()
                            for k, v in st.params.items()])
        assert d.max() <= 2 * LR * (i + 1) and d.mean() <= 1e-6, (i, d.max())


def test_dcn_v2_checkpoint_round_trip_across_packages(tmp_path):
    """JAX's state after 2 steps restores in the port bit for bit and
    trains on as JAX does; the port's state after 2 steps restores in
    JAX."""
    ref = jax_run("dcn-v2")
    opt, step = port_step("dcn-v2")
    JC.save(str(tmp_path / "j"), 2, ref["states"][2])
    tst = TC.restore(str(tmp_path / "j"),
                     TTR.init_train_state(ref["tp"], opt))
    want, got = flat_np(ref["states"][2]), TC.flatten(tst)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tst, m = step(tst, ref["tb"])
    assert abs(float(m["loss"]) - ref["metrics"][2]["loss"]) <= STEP_TOL

    pst = TTR.init_train_state(ref["tp"], opt)
    for _ in range(2):
        pst, _ = step(pst, ref["tb"])
    TC.save(str(tmp_path / "t"), 2, pst)
    jst = JC.restore(str(tmp_path / "t"), ref["states"][0])
    got = flat_np(jst)
    for k, v in TC.flatten(pst).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    jst, jm = ref["step"](jst, ref["jb"])
    assert abs(float(jm["loss"]) - ref["metrics"][2]["loss"]) <= STEP_TOL


def test_train_cli_trains_dcn_v2_on_cpu(capsys):
    from repro_torch.launch import train as ttrain
    assert ttrain.main(["--arch", "dcn-v2", "--device", "cpu", "--steps",
                        "6", "--log-every", "3"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()
