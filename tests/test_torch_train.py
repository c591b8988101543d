"""The port's training path against the JAX reference, on the CPU: the
chunked cross-entropy, ``lm_loss`` and its gradients, the attention's
autograd (the kernel wrapper's ``torch.autograd.Function``), train steps
at microbatches 1 and 2, train checkpoints across the packages, and the
checkpoint/restart replay.

Inputs and weights are numpy arrays from seeds, JAX's ``init_lm`` weights
carried across in the reference's checkpoint form. The model is the
reduced qwen2-1.5b in f32 (QKV bias, tied head, GQA group 2) and, for the
loss, the reduced phi3-mini (untied head, group 1).

Tolerances, with the measured maxima:
- ``chunked_softmax_xent``: loss and gradients within 1e-6 (measured 0 /
  7.5e-9).
- ``lm_loss``: the loss within 1e-5 (measured 4.8e-7); every gradient
  leaf within 1e-6 (measured 9.7e-8; gradients up to 0.088).
- the attention's gradients against ``jax.grad`` of
  ``layers.chunked_attention``: within 1e-6 of the largest |gradient|
  (measured 4.3e-7 of it; gradients up to 6.1, differences up to 2.4e-6).
- 10 AdamW steps on warmup-cosine(3e-3, 3, 10): each step's loss and
  grad norm within 1e-5 (measured 1.9e-6 / 7.2e-7); the first step's
  gradients within 1e-6 (measured 1.5e-7). The parameters after step t
  within 2 * sum(lr_1..lr_t) (an entry whose gradient is near 0 may take
  Adam's +-lr step the other way: the sign of a gradient of ~1e-8 is
  rounding), measured 9.0e-5 against 0.030 after 10 steps; and their mean
  |difference| within 1e-6, measured 9.5e-9: a wrong formula moves every
  entry by ~lr.
- a checkpoint restored across the packages equals the saver's state bit
  for bit; the next steps are held as above. ``run_with_failures`` equals
  the uninterrupted run bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget  # noqa: E402
from repro.configs.base import scaled as jscaled  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import warmup_cosine as jwarmup  # noqa: E402
from repro.train import checkpoint as JC  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.configs import get_reduced as tget  # noqa: E402
from repro_torch.configs.base import scaled as tscaled  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw, warmup_cosine  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import fault as TF  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402

ARCH = "qwen2-1.5b"
B, S = 4, 32
STEPS = 10
PEAK, WARMUP = 3e-3, 3
STEP_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in JC._flatten(tree).items()}


def configs(arch=ARCH, **kw):
    return (jscaled(jget(arch), dtype="float32", **kw),
            tscaled(tget(arch), dtype="float32", **kw))


def lm_batch(seed, vocab=256, b=B, s=S):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, s)).astype(np.int32),
            rng.integers(0, vocab, (b, s)).astype(np.int32))


def sum_lr(t):
    f = warmup_cosine(PEAK, WARMUP, STEPS)
    return float(sum(f(torch.tensor(i, dtype=torch.int32))
                     for i in range(1, t + 1)))


def assert_params_close(jparams, tparams, t):
    jf = _flat_np(jparams)
    d = np.concatenate([np.abs(jf[k] - v.detach().numpy()).ravel()
                        for k, v in tparams.items()])
    assert d.max() <= 2 * sum_lr(t), (t, d.max())
    assert d.mean() <= 1e-6, (t, d.mean())


def test_chunked_softmax_xent_matches_reference():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 32, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((16, 40))).astype(np.float32)
    lab = rng.integers(0, 40, (2, 32)).astype(np.int32)
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda a, b: JL.chunked_softmax_xent(a, b, jnp.asarray(lab),
                                             chunk=8),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    tl = TL.chunked_softmax_xent(th, tw, _t(lab), chunk=8)
    tgh, tgw = torch.autograd.grad(tl, (th, tw))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tgh.numpy(), np.asarray(jgh), atol=1e-6)
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), atol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        TL.chunked_softmax_xent(th, tw, _t(lab), chunk=12)


@pytest.mark.parametrize("arch,remat", [(ARCH, False), (ARCH, True),
                                        ("phi3-mini-3.8b", False)])
def test_lm_loss_and_grads_match_reference(arch, remat):
    jcfg, tcfg = configs(arch, remat=remat)
    params = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    toks, lab = lm_batch(1, s=64)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jnp.asarray(toks),
                             jnp.asarray(lab))))(params)
    tp = {k: _t(v).requires_grad_() for k, v in _flat_np(params).items()}
    tl = TT.lm_loss(tp, tcfg, _t(toks), _t(lab))
    tg = dict(zip(tp, torch.autograd.grad(tl, list(tp.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=1e-5)
    jgf = _flat_np(jg)
    assert set(jgf) == set(tg)
    for k, g in tg.items():
        np.testing.assert_allclose(g.numpy(), jgf[k], rtol=0, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_grad_matches_reference(causal):
    """GQA (6 query heads on 2 KV heads), a length of 40 that the port's
    KV tile of 16 does not divide (a ragged last tile); JAX's chunks are
    8."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 6, 40, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 40, 16)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal((2, 6, 40, 16)).astype(np.float32)

    def jloss(q, k, v):
        o = JL.chunked_attention(q, k, v, causal=causal, q_chunk=8,
                                 kv_chunk=8)
        return (o * jnp.asarray(w)).sum()
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    o = FA.attention(tq, tk, tv, causal=causal, block_k=16)
    tg = torch.autograd.grad((o * _t(w)).sum(), (tq, tk, tv))
    for name, a, b in zip("qkv", tg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max(),
                                   err_msg=f"d{name}")


@pytest.fixture(scope="module")
def reference_run():
    """JAX's 10 steps at microbatches 1 and 2 on shared weights and
    batches: {mb: (states after each step, metrics)}, with the jitted
    step functions."""
    jcfg, tcfg = configs()
    params = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    batches = [lm_batch(10 + i) for i in range(STEPS)]
    out = {"jcfg": jcfg, "tcfg": tcfg, "params": params, "batches": batches}
    for mb in (1, 2):
        opt = jadamw(lr=jwarmup(PEAK, WARMUP, STEPS))
        step = jax.jit(JTR.make_train_step(
            lambda p, b: JT.lm_loss(p, jcfg, b[0], b[1]), opt,
            microbatches=mb))
        st = JTR.init_train_state(params, opt)
        states, metrics = [st], []
        for a, b in batches:
            st, m = step(st, (jnp.asarray(a), jnp.asarray(b)))
            states.append(st)
            metrics.append({k: float(v) for k, v in m.items()})
        out[mb] = (step, states, metrics)
    return out


def port_step(tcfg, mb=1):
    opt = adamw(lr=warmup_cosine(PEAK, WARMUP, STEPS))
    return opt, TTR.make_train_step(
        lambda p, b: TT.lm_loss(p, tcfg, b[0], b[1]), opt, microbatches=mb)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_steps_match_reference(reference_run, mb):
    ref = reference_run
    jstep, jstates, jmetrics = ref[mb]
    opt, step = port_step(ref["tcfg"], mb)
    st = TTR.init_train_state(
        {k: _t(v) for k, v in _flat_np(ref["params"]).items()}, opt)
    for i, (a, b) in enumerate(ref["batches"]):
        st, m = step(st, (_t(a), _t(b)))
        assert int(m["step"]) == jmetrics[i]["step"] == i + 1
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - jmetrics[i][key]) <= STEP_TOL, \
                (i, key, float(m[key]), jmetrics[i][key])
        assert_params_close(jstates[i + 1].params, st.params, i + 1)
    assert int(st.opt_state.count) == STEPS


def test_first_step_grads_match_reference(reference_run):
    ref = reference_run
    a, b = ref["batches"][0]
    jg = _flat_np(jax.grad(lambda p: JT.lm_loss(
        p, ref["jcfg"], jnp.asarray(a), jnp.asarray(b)))(ref["params"]))
    _, tg = TTR._value_and_grad(
        lambda p, bb: TT.lm_loss(p, ref["tcfg"], bb[0], bb[1]),
        {k: _t(v) for k, v in _flat_np(ref["params"]).items()},
        (_t(a), _t(b)))
    for k, g in tg.items():
        np.testing.assert_allclose(g.numpy(), jg[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def _equal_trees(a, b):
    fa, fb = TC.flatten(a), TC.flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and \
            fa[k].tobytes() == fb[k].tobytes(), k


def _next_steps(ref, jst, tst, t0, n=2):
    jstep = ref[1][0]
    _, step = port_step(ref["tcfg"])
    for i in range(t0, t0 + n):
        a, b = ref["batches"][i]
        jst, jm = jstep(jst, (jnp.asarray(a), jnp.asarray(b)))
        tst, tm = step(tst, (_t(a), _t(b)))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= STEP_TOL
        assert_params_close(jst.params, tst.params, i + 1)


def test_jax_train_checkpoint_restores_in_port(reference_run, tmp_path):
    ref = reference_run
    jst = ref[1][1][3]
    JC.save(str(tmp_path), 3, jst)
    opt, _ = port_step(ref["tcfg"])
    target = TTR.init_train_state(
        {k: torch.zeros(v.shape) for k, v in _flat_np(ref["params"]).items()},
        opt)
    tst = TC.restore(str(tmp_path), target)
    assert int(tst.step) == 3 and tst.step.dtype == torch.int32
    want = {k: np.asarray(v) for k, v in JC._flatten(jst).items()}
    got = TC.flatten(tst)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _next_steps(ref, jst, tst, 3)


def test_port_train_checkpoint_restores_in_jax(reference_run, tmp_path):
    ref = reference_run
    opt, step = port_step(ref["tcfg"])
    tst = TTR.init_train_state(
        {k: _t(v) for k, v in _flat_np(ref["params"]).items()}, opt)
    for a, b in ref["batches"][:3]:
        tst, _ = step(tst, (_t(a), _t(b)))
    TC.save(str(tmp_path), 3, tst)
    jst = JC.restore(str(tmp_path), ref[1][1][0])
    got = {k: np.asarray(v) for k, v in JC._flatten(jst).items()}
    want = TC.flatten(tst)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _next_steps(ref, jst, tst, 3)


def test_run_with_failures_equals_uninterrupted_run(reference_run,
                                                    tmp_path):
    ref = reference_run
    opt, step = port_step(ref["tcfg"])
    init = TTR.init_train_state(
        {k: _t(v) for k, v in _flat_np(ref["params"]).items()}, opt)
    batches = [(_t(a), _t(b)) for a, b in ref["batches"]]
    plain = init
    for bt in batches:
        plain, _ = step(plain, bt)
    replayed = TF.run_with_failures(
        step, init, batches, ckpt_dir=str(tmp_path / "a"), ckpt_every=2,
        plan=TF.FailurePlan(fail_at=(3, 7)))
    assert int(replayed.step) == STEPS
    _equal_trees(plain, replayed)
    assert TC.all_steps(str(tmp_path / "a"))[-1] == STEPS
