"""The port's GAT and fanout sampler against the JAX reference, on the CPU.

The same numpy inputs (seeded graphs; JAX's ``init_gat`` weights carried
across in the reference's checkpoint form) go through ``repro.models.gnn``
and ``repro_torch.models.gnn``; the reduced ``gat-cora`` config (2 layers,
4 hidden x 2 heads), f32.

Tolerances, with the measured maxima on these seeds:
- forward logits and losses within 1e-5 (measured <= 1.8e-7); every
  gradient leaf within 1e-6 (measured <= 4.5e-8, gradients up to 0.19):
  the port adds each node's edges in edge order, XLA's CPU scatter in its
  own, and the port drops the softmax shift's gradient, which cancels in
  exact arithmetic (a residue of a few ulps in JAX).
- 4 AdamW steps (lr 5e-3, the reference's GNN cell): each step's loss and
  grad norm within 1e-5, the parameters within 2 * sum(lr) (an entry whose
  gradient is ~0 may take Adam's step the other way), their mean
  difference within 1e-6.
- ``synthetic_csr`` and ``sample_fanout``: equal bit for bit.
- a checkpoint restored across the packages equals the saver's state bit
  for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget  # noqa: E402
from repro.data import sampler as JS  # noqa: E402
from repro.models import gnn as JG  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import checkpoint as JC  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.configs import get_reduced as tget  # noqa: E402
from repro_torch.data import sampler as TS  # noqa: E402
from repro_torch.models import gnn as TG  # noqa: E402
from repro_torch.models import segment as SEG  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402

ARCH = "gat-cora"
F, C = 8, 3
FWD_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-6, 1e-5
LR, STEPS = 5e-3, 4


def graph_np(seed, N=40, E=160, F=F, C=C, batch=None, live=0.8):
    """A seeded graph: a share ``live`` of the edges unmasked, half the
    nodes labelled; with ``batch``, a leading batch axis."""
    rng = np.random.default_rng(seed)
    shp = (batch,) if batch else ()
    return (rng.normal(size=shp + (N, F)).astype(np.float32),
            rng.integers(0, N, shp + (E,)).astype(np.int32),
            rng.integers(0, N, shp + (E,)).astype(np.int32),
            rng.random(shp + (E,)) < live,
            rng.integers(0, C, shp + (N,)).astype(np.int32),
            rng.random(shp + (N,)) < 0.5)


def graphs(arrays):
    return (JG.Graph(*map(jnp.asarray, arrays)),
            TG.Graph(*map(torch.from_numpy, arrays)))


def flat_np(tree):
    return {k: np.asarray(v) for k, v in JC._flatten(tree).items()}


def carried(seed=0, d_feat=F, n_classes=C):
    jp = JG.init_gat(jax.random.PRNGKey(seed), jget(ARCH), d_feat, n_classes)
    return jp, TG.params_from_numpy(tget(ARCH), d_feat, n_classes,
                                    flat_np(jp), device="cpu")


def jax_loss_grad(loss):
    """The reference's loss and gradients, jitted (JAX's eager dispatch
    compiles every op on its own)."""
    return jax.jit(jax.value_and_grad(lambda p, g: loss(p, jget(ARCH), g)))


def value_and_grad(loss, params, batch):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    value = loss(leaves, batch)
    return value.detach(), dict(zip(leaves, torch.autograd.grad(
        value, list(leaves.values()))))


def assert_grads(jgrads, tgrads):
    jf = flat_np(jgrads)
    assert set(jf) == set(tgrads)
    for k, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jf[k], rtol=0, atol=GRAD_TOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the fixed-order substrate
# ---------------------------------------------------------------------------

def test_segment_sum_and_gather_match_numpy():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 9, 50)
    x = rng.normal(size=(50, 2, 3)).astype(np.float32)
    seg = SEG.Segments(torch.from_numpy(idx), 10)     # segment 9 is empty
    want = np.zeros((10, 2, 3), np.float32)
    np.add.at(want, idx, x)
    tx = torch.from_numpy(x).requires_grad_()
    got = SEG.segment_sum(tx, seg)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    w = torch.from_numpy(rng.normal(size=(10, 2, 3)).astype(np.float32))
    g, = torch.autograd.grad((got * w).sum(), tx)
    np.testing.assert_array_equal(g.numpy(), w.numpy()[idx])
    table = torch.from_numpy(rng.normal(size=(10, 4)).astype(np.float32))
    table.requires_grad_()
    rows = SEG.gather(table, seg)
    np.testing.assert_array_equal(rows.detach().numpy(),
                                  table.detach().numpy()[idx])
    up = rng.normal(size=(50, 4)).astype(np.float32)
    g, = torch.autograd.grad((rows * torch.from_numpy(up)).sum(), table)
    want = np.zeros((10, 4), np.float32)
    np.add.at(want, idx, up)
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-6)
    mx = SEG.segment_max(torch.from_numpy(x), seg).numpy()
    assert np.isneginf(mx[9]).all()
    for s in range(9):
        np.testing.assert_array_equal(mx[s], x[idx == s].max(0))


# ---------------------------------------------------------------------------
# GAT against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("concat", [True, False])
def test_gat_layer_matches_reference(concat):
    jp, tp = carried()
    feat, src, dst, mask, _, _ = graph_np(1)
    kw = dict(negative_slope=0.2, concat_heads=concat)
    want = jax.jit(lambda p, *a: JG.gat_layer(p, *a, 40, **kw))(
        jp["layers"][0], *map(jnp.asarray, (feat, src, dst, mask)))
    got = TG.gat_layer(TG._layer(tp, 0), torch.from_numpy(feat),
                       torch.from_numpy(src), torch.from_numpy(dst),
                       torch.from_numpy(mask), 40, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_TOL)


@pytest.mark.parametrize("seed,N,E,live", [(2, 40, 160, 0.8),
                                           (3, 64, 96, 0.5),
                                           (4, 30, 300, 1.0)])
def test_gat_loss_and_grads_match_reference(seed, N, E, live):
    """Masked edges, nodes with no live incoming edge (N 64, E 96 at half
    live) and dense neighbourhoods (E 300 on 30 nodes)."""
    jp, tp = carried(seed)
    jgr, tgr = graphs(graph_np(seed, N=N, E=E, live=live))
    cfg_j, cfg_t = jget(ARCH), tget(ARCH)
    np.testing.assert_allclose(
        TG.gat_forward(tp, cfg_t, tgr).numpy(),
        np.asarray(jax.jit(lambda p, g: JG.gat_forward(p, cfg_j, g))(jp, jgr)),
        rtol=0, atol=FWD_TOL)
    jl, jg = jax_loss_grad(JG.gat_loss)(jp, jgr)
    tl, tg = value_and_grad(lambda p, b: TG.gat_loss(p, cfg_t, b), tp, tgr)
    assert abs(float(tl) - float(jl)) <= FWD_TOL
    assert_grads(jg, tg)


def test_gat_batched_loss_and_grads_match_reference():
    """The vmapped molecule regime against one flattened graph of 6."""
    jp, tp = carried(5)
    jgr, tgr = graphs(graph_np(6, N=10, E=24, batch=6, live=0.9))
    cfg_j, cfg_t = jget(ARCH), tget(ARCH)
    jl, jg = jax_loss_grad(JG.gat_batched_loss)(jp, jgr)
    tl, tg = value_and_grad(lambda p, b: TG.gat_batched_loss(p, cfg_t, b),
                            tp, tgr)
    assert abs(float(tl) - float(jl)) <= FWD_TOL
    assert_grads(jg, tg)


def test_gat_isolated_nodes_no_nan():
    """Every edge masked: no NaN, and the reference's values (each node's
    messages are zeros)."""
    jp, tp = carried()
    rng = np.random.default_rng(7)
    arrays = (rng.normal(size=(10, F)).astype(np.float32),
              np.zeros(4, np.int32), np.zeros(4, np.int32),
              np.zeros(4, bool), np.zeros(10, np.int32), np.ones(10, bool))
    jgr, tgr = graphs(arrays)
    got = TG.gat_forward(tp, tget(ARCH), tgr)
    assert not bool(torch.isnan(got).any())
    want = jax.jit(lambda p, g: JG.gat_forward(p, jget(ARCH), g))(jp, jgr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_TOL)
    _, tg = value_and_grad(lambda p, b: TG.gat_loss(p, tget(ARCH), b), tp,
                           tgr)
    assert all(bool(torch.isfinite(g).all()) for g in tg.values())


def test_gat_edge_softmax_normalized():
    """The attention weights over each node's live incoming edges sum to
    1 (the port's segment ops)."""
    _, tp = carried(1)
    feat, src, dst, mask, _, _ = map(torch.from_numpy, graph_np(8, N=20,
                                                                E=80))
    p = TG._layer(tp, 0)
    h = torch.einsum("nf,fhd->nhd", feat, p["w"])
    by_src, by_dst = TG.edge_segments(src, dst, 20)
    logits = torch.nn.functional.leaky_relu(
        SEG.gather((h * p["a_src"]).sum(-1), by_src)
        + SEG.gather((h * p["a_dst"]).sum(-1), by_dst), 0.2)
    logits = torch.where(mask[:, None], logits, torch.tensor(-1e30))
    ex = torch.exp(logits - SEG.segment_max(logits, by_dst)[dst.long()]) \
        * mask[:, None]
    alpha = ex / SEG.segment_sum(ex, by_dst)[dst.long()].clamp(min=1e-16)
    sums = SEG.segment_sum(alpha, by_dst).numpy()
    live = SEG.segment_sum(mask.float(), by_dst).numpy() > 0
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-5)
    assert (sums[~live] == 0).all()


# ---------------------------------------------------------------------------
# the sampler and the minibatch regime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,deg,seed,fanouts", [(5000, 10, 3, (4, 3)),
                                                (300, 4, 1, (15, 10)),
                                                (20000, 30, 7, (5,))])
def test_sampler_matches_reference_bit_for_bit(n, deg, seed, fanouts):
    jg, tg = JS.synthetic_csr(n, deg, seed=seed), TS.synthetic_csr(
        n, deg, seed=seed)
    assert jg.n_nodes == tg.n_nodes
    for a, b in zip(jg[:2], tg[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    seeds = np.random.default_rng(seed).choice(n, 64, replace=False)
    jb = JS.sample_fanout(jg, seeds, fanouts, rng=np.random.default_rng(9))
    tb = TS.sample_fanout(tg, seeds, fanouts, rng=np.random.default_rng(9))
    assert jb.n_valid_nodes == tb.n_valid_nodes
    for name in ("node_ids", "src", "dst", "edge_mask"):
        a, b = getattr(jb, name), getattr(tb, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert TS._block_max_nodes(1024, (15, 10)) == 169984
    assert TS._block_max_edges(1024, (15, 10)) == 168960


def test_gat_on_a_sampled_block_matches_reference():
    """The minibatch regime: a fanout block of a synthetic CSR graph, its
    nodes' seeded features, the seeds labelled; padded edges masked."""
    g = TS.synthetic_csr(3000, 12, seed=2)
    seeds = np.arange(0, 3000, 100)
    blk = TS.sample_fanout(g, seeds, (4, 3), rng=np.random.default_rng(4))
    rng = np.random.default_rng(5)
    table = rng.normal(size=(3000, F)).astype(np.float32)
    feat = table[np.maximum(blk.node_ids, 0)]
    arrays = (feat, blk.src, blk.dst, blk.edge_mask,
              rng.integers(0, C, len(blk.node_ids)).astype(np.int32),
              np.isin(blk.node_ids, seeds))
    jp, tp = carried(6)
    jgr, tgr = graphs(arrays)
    jl, jg = jax_loss_grad(JG.gat_loss)(jp, jgr)
    tl, tg = value_and_grad(lambda p, b: TG.gat_loss(p, tget(ARCH), b), tp,
                            tgr)
    assert abs(float(tl) - float(jl)) <= FWD_TOL
    assert_grads(jg, tg)


# ---------------------------------------------------------------------------
# init, training, checkpoints, the CLI
# ---------------------------------------------------------------------------

def test_init_and_params_mirror_reference():
    cfg = tget(ARCH)
    jp = flat_np(JG.init_gat(jax.random.PRNGKey(0), jget(ARCH), 1433, 7))
    tp = TG.init_gat(0, cfg, 1433, 7, device="cpu")
    assert {k: v.shape for k, v in jp.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    # the reference's scale: the first layer's 11,464 weights have the
    # spread of N(0, 1/1433)
    assert abs(float(tp["layers/0/w"].std()) * 1433 ** 0.5 - 1) < 0.05
    back = TG.params_to_numpy(TG.params_from_numpy(cfg, 1433, 7, jp,
                                                   device="cpu"))
    assert all(np.array_equal(back[k], jp[k]) for k in jp)
    with pytest.raises(KeyError, match="keys differ"):
        TG.params_from_numpy(cfg, 1433, 7, {}, device="cpu")
    with pytest.raises(ValueError, match="want"):
        TG.params_from_numpy(cfg, 1432, 7, jp, device="cpu")


@pytest.fixture(scope="module")
def reference_run():
    """JAX's STEPS AdamW steps on a seeded graph from JAX's weights: the
    states after each step and their metrics."""
    cfg = jget(ARCH)
    arrays = graph_np(11, N=48, E=200)
    jp, tp = carried(11)
    opt = jadamw(lr=LR)
    step = jax.jit(JTR.make_train_step(lambda p, b: JG.gat_loss(p, cfg, b),
                                       opt))
    jgr, tgr = graphs(arrays)
    st = JTR.init_train_state(jp, opt)
    states, metrics = [st], []
    for _ in range(STEPS):
        st, m = step(st, jgr)
        states.append(st)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(step=step, states=states, metrics=metrics, tp=tp, tgr=tgr,
                jgr=jgr)


def port_step():
    opt = adamw(lr=LR)
    return opt, TTR.make_train_step(
        lambda p, b: TG.gat_loss(p, tget(ARCH), b), opt)


def assert_params_close(jparams, tparams, t):
    jf = flat_np(jparams)
    d = np.concatenate([np.abs(jf[k] - v.numpy()).ravel()
                        for k, v in tparams.items()])
    assert d.max() <= 2 * LR * t, (t, d.max())
    assert d.mean() <= 1e-6, (t, d.mean())


def test_gat_train_steps_match_reference(reference_run):
    ref = reference_run
    opt, step = port_step()
    st = TTR.init_train_state(ref["tp"], opt)
    for i in range(STEPS):
        st, m = step(st, ref["tgr"])
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - ref["metrics"][i][key]) <= STEP_TOL
        assert_params_close(ref["states"][i + 1].params, st.params, i + 1)


def test_gat_checkpoint_round_trip_across_packages(reference_run, tmp_path):
    """JAX's state after 2 steps restores in the port bit for bit and
    trains on; the port's state after 2 steps restores in JAX."""
    ref = reference_run
    opt, step = port_step()
    JC.save(str(tmp_path / "j"), 2, ref["states"][2])
    target = TTR.init_train_state(ref["tp"], opt)
    tst = TC.restore(str(tmp_path / "j"), target)
    want = flat_np(ref["states"][2])
    got = TC.flatten(tst)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tst, m = step(tst, ref["tgr"])
    assert abs(float(m["loss"]) - ref["metrics"][2]["loss"]) <= STEP_TOL

    pst = TTR.init_train_state(ref["tp"], opt)
    for _ in range(2):
        pst, _ = step(pst, ref["tgr"])
    TC.save(str(tmp_path / "t"), 2, pst)
    jst = JC.restore(str(tmp_path / "t"), ref["states"][0])
    got = flat_np(jst)
    for k, v in TC.flatten(pst).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    jst, jm = ref["step"](jst, ref["jgr"])
    assert abs(float(jm["loss"]) - ref["metrics"][2]["loss"]) <= STEP_TOL


def test_train_cli_trains_gat_on_cpu(capsys):
    from repro_torch.launch import train as ttrain
    assert ttrain.main(["--arch", "gat-cora", "--device", "cpu", "--steps",
                        "6", "--log-every", "3"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "final loss" in out
