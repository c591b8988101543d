"""The OPIC slice of the port against the JAX package, piece by piece: the
``opic_update``, ``select_harvest`` and ``dedup_deposit`` plain versions
(the JAX side run as ``ref`` and as ``interpret``; ``dedup_deposit`` also
packed, against ``interpret_packed``), the valued frontier
operations, and the ``opic``/``opic_url`` update stages and scores. Inputs
are made with numpy from a seed and handed to both packages.

Tolerances: integer and boolean results must be identical, and so must
every f32 result whose order of additions the port reproduces (scatter-adds
in item order, elementwise arithmetic). Row sums are the exception: XLA's
CPU reduction adds in an order of its own, so a row sum (the dedup
refund, the opic_url row mean) is held to 4 ulp, and to exact equality on
dyadic values, where every order gives the same bits. The CUDA kernels are
held against these plain versions in tests/test_torch_cuda.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import webparf as jweb  # noqa: E402
from repro.core import frontier as JF  # noqa: E402
from repro.core import stages as JST  # noqa: E402
from repro.kernels.bloom.ops import probe_insert as jax_probe  # noqa: E402
from repro.kernels.dedup_deposit.ops import dedup_deposit as jax_dd  # noqa: E402
from repro.kernels.frontier_select.ops import \
    select_harvest as jax_harvest  # noqa: E402
from repro.kernels.opic_update.ops import scatter_cash as jax_sc  # noqa: E402
from repro.kernels.opic_update.ops import \
    scatter_cash_cells as jax_scc  # noqa: E402
from repro.ordering import policies as JORD  # noqa: E402
from repro_torch.configs.base import CrawlConfig  # noqa: E402
from repro_torch.core import frontier as TF  # noqa: E402
from repro_torch.core import stages as TST  # noqa: E402
from repro_torch.kernels.bloom.ref import pack_bits  # noqa: E402
from repro_torch.kernels.dedup_deposit.ops import (  # noqa: E402
    dedup_deposit, dedup_deposit_packed)
from repro_torch.kernels.frontier_select.ops import select_harvest  # noqa: E402
from repro_torch.kernels.frontier_select.ref import NEG  # noqa: E402
from repro_torch.kernels.opic_update.ops import (  # noqa: E402
    scatter_cash, scatter_cash_cells)
from repro_torch.kernels.rowsum import row_sum, tree_sum  # noqa: E402
from repro_torch.ordering import policies as TORD  # noqa: E402

IMPLS = ["ref", "interpret"]
MAX_ULP = 4          # XLA's row-sum order against the port's tree


def T(a):
    """numpy -> torch, URLs (uint32) widened to int64 as the port keeps
    them."""
    a = np.asarray(a)
    return torch.tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


def port_cfg(jcfg):
    return CrawlConfig(**{**dataclasses.asdict(jcfg), "kernel_impl": "auto"})


# ---------------------------------------------------------------------------
# the fixed-order row sum
# ---------------------------------------------------------------------------

def test_row_sum_order():
    rng = np.random.default_rng(0)
    x = (rng.random((3, 700)) * 10.0 ** rng.integers(-8, 4, (3, 700))
         ).astype(np.float32)

    def tree(v):                        # the halving tree, written out
        v = list(v) + [np.float32(0)] * ((1 << (len(v) - 1).bit_length())
                                         - len(v))
        while len(v) > 1:
            h = len(v) // 2
            v = [np.float32(a + b) for a, b in zip(v[:h], v[h:])]
        return v[0]
    for r in range(3):
        want = np.float32(0)
        for t0 in range(0, 700, 256):
            want = np.float32(want + tree(x[r, t0:t0 + 256]))
        assert row_sum(torch.tensor(x))[r].item() == want
        assert tree_sum(torch.tensor(x[r, :100])).item() == tree(x[r, :100])
    assert row_sum(torch.zeros((2, 0))).tolist() == [0.0, 0.0]


# ---------------------------------------------------------------------------
# opic_update: scatter_cash and scatter_cash_cells
# ---------------------------------------------------------------------------

def cash_inputs(B, R, N, *, seed):
    """Contributions of mixed magnitude onto few targets (many duplicates),
    rows that wrap (-R..-1), rows out of range, and a fully masked row."""
    rng = np.random.default_rng(seed)
    cash = rng.random((B, R)).astype(np.float32)
    rows = rng.integers(-R - 2, R + 2, (B, N)).astype(np.int32)
    contrib = (rng.random((B, N)) * 10.0 ** rng.integers(-6, 3, (B, N))
               ).astype(np.float32)
    mask = rng.random((B, N)) < 0.8
    if B > 1:
        mask[-1] = False
    return cash, rows, contrib, mask


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("B,R,N,tile", [(1, 8, 1000, 256), (3, 5, 300, 64),
                                        (2, 64, 77, 256), (4, 3, 40, 16)])
def test_scatter_cash_matches_jax(B, R, N, tile, impl):
    cash, rows, contrib, mask = cash_inputs(B, R, N, seed=B * R + N)
    want = np.asarray(jax_sc(jnp.asarray(cash), jnp.asarray(rows),
                             jnp.asarray(contrib), jnp.asarray(mask),
                             impl=impl, tile=tile))
    c = T(cash)
    out = scatter_cash(c, T(rows).to(torch.int64), T(contrib), T(mask),
                       tile=tile)
    assert out is c                                  # in place
    np.testing.assert_array_equal(want, c.numpy())
    if B > 1:
        np.testing.assert_array_equal(c.numpy()[-1], cash[-1])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("B,R,N,tile,jtile", [(1, 8, 500, 256, 64),
                                              (3, 5, 300, 16, 128),
                                              (2, 64, 77, 1024, 32)])
def test_scatter_cash_ignores_the_tile(B, R, N, tile, jtile, impl):
    """The port with one tile equals JAX with another: each target's items
    add in item order whatever the tile, which the kernel relies on (it
    sorts the items by target and ignores the tile)."""
    cash, rows, contrib, mask = cash_inputs(B, R, N, seed=B + R + N)
    want = np.asarray(jax_sc(jnp.asarray(cash), jnp.asarray(rows),
                             jnp.asarray(contrib), jnp.asarray(mask),
                             impl=impl, tile=jtile))
    c = T(cash)
    scatter_cash(c, T(rows).to(torch.int64), T(contrib), T(mask), tile=tile)
    np.testing.assert_array_equal(want, c.numpy())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("skew", ["half", "one"])
def test_scatter_cash_skewed_matches_jax(skew, impl):
    """One target takes more than half the items ("half": 3 of every 5,
    some through the wrap at -R), or every item ("one"): the longest
    per-target chains, in item order."""
    B, R, N, tile = 2, 16, 400, 64
    cash, rows, contrib, mask = cash_inputs(B, R, N, seed=N + len(skew))
    if skew == "half":
        rows[:, np.arange(N) % 5 < 3] = 7
        rows[:, ::10] = 7 - R
    else:
        rows[:] = R - 1
    want = np.asarray(jax_sc(jnp.asarray(cash), jnp.asarray(rows),
                             jnp.asarray(contrib), jnp.asarray(mask),
                             impl=impl, tile=tile))
    c = T(cash)
    scatter_cash(c, T(rows).to(torch.int64), T(contrib), T(mask), tile=tile)
    np.testing.assert_array_equal(want, c.numpy())
    assert not np.array_equal(c.numpy(), cash)


@pytest.mark.parametrize("impl", IMPLS)
def test_scatter_cash_cells_matches_jax(impl):
    rng = np.random.default_rng(1)
    R, C = 5, 16
    table = rng.random((R, C)).astype(np.float32)
    # the general form: items of any shape, cells anywhere, duplicates
    r = rng.integers(-1, R + 1, (7, 9))
    c = rng.integers(-1, C + 1, (7, 9))
    v = rng.random((7, 9)).astype(np.float32)
    m = rng.random((7, 9)) < 0.7
    r[0, :4], c[0, :4] = 2, 3                        # one cell hit 4 times
    want = np.asarray(jax_scc(jnp.asarray(table), jnp.asarray(r),
                              jnp.asarray(c), jnp.asarray(v),
                              jnp.asarray(m), impl=impl, tile=16))
    got = T(table)
    scatter_cash_cells(got, T(r), T(c), T(v), T(m), tile=16)
    np.testing.assert_array_equal(want, got.numpy())
    # the row-aligned form (rows=None) on a strided view of a wider array,
    # as the stages pass the url lane order_state[:, 2:]
    c = rng.integers(-1, C + 1, (R, 40))
    c[:, :3] = 7                                      # duplicate cells
    v = rng.random((R, 40)).astype(np.float32)
    m = rng.random((R, 40)) < 0.7
    rows = np.broadcast_to(np.arange(R)[:, None], (R, 40))
    want = np.asarray(jax_scc(jnp.asarray(table), jnp.asarray(rows),
                              jnp.asarray(c), jnp.asarray(v),
                              jnp.asarray(m), impl=impl, tile=16))
    wide = torch.zeros((R, 2 + C))
    wide[:, 2:] = T(table)
    scatter_cash_cells(wide[:, 2:], None, T(c), T(v), T(m), tile=16)
    np.testing.assert_array_equal(want, wide[:, 2:].numpy())
    assert not wide[:, :2].any()


# ---------------------------------------------------------------------------
# select_harvest
# ---------------------------------------------------------------------------

def harvest_inputs(R, C, *, fill, seed):
    """Crawl-like rows: invalid cells hold NEG and exactly 0.0 cash,
    priorities distinct per row."""
    rng = np.random.default_rng(seed)
    url = rng.integers(1, 1 << 24, (R, C)).astype(np.uint32)
    valid = rng.random((R, C)) < fill
    pri = np.where(valid, rng.permutation(R * C).reshape(R, C),
                   NEG).astype(np.float32)
    table = (rng.random((R, C)) * valid).astype(np.float32)
    return url, pri, valid, table


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("fill", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("R,C,k", [(4, 64, 4), (2, 128, 8), (3, 32, 1)])
def test_select_harvest_matches_jax(R, C, k, fill, impl):
    url, pri, valid, table = harvest_inputs(R, C, fill=fill,
                                            seed=R * C + k)
    ju, jp, jm, jpri, jval, jidx, jcash, jtab = (np.asarray(a) for a in
                                                 jax_harvest(
        jnp.asarray(url), jnp.asarray(pri), jnp.asarray(valid),
        jnp.asarray(table), k=k, impl=impl))
    p, v, t = T(pri), T(valid), T(table)
    tu, tp, tm, tidx, tcash = select_harvest(T(url), p, v, t, k=k)
    np.testing.assert_array_equal(jm, tm.numpy())
    # masked lanes are unspecified by contract: compare the popped ones
    np.testing.assert_array_equal(np.where(jm, ju, 0), tu.numpy())
    np.testing.assert_array_equal(np.where(jm, jp, 0),
                                  np.where(jm, tp.numpy(), 0))
    np.testing.assert_array_equal(np.where(jm, jidx, -1),
                                  np.where(jm, tidx.numpy(), -1))
    for name, a, b in (("cash", jcash, tcash), ("pri'", jpri, p),
                       ("valid'", jval, v), ("table'", jtab, t)):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


# ---------------------------------------------------------------------------
# dedup_deposit
# ---------------------------------------------------------------------------

def dedup_inputs(R, M, C, b, *, seed, dyadic=False, queue_fill=0.7):
    """About half the arrivals were inserted before: half of those are
    still queued in their row (twin deposits), half are gone (refunds);
    a URL may repeat within and across tiles."""
    rng = np.random.default_rng(seed)
    f_url = rng.integers(1, 1 << 20, (R, C)).astype(np.uint32)
    f_valid = rng.random((R, C)) < queue_fill
    if C > 2:
        f_url[:, 1] = f_url[:, 2]                    # a URL queued twice
    gone = rng.integers(1 << 20, 1 << 21, (R, M)).astype(np.uint32)
    fresh = rng.integers(1 << 21, 1 << 22, (R, M)).astype(np.uint32)
    pick = rng.random((R, M))
    queued = np.take_along_axis(f_url, rng.integers(0, C, (R, M)), axis=1)
    urls = np.where(pick < 0.25, queued, np.where(pick < 0.5, gone, fresh))
    mask = rng.random((R, M)) < 0.8
    val = (rng.integers(1, 64, (R, M)) / 8.0 if dyadic
           else rng.random((R, M))).astype(np.float32)
    table = (rng.random((R, C)) * f_valid).astype(np.float32)
    bits = jnp.zeros((R, 1 << b), jnp.uint8)
    _, bits = jax_probe(bits, jnp.asarray(f_url), jnp.asarray(f_valid), k=3,
                        impl="ref")
    _, bits = jax_probe(bits, jnp.asarray(gone), jnp.ones((R, M), bool), k=3,
                        impl="ref")
    return np.asarray(bits), urls, mask, val, f_url, f_valid, table


@pytest.mark.parametrize("impl", IMPLS + ["interpret_packed"])
@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("R,M,C,b,tile", [(1, 64, 32, 10, 32),
                                          (4, 96, 64, 12, 32),
                                          (3, 300, 50, 10, 128)])
def test_dedup_deposit_matches_jax(R, M, C, b, tile, dyadic, impl):
    """``interpret_packed`` is JAX's packed entry (pack, the packed kernel,
    unpack); the port runs ``dedup_deposit(..., packed=True)`` against it,
    and ``dedup_deposit_packed`` on the packed filter, which must leave
    the words JAX's unpacked bits pack to."""
    args = dedup_inputs(R, M, C, b, seed=R * M + C, dyadic=dyadic)
    seen, bits, table, refund = (np.asarray(a) for a in jax_dd(
        *(jnp.asarray(a) for a in args), k=3, impl=impl, url_tile=tile))
    packed = impl == "interpret_packed"
    tb, tt = T(args[0]), T(args[6])
    tseen, trefund = dedup_deposit(tb, *(T(a) for a in args[1:6]), tt, k=3,
                                   url_tile=tile, packed=packed)
    np.testing.assert_array_equal(seen, tseen.numpy())
    np.testing.assert_array_equal(bits, tb.numpy())
    np.testing.assert_array_equal(table, tt.numpy())
    assert seen.sum() > 0 and (table != args[6]).any()    # twins were hit
    if dyadic:
        np.testing.assert_array_equal(refund, trefund.numpy())
    else:
        np.testing.assert_array_max_ulp(refund, trefund.numpy(),
                                        maxulp=MAX_ULP)
    if packed:
        tw, tt2 = pack_bits(T(args[0])), T(args[6])
        s2, r2 = dedup_deposit_packed(tw, *(T(a) for a in args[1:6]), tt2,
                                      k=3, url_tile=tile)
        assert torch.equal(s2, tseen) and torch.equal(r2, trefund)
        assert torch.equal(tt2, tt) and torch.equal(tw, pack_bits(tb))


@pytest.mark.parametrize("R,M,C,b,tile", [(1, 64, 32, 10, 32),
                                          (4, 96, 64, 12, 32),
                                          (3, 300, 50, 10, 128),
                                          (2, 200, 40, 5, 64),
                                          (3, 130, 24, 6, 256)])
def test_dedup_deposit_packed_matches_bytewise(R, M, C, b, tile):
    """Inside the port, the packed walk equals the byte-per-bit walk bit for
    bit, on rows of one and two words too (every URL collides)."""
    args = dedup_inputs(R, M, C, b, seed=R + M + C)
    rest = [T(a) for a in args[1:6]]
    tb, t1 = T(args[0]), T(args[6])
    tw, t2 = pack_bits(tb), T(args[6])
    s1, r1 = dedup_deposit(tb, *rest, t1, k=3, url_tile=tile)
    s2, r2 = dedup_deposit_packed(tw, *rest, t2, k=3, url_tile=tile)
    assert torch.equal(s1, s2) and torch.equal(r1, r2)
    assert torch.equal(t1, t2) and torch.equal(pack_bits(tb), tw)
    assert bool(s1.any()) and bool((r1 > 0).any())


# ---------------------------------------------------------------------------
# the valued frontier operations
# ---------------------------------------------------------------------------

def frontier_pair(R, C, *, seed, fill=0.7):
    """The same frontier rows in both packages, arrivals below 2^20."""
    rng = np.random.default_rng(seed)
    url = rng.integers(1, 1 << 24, (R, C)).astype(np.uint32)
    valid = rng.random((R, C)) < fill
    arr = rng.permutation(R * C).reshape(R, C) % 5000
    bucket = rng.integers(0, 8, (R, C))
    pri = np.where(valid, bucket * float(1 << 20) - arr,
                   NEG).astype(np.float32)
    url = np.where(valid, url, 0).astype(np.uint32)
    arrival = np.full((R,), 5000, np.int32)
    z = np.zeros((R,), np.int32)
    table = (rng.random((R, C)) * valid).astype(np.float32)
    jf = JF.Frontier(*(jnp.asarray(a) for a in (url, pri, valid, arrival,
                                                z, z, z)))
    tf = TF.Frontier(*(T(a) for a in (url, pri, valid, arrival, z, z, z)))
    return jf, tf, table


def assert_frontiers_equal(jf, tf):
    for name, a, b in zip(JF.Frontier._fields, jf, tf):
        b = b.numpy()
        a = np.asarray(a).astype(b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("placeholder", [False, True])
def test_insert_valued_and_place_valued_match_jax(placeholder):
    R, C, M = 4, 32, 40              # more items than free cells: drops
    rng = np.random.default_rng(7)
    jf, tf, table = frontier_pair(R, C, seed=3)
    urls = rng.integers(1, 1 << 24, (R, M)).astype(np.uint32)
    scores = rng.random((R, M)).astype(np.float32)
    mask = rng.random((R, M)) < 0.8
    vals = (rng.integers(0, 64, (R, M)) / 16.0).astype(np.float32) * mask
    if placeholder:
        jf2, jtab, jref = JF.place_valued(
            jf, jnp.asarray(table), jnp.asarray(urls), jnp.asarray(mask),
            jnp.asarray(vals))
        tf2, ttab, tref = TF.place_valued(tf, T(table), T(urls), T(mask),
                                          T(vals))
    else:
        jf2, jtab, jref = JF.insert_valued(
            jf, jnp.asarray(table), jnp.asarray(urls), jnp.asarray(scores),
            jnp.asarray(mask), jnp.asarray(vals), n_buckets=8)
        tf2, ttab, tref = TF.insert_valued(tf, T(table), T(urls), T(scores),
                                           T(mask), T(vals), n_buckets=8)
    assert_frontiers_equal(jf2, tf2)
    np.testing.assert_array_equal(np.asarray(jtab), ttab.numpy())
    np.testing.assert_array_equal(np.asarray(jref), tref.numpy())
    assert (tref.numpy() > 0).any()                 # overflow refunded


def test_rescore_matches_jax():
    R, C = 4, 32
    jf, tf, _ = frontier_pair(R, C, seed=5)
    scores = np.random.default_rng(6).random((R, C)).astype(np.float32)
    jf2 = JF.rescore(jf, jnp.asarray(scores), n_buckets=8)
    assert_frontiers_equal(jf2, TF.rescore(tf, T(scores), n_buckets=8))


# ---------------------------------------------------------------------------
# the opic and opic_url orderings: update stages and scores
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def states():
    """A JAX opic_url init state with random slot cash, history and url
    lane (0 on invalid cells), and the port's copy of it."""
    jcfg = dataclasses.replace(jweb.reduced(), ordering="opic_url",
                               kernel_impl="ref")
    js = JST.init_state(jcfg, 1)
    rng = np.random.default_rng(11)
    os_ = rng.random(np.asarray(js.order_state).shape).astype(np.float32)
    os_[:, 2:] *= np.asarray(js.f_valid)
    js = js._replace(order_state=jnp.asarray(os_))
    leaves = {n: np.asarray(a) for n, a in zip(JST.CrawlState._fields, js)}
    return jcfg, js, leaves


def make_ctxs(jcfg, ordering, impl="ref"):
    jc = dataclasses.replace(jcfg, ordering=ordering, kernel_impl=impl)
    jctx = JST.make_context(jc, n_shards=1, axes=(), classify_accuracy=0.9)
    tctx = TST.make_context(port_cfg(jc), n_shards=1, device="cpu",
                            classify_accuracy=0.9)
    return jc, jctx, tctx


def carries(js, leaves, k, O, *, seed):
    """The same allocate carry in both packages: popped URLs, a fetch mask
    and harvested cash."""
    rng = np.random.default_rng(seed)
    r = leaves["f_url"].shape[0]
    urls = leaves["f_url"][:, :k]
    sel = rng.random((r, k)) < 0.7
    cash = (rng.random((r, k)) * sel).astype(np.float32)
    dom = np.zeros((r, k), np.int32)     # the update stages do not read it
    jcar = JST.StepCarry(shard=jnp.int32(0), alive=jnp.bool_(True),
                         urls=jnp.asarray(urls), sel=jnp.asarray(sel),
                         true_dom=jnp.asarray(dom),
                         link_cash=jnp.zeros((r, k, O), jnp.float32),
                         url_cash=jnp.asarray(cash))
    tcar = TST.StepCarry(shard=0, alive=torch.tensor(True), urls=T(urls),
                         sel=T(sel), true_dom=T(dom).to(torch.int64),
                         link_cash=torch.zeros((r, k, O)), url_cash=T(cash))
    return jcar, tcar


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("ordering", ["opic", "opic_url"])
def test_update_stage_matches_jax(states, ordering, impl):
    jcfg0, js, leaves = states
    jcfg, jctx, tctx = make_ctxs(jcfg0, ordering, impl)
    if ordering == "opic":                 # a slot-level (r, 2) state
        js = js._replace(order_state=js.order_state[:, :2])
        leaves = {**leaves, "order_state": leaves["order_state"][:, :2]}
    ts = TST.state_from_numpy(leaves, "cpu")
    jcar, tcar = carries(js, leaves, 2, jcfg.outlinks_per_page, seed=12)
    upd_j = JORD.get_ordering(ordering).update_stage
    upd_t = TORD.get_ordering(ordering).update_stage
    js2, jcar2, _ = upd_j(jctx, js, jcar)
    ts2, tcar2, _ = upd_t(tctx, ts, tcar)
    np.testing.assert_array_equal(np.asarray(js2.order_state),
                                  ts2.order_state.numpy())
    np.testing.assert_array_equal(np.asarray(jcar2.link_cash),
                                  tcar2.link_cash.numpy())
    np.testing.assert_array_equal(np.asarray(jcar2.links),
                                  tcar2.links.numpy())
    if ordering == "opic_url":
        assert not tcar2.url_cash.any() and tcar2.link_cash.any()
    else:                       # one shard: every target is local
        assert not tcar2.link_cash.any()
        assert (ts2.order_state[:, 1].numpy() > leaves["order_state"][:, 1]
                ).any()


@pytest.mark.parametrize("ordering", ["opic", "opic_url"])
def test_scores_match_jax(states, ordering):
    jcfg0, js, leaves = states
    jcfg, jctx, tctx = make_ctxs(jcfg0, ordering)
    ts = TST.state_from_numpy(leaves, "cpu")
    u = leaves["f_url"]
    a = np.asarray(jctx.score_fn(jnp.asarray(u), jcfg, js))
    b = tctx.score_fn(T(u), tctx.cfg, ts).numpy()
    np.testing.assert_array_equal(a, b)
    if ordering == "opic_url":
        # the row mean of the cash is a row sum: XLA's order against the
        # port's tree, so a few ulp; equal buckets on these inputs
        val = leaves["order_state"][:, 2:]
        a = np.asarray(jctx.score_fn(jnp.asarray(u), jcfg, js,
                                     val=jnp.asarray(val)))
        b = tctx.score_fn(T(u), tctx.cfg, ts, val=T(val)).numpy()
        np.testing.assert_array_max_ulp(a, b, maxulp=MAX_ULP)
        nb = jcfg.n_priority_buckets
        np.testing.assert_array_equal((a * nb).astype(np.int32),
                                      (b * nb).astype(np.int32))
    assert TORD.ORD_URL0 == JORD.ORD_URL0


def test_value_lane_round_trips_bit_exact():
    """The dispatch payload carries each f32 value as its bits in an int64
    lane (negative, zero, subnormal, huge and NaN values included), through
    the per-row bucketing, and back, bit for bit as JAX's bitcast does."""
    from repro.core import router as JRT
    from repro_torch.core import router as TRT
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.standard_normal(40).astype(np.float32),
                        np.array([0.0, -0.0, 1e-45, -3e38, 3e38, np.nan],
                                 np.float32)])
    u = rng.integers(0, 1 << 32, v.shape[0]).astype(np.uint32)
    dest = rng.integers(0, 4, v.shape[0]).astype(np.int32)
    jb, _, _, jk = JRT.pack_buckets(
        jnp.stack([jnp.asarray(u), jax.lax.bitcast_convert_type(
            jnp.asarray(v), jnp.uint32)], axis=-1),
        jnp.asarray(dest), 4, 16, return_keep=True)
    tb, _, _, tk = TRT.pack_buckets(
        torch.stack([T(u), TST._f32_bits(T(v))], dim=-1), T(dest), 4, 16,
        return_keep=True)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jb[..., 0]), tb[..., 0].numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.lax.bitcast_convert_type(jb[..., 1], jnp.float32)
                   ).view(np.uint32),
        TST._from_bits(tb[..., 1]).numpy().view(np.uint32))
