"""The port's scenario stages and ``core/freshness.py`` against the JAX
package: the freshness functions on drawn URLs, and crawls with the
politeness stage (both branches: the plain re-insert, and the url lane's
valued re-insert) and the revisit stage at ``webparf.reduced()``, with 1
and 4 shards, against one JAX subprocess (``_torch_play``).

Tolerances as in ``_torch_play``. ``revisit_score`` is held to 2^-23
absolute and its priority bucket exactly: XLA's CPU ``tanh`` and
PyTorch's differ by an ulp on some inputs (up to 2 ulp of a score near
0.65, 128 ulp of one near 0.004 after the cancellation in 0.15 + 0.5 *
tanh), which never moves a score across a bucket edge here (the frontier
keeps only the bucket).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_play import assert_case, play, run_jax  # noqa: E402
from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs import webparf  # noqa: E402
from repro_torch.configs.base import scaled  # noqa: E402
from repro_torch.core import freshness as TF  # noqa: E402
from repro_torch.core import stages as ST  # noqa: E402
from repro_torch.core.stages import SIDX  # noqa: E402

IV = webparf.reduced().dispatch_interval
OPIC_URL = {"ordering": "opic_url", "link_pop_bias": 1.0}
POLITE, REVISIT = ["politeness", 1], ["revisit", 32]

# 4 shards pop 2 URLs a row a step (k_row 2), so a budget of 1 a row
# defers; 1 shard pops one a row
CASES = {
    f"{stage[0]}-{o}-{n}": {"over": oo, "shards": n, "stages": [stage],
                            "ops": [["run", 3 * IV]]}
    for stage in (POLITE, REVISIT)
    for o, oo in (("backlink", {}), ("opic_url", OPIC_URL),
                  ("opic", {"ordering": "opic", "link_pop_bias": 1.0}))
    for n in (1, 4)
    if not (stage is REVISIT and o == "opic")
}
CASES["both-backlink-4"] = {"over": {}, "shards": 4,
                            "stages": [REVISIT, POLITE],
                            "ops": [["run", 3 * IV]]}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("jax_scenario"), CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_scenario_crawl_matches_jax(jax_ref, name):
    sess, rec = play(CASES[name])
    assert_case(jax_ref / f"{name}.npz", sess, rec, name)
    stats = rec["run0"].stats
    if name.startswith(("revisit", "both")):
        assert stats["revisit_enqueued"] == stats["fetched"] > 0
    if name.startswith(("politeness", "both")) and name.endswith("-4"):
        assert stats["politeness_deferred"] > 0


def test_politeness_caps_each_row_and_keeps_cash():
    """Under opic_url at 4 shards no row fetches more than its budget a
    step, the deferred URLs are queued again with their cash, and the
    cash stays conserved."""
    from repro_torch.ordering.opic import total_cash
    cfg = scaled(webparf.reduced(), **OPIC_URL)
    sess = CrawlSession(cfg, device="cpu", n_shards=4,
                        extra_stages=[ST.make_politeness_stage(1)])
    cash0 = total_cash(sess.state)
    for _ in range(3 * IV):
        rep = sess.step()
        assert (rep.fetched_mask.sum(1) <= 1).all()
    assert int(sess.state.stats[:, SIDX["politeness_deferred"]].sum()) > 0
    np.testing.assert_allclose(total_cash(sess.state), cash0, rtol=1e-6)


def test_pipeline_places_extra_stages():
    """post_allocate extras run before fetch_analyze, post_fetch extras
    (the default) after it and before the ordering's update stage."""
    cfg = scaled(webparf.reduced(), **OPIC_URL)
    ctx = ST.make_context(cfg, n_shards=4, device="cpu",
                          classify_accuracy=0.9)
    pol, rev = ST.make_politeness_stage(2), ST.make_revisit_stage(8)

    def plain(ctx, state, carry):
        return state, carry, {}
    pipe = ST.assemble_pipeline(ctx, [rev, pol, plain])
    upd = ctx.ordering.update_stage
    assert pipe == (ST.allocate, pol, ST.fetch_analyze, rev, plain, upd,
                    ST.extract_stage)
    assert ST.assemble_pipeline(ctx) == (ST.allocate, ST.fetch_analyze,
                                         upd, ST.extract_stage)


@pytest.mark.parametrize("cfg_name", ["reduced", "CONFIG"])
def test_freshness_functions_match_jax(cfg_name):
    import jax.numpy as jnp
    from repro.configs import webparf as jweb
    from repro.core import freshness as JF
    from repro_torch.core.frontier import encode_priority
    jcfg = jweb.reduced() if cfg_name == "reduced" else jweb.CONFIG
    tcfg = webparf.reduced() if cfg_name == "reduced" else webparf.CONFIG
    rng = np.random.default_rng(3)
    u = rng.integers(0, 1 << tcfg.url_space_log2, 20000).astype(np.uint32)
    tu = torch.tensor(u.astype(np.int64))
    ju = jnp.asarray(u)
    np.testing.assert_array_equal(np.asarray(JF.change_period(ju, jcfg)),
                                  TF.change_period(tu, tcfg).numpy())
    for step in (0, 5, 77, 1000):
        np.testing.assert_array_equal(
            np.asarray(JF.change_epoch(ju, step, jcfg)),
            TF.change_epoch(tu, step, tcfg).numpy())
    nb = tcfg.n_priority_buckets
    for age in (0, 1, 7, 32, 100):
        a = np.full(u.shape, age, np.int32)
        want = np.asarray(JF.revisit_score(ju, jnp.asarray(a), jcfg))
        got = TF.revisit_score(tu, torch.tensor(a), tcfg)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2**-23)
        zero = torch.zeros(u.shape, dtype=torch.int32)
        np.testing.assert_array_equal(
            encode_priority(torch.tensor(want), zero, nb).numpy(),
            encode_priority(got, zero, nb).numpy())


def test_reenqueue_matches_jax():
    """Fetched URLs re-enter at their revisit priority: the frontier
    after ``reenqueue`` equals JAX's."""
    import jax.numpy as jnp
    from repro.configs import webparf as jweb
    from repro.core import freshness as JF
    from repro.core import frontier as JFR
    from repro_torch.core import frontier as TFR
    cfg, jcfg = webparf.reduced(), jweb.reduced()
    rng = np.random.default_rng(5)
    R, C, k = 6, 16, 4
    url = rng.integers(0, 1 << 16, (R, C)).astype(np.uint32)
    valid = rng.random((R, C)) < 0.6
    pri = np.where(valid, rng.integers(0, 7, (R, C)) * float(1 << 20)
                   - rng.integers(0, 50, (R, C)), -3e38).astype(np.float32)
    arr = np.full(R, 60, np.int32)
    urls = rng.integers(0, 1 << 16, (R, k)).astype(np.uint32)
    mask = rng.random((R, k)) < 0.7
    age = rng.integers(1, 64, (R, k)).astype(np.int32)
    z = np.zeros(R, np.int32)
    jf = JF.reenqueue(JFR.Frontier(jnp.asarray(url), jnp.asarray(pri),
                                   jnp.asarray(valid), jnp.asarray(arr),
                                   jnp.asarray(z), jnp.asarray(z),
                                   jnp.asarray(z)),
                      jnp.asarray(urls), jnp.asarray(mask),
                      jnp.asarray(age), jcfg)
    t = lambda a: torch.tensor(a.astype(np.int64) if a.dtype == np.uint32  # noqa: E731
                               else a)
    tf = TF.reenqueue(TFR.Frontier(t(url), t(pri), t(valid), t(arr), t(z),
                                   t(z), t(z)),
                      t(urls), t(mask), t(age), cfg)
    for name, a, b in zip(TFR.Frontier._fields, jf, tf):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64)
                                      if name == "url" else np.asarray(a),
                                      b.numpy(), err_msg=name)
