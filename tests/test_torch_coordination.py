"""The coordination modes of the port — firewall, crossover and batched
beside exchange — against the JAX package at ``webparf.reduced()``.

Every mode runs under backlink, opic, opic_url (fused) and opic_url
(unfused dispatch) with 1 shard and with 4 shards batched along the
state's leading axis, against one JAX subprocess (``_torch_play``; 4 host
devices, a 1-shard case on the first) that also runs the batched mode's
quota edges and a fail -> heal. The plans alone are held to the JAX plans
on crafted pools (ties, -0.0 values, dead shards) in this process.
Tolerances as in ``_torch_play``.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_play import assert_case, play, run_jax  # noqa: E402
from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs import webparf  # noqa: E402
from repro_torch.configs.base import scaled  # noqa: E402
from repro_torch.coordination import (CoordinationPolicy,  # noqa: E402
                                      coordinations, get_coordination,
                                      register_coordination)
from repro_torch.core.stages import SIDX, state_to_numpy  # noqa: E402

IV = webparf.reduced().dispatch_interval           # 4 steps a dispatch
QUOTA = 6            # a shard stages up to 32 a dispatch: the outbox fills
ORDERINGS = {
    "backlink": {},
    "opic": {"ordering": "opic", "link_pop_bias": 1.0},
    "opic_url": {"ordering": "opic_url", "link_pop_bias": 1.0},
    "opic_url-unfused": {"ordering": "opic_url", "link_pop_bias": 1.0,
                         "fused_dispatch": False},
}
MODES = {"firewall": {}, "crossover": {},
         "batched": {"comm_quota": QUOTA}}

CASES = {
    f"{mode}-{o}-{n}": {"over": {"coordination": mode, **mo, **oo},
                        "shards": n, "ops": [["run", 3 * IV]]}
    for mode, mo in MODES.items() for o, oo in ORDERINGS.items()
    for n in (1, 4)
}
CASES.update({
    # the quota's edges: nothing ships (everything parks, the outbox
    # overflows), one URL a dispatch, and a quota past the pool (every
    # valid URL ships: the exchange's URL flow, through the outbox path)
    **{f"batched-q{q}": {"over": {"coordination": "batched", "comm_quota": q,
                                  **ORDERINGS["opic"]},
                         "shards": 4, "ops": [["run", 3 * IV]]}
       for q in (0, 1, 1000)},
    # a dead shard ships nothing but parks; after the heal its parked URLs
    # route through the live domain map
    "batched-heal": {"over": {"coordination": "batched", "comm_quota": QUOTA,
                              **ORDERINGS["opic_url"]},
                     "shards": 4,
                     "ops": [["run", IV], ["fail", 1], ["run", IV],
                             ["heal"], ["run", 2 * IV]]},
})


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("jax_coordination"), CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_mode_crawl_matches_jax(jax_ref, name):
    sess, rec = play(CASES[name])
    assert_case(jax_ref / f"{name}.npz", sess, rec, name)
    stats = sess.state.stats.numpy()
    assert (stats[:, SIDX["fetched"]] > 0).all()


@pytest.mark.parametrize("mode", ["firewall", "crossover"])
def test_zero_communication_modes_ship_nothing(jax_ref, mode):
    """At 4 shards the zero-communication modes ship nothing and keep what
    they staged; firewall drops the foreign URLs, crossover queues them."""
    _, rec = play(CASES[f"{mode}-backlink-4"])
    rep = rec["run0"]
    assert rep.comm["urls_shipped"] == 0 and rep.comm["comm_per_page"] == 0
    assert rep.comm["urls_received"] > 0
    dropped = rep.comm["urls_dropped"]
    assert (dropped > 0) if mode == "firewall" else (dropped == 0)


def test_batched_bounds_shipping_and_parks():
    """Each shard ships at most its quota a dispatch and the rest parks."""
    sess, rec = play(CASES["batched-opic-4"])
    rep = rec["run0"]
    sent = rep.stats_per_shard["dispatch_sent"]
    rounds = rep.stats_per_shard["dispatch_rounds"]
    assert (sent <= QUOTA * rounds).all() and sent.sum() > 0
    assert rep.comm["urls_deferred"] > 0
    assert int(sess.state.outbox_n.sum()) > 0


def test_batched_without_quota_is_exchange_bit_for_bit():
    """comm_quota < 0: the batched mode's trajectory, counters and state
    equal the exchange mode's (its outbox stays empty)."""
    for n in (1, 4):
        for oo in (ORDERINGS["opic_url"], ORDERINGS["backlink"]):
            runs = []
            for mode in ("exchange", "batched"):
                cfg = scaled(webparf.reduced(), coordination=mode,
                             comm_quota=-1, **oo)
                sess = CrawlSession(cfg, device="cpu", n_shards=n)
                runs.append((sess.run(3 * IV), state_to_numpy(sess.state)))
            (ra, sa), (rb, sb) = runs
            np.testing.assert_array_equal(ra.urls, rb.urls)
            assert ra.stats == rb.stats
            for k in sa:
                np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_batched_heal_reroutes_parked_urls():
    """A dead shard ships nothing but parks what it staged (its values
    counted in the cash); after the heal no domain maps to it, so every
    URL, parked ones included, routes to a live owner and the dead shard
    receives nothing more."""
    from repro_torch.ordering.opic import total_cash
    case = CASES["batched-heal"]
    sess = CrawlSession(scaled(webparf.reduced(), **case["over"]),
                        device="cpu", n_shards=4)
    cash0 = total_cash(sess.state)
    sess.run(IV)
    sent, recv, deferred = (int(sess.state.stats[1, SIDX[k]]) for k in
                            ("dispatch_sent", "dispatch_recv",
                             "coord_deferred"))
    sess.inject_failure(1)
    sess.run(IV)
    assert int(sess.state.stats[1, SIDX["dispatch_sent"]]) == sent
    assert int(sess.state.stats[1, SIDX["coord_deferred"]]) > deferred
    assert int(sess.state.outbox_n[1]) > 0
    sess.heal()
    r_local = sess.cfg.n_slots // 4
    assert not (sess.state.slot_of_domain // r_local == 1).any()
    recv = int(sess.state.stats[1, SIDX["dispatch_recv"]])
    sess.run(2 * IV)
    assert int(sess.state.stats[1, SIDX["dispatch_recv"]]) == recv
    assert int(sess.state.stats[1, SIDX["dispatch_sent"]]) == sent
    np.testing.assert_allclose(total_cash(sess.state), cash0, rtol=1e-6)


def test_registry_and_third_party_mode():
    """The four built-ins are registered; a conflicting re-registration
    raises; a registered third-party mode runs by name like a built-in."""
    from repro_torch.coordination import registry
    assert coordinations() == ("batched", "crossover", "exchange",
                               "firewall")
    ex = get_coordination("exchange")
    assert register_coordination(ex) is ex
    with pytest.raises(ValueError, match="registered twice"):
        register_coordination(CoordinationPolicy("exchange", True, False,
                                                 False, ex.plan))
    with pytest.raises(KeyError, match="unknown"):
        get_coordination("nope")
    fw = get_coordination("firewall")
    register_coordination(CoordinationPolicy("firewall_v2", False, False,
                                             False, fw.plan))
    try:
        rep = CrawlSession(scaled(webparf.reduced(),
                                  coordination="firewall_v2"),
                           device="cpu", n_shards=4).run(2 * IV)
        base = CrawlSession(scaled(webparf.reduced(),
                                   coordination="firewall"),
                            device="cpu", n_shards=4).run(2 * IV)
    finally:
        registry._POLICIES.pop("firewall_v2", None)
    assert rep.fetched > 0 and rep.stats["dispatch_sent"] == 0
    np.testing.assert_array_equal(rep.urls, base.urls)


def crafted_pool(seed, n=4, P=40):
    """Pools of every plan case: values with ties (0.0 and a repeated
    value), -0.0 refunds, unstaged tails, a dead shard, and destinations
    on every shard."""
    rng = np.random.default_rng(seed)
    val = rng.choice(np.array([0.0, -0.0, 0.25, 0.5, 0.5, 1.0, 3.0],
                              np.float32), (n, P))
    staged = np.arange(P)[None] < rng.integers(P // 2, P + 1, (n, 1))
    alive = np.ones(n, bool)
    alive[1] = False
    valid = staged & alive[:, None]
    dest = rng.integers(0, n, (n, P)).astype(np.int64)
    u = rng.integers(0, 1 << 16, (n, P)).astype(np.int64)
    src = rng.integers(0, 8, (n, P)).astype(np.int32)
    return u, src, val, dest, staged, valid


@pytest.mark.parametrize("mode,quota", [
    ("exchange", -1), ("firewall", -1), ("crossover", -1),
    ("batched", -1), ("batched", 0), ("batched", 1), ("batched", 7),
    ("batched", 40), ("batched", 1000)])
def test_plans_match_jax_on_crafted_pools(mode, quota):
    """Each plan alone, every shard's pool at once, against the JAX plan
    run shard by shard (the JAX plans see one shard's pool under
    shard_map): ties broken in pool order, -0.0 equal to 0.0, a dead
    shard shipping nothing yet parking."""
    import jax.numpy as jnp
    from repro.coordination import get_coordination as jax_coordination
    for seed in range(3):
        u, src, val, dest, staged, valid = crafted_pool(seed)
        n = u.shape[0]
        ctx = SimpleNamespace(cfg=scaled(webparf.reduced(),
                                         comm_quota=quota))
        got = get_coordination(mode).plan(
            ctx, None, torch.arange(n)[:, None], torch.tensor(u),
            torch.tensor(src), torch.tensor(val), torch.tensor(dest),
            torch.tensor(staged), torch.tensor(valid))
        for s in range(n):
            want = jax_coordination(mode).plan(
                ctx, None, jnp.int32(s), jnp.asarray(u[s], jnp.uint32),
                jnp.asarray(src[s]), jnp.asarray(val[s]),
                jnp.asarray(dest[s], jnp.int32), jnp.asarray(staged[s]),
                jnp.asarray(valid[s]))
            for field in got._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(want, field)),
                    getattr(got, field)[s].numpy(),
                    err_msg=f"{mode} q={quota} seed {seed} shard {s} "
                            f"{field}")
        if mode == "batched" and quota >= 0:
            assert (got.ship.sum(1) <= quota).all()
            assert not got.ship[1].any()                  # the dead shard
            assert torch.equal(got.defer[1], torch.tensor(staged[1]))


def test_comm_ledger_line():
    from repro_torch.coordination import comm_ledger, ledger_line
    comm = comm_ledger({"dispatch_sent": 30, "dispatch_recv": 28,
                        "coord_dropped": 2, "coord_deferred": 5}, 12)
    assert comm == dict(urls_shipped=30, urls_received=28, urls_dropped=2,
                        urls_deferred=5, comm_per_page=2.5)
    assert ledger_line(comm) == ("30 URLs shipped (2.50/page), 2 dropped, "
                                 "5 deferred")
    assert json.dumps(comm_ledger({}, 0))
