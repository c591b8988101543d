"""Load-driven rebalance in the port against the JAX package: the
registry, the ``hot_domain`` plan on crafted loads and domain maps (in
this process), and crawls whose imbalance passes a low threshold, so that
the session migrates hot domains live -> live, against one JAX subprocess
(``_torch_play``) at ``webparf.reduced()`` with 4 shards.

The plans' moves and imbalance numbers must equal JAX's exactly (both are
numpy on the host, from the same f64 loads). The crawl states are held as
in ``_torch_play``, but ``f_pri`` only where ``f_valid`` holds: a rebalance
clears a vacated row's priorities to 0, and the next pop of that empty row
leaves an implementation-defined value in its invalid cells (JAX's plain
pop writes -3e38 into the cells its top-k surfaced, JAX's Pallas pop into
every invalid cell, the port's pop into none).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_play import assert_case, play, run_jax  # noqa: E402
from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs import webparf  # noqa: E402
from repro_torch.configs.base import scaled  # noqa: E402
from repro_torch.core import partitioner as TPT  # noqa: E402
from repro_torch.rebalance import (RebalanceEvent,  # noqa: E402
                                   RebalancePolicy, get_rebalance,
                                   rebalances, register_rebalance)

IV = webparf.reduced().dispatch_interval
TRIGGER = {"telemetry": True, "rebalance_threshold": 1.01}

CASES = {
    "opic_url": {"over": {**TRIGGER, "ordering": "opic_url",
                          "link_pop_bias": 1.0},
                 "shards": 4, "ops": [["run", 4 * IV]]},
    "backlink-url_hash": {"over": {**TRIGGER, "partitioning": "url_hash"},
                          "shards": 4, "ops": [["run", 4 * IV]]},
    "opic-eager": {"over": {**TRIGGER, "ordering": "opic",
                            "link_pop_bias": 1.0,
                            "rebalance_max_domains": 1},
                   "shards": 4, "ops": [["run_eager", 4 * IV]]},
}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("jax_rebalance"), CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_forced_rebalance_matches_jax(jax_ref, name):
    sess, rec = play(CASES[name])
    assert_case(jax_ref / f"{name}.npz", sess, rec, name,
                valid_pri_only=True)
    rep = rec["run0"]
    assert rep.rebalances and rep.rebalances == tuple(sess.rebalance_events)
    for e in rep.rebalances:
        assert e.trigger > sess.cfg.rebalance_threshold
        assert e.imbalance_after < e.imbalance_before
    assert "rebalances" in rep.summary()
    names = [e.name for e in sess.tracer.events]
    assert names.count("rebalance") == 2 * len(rep.rebalances)


def test_registry():
    assert rebalances() == ("hot_domain",)
    hot = get_rebalance("hot_domain")
    assert register_rebalance(hot) is hot
    with pytest.raises(ValueError, match="registered twice"):
        register_rebalance(RebalancePolicy("hot_domain", hot.plan))
    with pytest.raises(KeyError, match="unknown"):
        get_rebalance("nope")
    ev = RebalanceEvent(step=8, trigger=1.23456, moves=((3, 0, 2),),
                        imbalance_before=1.5, imbalance_after=1.123456)
    assert ev.domains == (3,)
    assert ev.asdict() == dict(step=8, trigger=1.2346, moves=[[3, 0, 2]],
                               imbalance_before=1.5, imbalance_after=1.1235)


def test_threshold_needs_telemetry():
    cfg = scaled(webparf.reduced(), rebalance_threshold=1.5)
    with pytest.raises(ValueError, match="telemetry"):
        CrawlSession(cfg, device="cpu", n_shards=4)
    with pytest.raises(KeyError, match="unknown"):
        CrawlSession(scaled(cfg, telemetry=True, rebalance="nope"),
                     device="cpu", n_shards=4)
    sess = CrawlSession(scaled(cfg, rebalance_threshold=0.0), device="cpu",
                        n_shards=4)
    assert sess.maybe_rebalance() is None


def crafted(seed, n_shards):
    """A domain map with some domains moved off their home slots and
    (seed 2) a dead shard, and per-row depths and cash with ties and
    empty rows."""
    cfg = webparf.reduced()
    rng = np.random.default_rng(seed)
    n_slots = cfg.n_slots
    depth = rng.choice([0, 0, 3, 5, 5, 9, 20], n_slots).astype(np.float64)
    cash = rng.choice([0.0, 0.5, 0.5, 2.0], n_slots)
    dm = TPT.identity_map(cfg, n_shards, "cpu")
    per = n_slots // n_shards
    for d in rng.permutation(cfg.n_domains)[:2]:
        free = np.flatnonzero(dm.domain_of_slot.numpy() < 0)
        dm = TPT.move_domain(dm, int(d), int(rng.choice(free)))
    alive = np.ones(n_shards, bool)
    if seed == 2:
        alive[n_shards - 1] = False
    dm = dm._replace(shard_alive=torch.tensor(alive))
    depth[dm.domain_of_slot.numpy() < 0] = 0.0
    return cfg, dm, depth, cash, per


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("max_domains", [1, 4])
def test_hot_domain_plan_matches_jax(seed, max_domains):
    import jax.numpy as jnp
    from repro.configs import webparf as jweb
    from repro.core import partitioner as JPT
    from repro.rebalance import get_rebalance as jax_rebalance
    n_shards = 2 if seed == 4 else 4
    cfg, dm, depth, cash, _ = crafted(seed, n_shards)
    cfg = scaled(cfg, rebalance_max_domains=max_domains)
    jcfg = scaled(jweb.reduced(), rebalance_max_domains=max_domains)
    jdm = JPT.DomainMap(jnp.asarray(dm.slot_of_domain.numpy()),
                        jnp.asarray(dm.domain_of_slot.numpy()),
                        jnp.asarray(dm.shard_alive.numpy()))
    want = jax_rebalance("hot_domain").plan(jcfg, jdm, depth.copy(),
                                            cash.copy())
    got = get_rebalance("hot_domain").plan(cfg, dm, depth.copy(),
                                           cash.copy())
    assert (want is None) == (got is None)
    if want is None:
        return
    assert got.moves == want.moves and len(got.moves) <= max_domains
    assert got.imbalance_before == want.imbalance_before
    assert got.imbalance_after == want.imbalance_after
    for a, b in zip(want.new_map, got.new_map):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_hot_domain_plan_declines():
    """No plan with one live shard, with no load, or when no move lowers
    the peak."""
    plan = get_rebalance("hot_domain").plan
    cfg, dm, depth, cash, per = crafted(0, 4)
    one = dm._replace(shard_alive=torch.tensor([True, False, False, False]))
    assert plan(cfg, one, depth, cash) is None
    assert plan(cfg, dm, np.zeros_like(depth), cash) is None
    flat = np.zeros_like(depth)
    flat[dm.domain_of_slot.numpy() >= 0] = 1.0
    flat = flat.reshape(4, per)
    flat = (flat / np.maximum(flat.sum(1, keepdims=True), 1)).reshape(-1)
    assert plan(cfg, dm, flat, np.zeros_like(cash)) is None
