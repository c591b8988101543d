"""The C3/C4 control plane of the port against the JAX package, in one
process: ``partitioner.rebalance`` (with and without the merge fallback),
``migrate_domains``, ``move_domain``, ``migrate_rows`` and
``split_domains`` produce the same maps; ``crawler.apply_rebalance``
migrates a crafted 4-shard ``opic_url`` state (random frontier rows, slot
cash and url lane on every row, spare rows included) to the same state,
with the duplicate-row scrub, the displaced-row refund, the merge refund
and the clearing of vacated live rows all exercised; cash balances.

Tolerances: maps and int/bool leaves identical; f32 leaves within 8 ulp
(a row's url-lane cash is a row sum: XLA's order against the port's fixed
tree); total cash within 1e-6 relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import webparf as jweb  # noqa: E402
from repro.core import crawler as JCR  # noqa: E402
from repro.core import partitioner as JPT  # noqa: E402
from repro.core import stages as JST  # noqa: E402
from repro_torch.configs.base import CrawlConfig  # noqa: E402
from repro_torch.core import crawler as TCR  # noqa: E402
from repro_torch.core import partitioner as TPT  # noqa: E402
from repro_torch.core import stages as TST  # noqa: E402
from repro_torch.ordering.opic import total_cash  # noqa: E402

MAX_ULP = 8
CASH_RTOL = 1e-6


def jcfg(n_domains=8, slot_factor=2, ordering="opic_url"):
    return dataclasses.replace(jweb.reduced(), n_domains=n_domains,
                               slot_factor=slot_factor, ordering=ordering,
                               kernel_impl="ref")


def port_cfg(cfg):
    return CrawlConfig(**{**dataclasses.asdict(cfg), "kernel_impl": "auto"})


def tmap(jdm):
    """The port's DomainMap of a JAX one."""
    return TPT.DomainMap(*(torch.tensor(np.asarray(a)) for a in jdm))


def assert_maps_equal(jdm, tdm):
    for name, a, b in zip(JPT.DomainMap._fields, jdm, tdm):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def loads_for(n_shards, n_domains, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 50, n_shards).astype(np.float64),
            rng.integers(1, 20, n_domains).astype(np.float64))


# (n_domains, slot_factor, n_shards, dead shards): slot factor 1 leaves no
# free slot, so rebalance merges
REBALANCE = [(8, 2, 4, [1]), (16, 2, 4, [0, 2]), (12, 2, 3, [2]),
             (8, 1, 4, [1]), (16, 1, 4, [3, 0])]


@pytest.mark.parametrize("n_domains,slot_factor,n_shards,dead", REBALANCE)
@pytest.mark.parametrize("weighted", [False, True])
def test_rebalance_matches_jax(n_domains, slot_factor, n_shards, dead,
                               weighted):
    cfg = jcfg(n_domains, slot_factor)
    jdm = JPT.identity_map(cfg, n_shards)
    loads, dloads = loads_for(n_shards, n_domains, seed=n_domains + n_shards)
    kw = dict(loads=loads, domain_loads=dloads if weighted else None)
    assert_maps_equal(JPT.rebalance(jdm, dead, **kw),
                      TPT.rebalance(tmap(jdm), dead, **kw))
    with pytest.raises(ValueError, match="no live shards"):
        TPT.rebalance(tmap(jdm), list(range(n_shards)))


@pytest.mark.parametrize("improve_only,limit", [(False, None), (True, None),
                                                (False, 2)])
def test_migrate_domains_matches_jax(improve_only, limit):
    cfg = jcfg(16)
    jdm = JPT.identity_map(cfg, 4)
    loads, dloads = loads_for(4, 16, seed=5)
    order = np.random.default_rng(6).permutation(16)
    kw = dict(loads=loads, domain_loads=dloads, limit=limit,
              improve_only=improve_only)
    jnew, jmoves = JPT.migrate_domains(jdm, order, **kw)
    tnew, tmoves = TPT.migrate_domains(tmap(jdm), order, **kw)
    assert_maps_equal(jnew, tnew)
    assert [tuple(int(x) for x in m) for m in jmoves] == tmoves
    assert tmoves or improve_only


def test_move_domain_matches_jax():
    jdm = JPT.identity_map(jcfg(8), 4)
    assert_maps_equal(JPT.move_domain(jdm, 3, 14),
                      TPT.move_domain(tmap(jdm), 3, 14))
    with pytest.raises(ValueError, match="occupied"):
        TPT.move_domain(tmap(jdm), 3, 0)
    merged = JPT.rebalance(JPT.identity_map(jcfg(8, 1), 4), [1])
    shared = int(np.flatnonzero(np.asarray(merged.slot_of_domain)
                                != np.arange(8))[0])
    with pytest.raises(ValueError, match="merged"):
        TPT.move_domain(tmap(merged), shared, 0)


def test_migrate_rows_and_split_match_jax():
    cfg = jcfg(8)
    jdm = JPT.identity_map(cfg, 4)
    jnew = JPT.rebalance(jdm, [2])
    a = np.random.default_rng(0).random((cfg.n_slots, 3)).astype(np.float32)
    want = JPT.migrate_rows({"a": jnp.asarray(a), "b": 7}, jdm, jnew,
                            rows=("a",))
    got = TPT.migrate_rows({"a": torch.tensor(a), "b": 7}, tmap(jdm),
                           tmap(jnew), rows=("a",))
    np.testing.assert_array_equal(np.asarray(want["a"]), got["a"].numpy())
    assert got["b"] == 7
    with pytest.raises(ValueError, match="row-indexed"):
        TPT.migrate_rows({"a": torch.zeros(3)}, tmap(jdm), tmap(jnew),
                         rows=("a",))
    assert dataclasses.asdict(JPT.split_domains(cfg)) == {
        **dataclasses.asdict(TPT.split_domains(port_cfg(cfg))),
        "kernel_impl": "ref"}


def crafted_state(cfg, n_shards, seed):
    """A JAX 4-shard init state with random queues, slot cash, history and
    url lane on every row (0 on invalid cells), as numpy leaves."""
    js = JST.init_state(cfg, n_shards)
    leaves = {n: np.asarray(a) for n, a in zip(JST.CrawlState._fields, js)}
    rng = np.random.default_rng(seed)
    R, C = leaves["f_url"].shape
    valid = rng.random((R, C)) < 0.5
    leaves["f_valid"] = valid
    leaves["f_url"] = np.where(valid, rng.integers(1, 1 << 16, (R, C)),
                               0).astype(np.uint32)
    leaves["f_pri"] = np.where(valid, rng.integers(0, 1000, (R, C)),
                               -1e9).astype(np.float32)
    os_ = rng.random(leaves["order_state"].shape).astype(np.float32)
    if os_.shape[1] > 2:                        # the url lane
        os_[:, 2:] *= valid
    leaves["order_state"] = os_
    leaves["bloom_bits"] = (rng.random(leaves["bloom_bits"].shape)
                            < 0.1).astype(np.uint8)
    return leaves


def live_move(jdm, n_domains):
    return JPT.migrate_domains(jdm, np.arange(n_domains),
                               loads=np.array([40.0, 0, 0, 0]), limit=3)[0]


# (label, n_domains, slot_factor, the new map from the old)
REMAPS = [
    ("heal", 8, 2, lambda jdm, n: JPT.rebalance(jdm, [1])),
    ("heal-two", 16, 2, lambda jdm, n: JPT.rebalance(jdm, [0, 3])),
    ("merge", 8, 1, lambda jdm, n: JPT.rebalance(jdm, [2])),
    ("live-move", 8, 2, live_move),
]


@pytest.mark.parametrize("label,n_domains,slot_factor,remap", REMAPS,
                         ids=[r[0] for r in REMAPS])
def test_apply_rebalance_matches_jax(label, n_domains, slot_factor, remap):
    cfg = jcfg(n_domains, slot_factor)
    leaves = crafted_state(cfg, 4, seed=n_domains * slot_factor)
    js = JST.CrawlState(**{n: jnp.asarray(a) for n, a in leaves.items()})
    jdm = JPT.DomainMap(js.slot_of_domain, js.slot_domain, js.shard_alive)
    jnew = remap(jdm, n_domains)
    jout = JCR.apply_rebalance(js, cfg, jnew)
    ts = TST.state_from_numpy(leaves, "cpu")
    cash0 = total_cash(ts)
    tout = TCR.apply_rebalance(ts, port_cfg(cfg), tmap(jnew))
    got = TST.state_to_numpy(tout)
    for name, leaf in zip(JST.CrawlState._fields, jout):
        a = np.asarray(leaf)
        if a.dtype == np.float32:
            np.testing.assert_array_max_ulp(a, got[name], maxulp=MAX_ULP)
        else:
            np.testing.assert_array_equal(a, got[name], err_msg=name)
    np.testing.assert_allclose(total_cash(tout), cash0, rtol=CASH_RTOL)
    moved = np.asarray(jnew.slot_of_domain) != leaves["slot_of_domain"]
    assert moved.any()


def test_heal_crawler_and_revive():
    """heal_crawler keeps the healed shard dead and balances by frontier
    depth as the JAX package's does; revive brings a shard back."""
    from repro.train.fault import heal_crawler as jheal
    from repro_torch.train.fault import heal_crawler, revive
    cfg = jcfg(16, ordering="backlink")
    leaves = crafted_state(cfg, 4, seed=3)
    leaves["order_state"] = np.zeros_like(leaves["order_state"][:, :2])
    js = JCR.mark_dead(JST.CrawlState(**{n: jnp.asarray(a)
                                        for n, a in leaves.items()}), [2])
    ts = TCR.mark_dead(TST.state_from_numpy(leaves, "cpu"), [2])
    jout = jheal(js, cfg, [2], 4)
    tout = heal_crawler(ts, port_cfg(cfg), [2], 4)
    got = TST.state_to_numpy(tout)
    for name, leaf in zip(JST.CrawlState._fields, jout):
        np.testing.assert_array_equal(np.asarray(leaf), got[name],
                                      err_msg=name)
    assert not bool(tout.shard_alive[2])
    assert bool(revive(tout, [2]).shard_alive[2])
