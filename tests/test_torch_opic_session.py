"""The OPIC orderings' crawl as a whole, the port against the JAX package:
``opic`` and ``opic_url`` (fused dispatch) run the same reduced config in
both, with ``link_pop_bias=1.0`` so that received URLs hit the Bloom
filter and queued twins. Also the port's own contracts: fused and unfused
dispatch give the same trajectory bit for bit, cash is conserved, and a
checkpoint carries the (n_slots, 2 + C) order_state both ways.

Tolerances: every int and bool leaf and output must be identical. f32
leaves (order_state, staging_val) are held to 8 ulp: the port's row sums
add in a fixed tree order where XLA's CPU reduction adds in its own, so a
refund or a row mean may differ in its last bits (on this CPU they came
out identical). Total cash must agree to 1e-6 relative."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import CrawlSession as JaxSession  # noqa: E402
from repro.configs import webparf as jweb  # noqa: E402
from repro.core import stages as JST  # noqa: E402
from repro.ordering.opic import total_cash as jax_total_cash  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs.base import CrawlConfig  # noqa: E402
from repro_torch.core.stages import state_to_numpy  # noqa: E402
from repro_torch.ordering.opic import total_cash  # noqa: E402

STEPS = 48
MAX_ULP = 8
CASH_RTOL = 1e-6


def jax_cfg(ordering, fused=True):
    return dataclasses.replace(jweb.reduced(), ordering=ordering,
                               link_pop_bias=1.0, fused_dispatch=fused,
                               kernel_impl="ref")


def port_cfg(jcfg):
    return CrawlConfig(**{**dataclasses.asdict(jcfg), "kernel_impl": "auto"})


def assert_states_close(jstate, tstate):
    tn = state_to_numpy(tstate)
    for name, leaf in zip(JST.CrawlState._fields, jstate):
        a = np.asarray(leaf)
        assert a.dtype == tn[name].dtype and a.shape == tn[name].shape, name
        if a.dtype == np.float32:
            np.testing.assert_array_max_ulp(a, tn[name], maxulp=MAX_ULP)
        else:
            np.testing.assert_array_equal(a, tn[name],
                                          err_msg=f"CrawlState.{name}")
    np.testing.assert_allclose(total_cash(tstate), jax_total_cash(jstate),
                               rtol=CASH_RTOL)


def assert_runs_close(jrep, jsess, trep, tsess):
    np.testing.assert_array_equal(jrep.urls, trep.urls)
    np.testing.assert_array_equal(jrep.per_step, trep.per_step)
    assert jrep.stats == trep.stats
    assert_states_close(jsess.state, tsess.state)


@pytest.fixture(scope="module", params=["opic", "opic_url"])
def runs(request):
    jcfg = jax_cfg(request.param)
    jsess = JaxSession(jcfg)
    tsess = CrawlSession(port_cfg(jcfg), device="cpu")
    return jsess.run(STEPS), jsess, tsess.run(STEPS), tsess


def test_opic_crawl_matches_jax(runs):
    jrep, jsess, trep, tsess = runs
    assert_runs_close(jrep, jsess, trep, tsess)
    assert trep.fetched > 0 and trep.stats["dispatch_recv"] > 0
    # the value channel ran: slot cash moved into history
    assert tsess.state.order_state[:, 1].sum() > 0


def test_cash_conserved(runs):
    """Every dispatch delivers or refunds each staged value: total cash
    stays at its initial value (one unit per domain slot) up to the f32
    rounding of the spend split."""
    _, _, trep, tsess = runs
    cfg = tsess.cfg
    np.testing.assert_allclose(total_cash(tsess.state), cfg.n_domains,
                               rtol=CASH_RTOL)


def test_fused_dispatch_matches_unfused():
    """select_harvest + dedup_deposit + place_valued/rescore against the
    unfused pop, twin match, cell scatter and insert: the same trajectory,
    every state leaf and output bit for bit, step by step."""
    jcfg = jax_cfg("opic_url")
    fused = CrawlSession(port_cfg(jcfg), device="cpu")
    plain = CrawlSession(port_cfg(dataclasses.replace(
        jcfg, fused_dispatch=False)), device="cpu")
    for t in range(STEPS):
        a, b = fused.step(), plain.step()
        for x, y in zip(a, b):
            assert torch.equal(x, y), t
        for name, x, y in zip(fused.state._fields, fused.state, plain.state):
            assert torch.equal(x, y), f"step {t}: {name}"
    assert fused.stats["dedup_bloom"] > 0


def test_checkpoint_carries_the_url_lane(tmp_path, runs):
    """A checkpoint of an OPIC crawl, order_state (n_slots, 2 + C)
    included, restores in the other package, and the port steps on alike
    from its own checkpoint and from the JAX package's."""
    _, jsess, _, tsess = runs
    tsess.checkpoint(str(tmp_path / "port"))
    jsess.checkpoint(str(tmp_path / "jax"))
    back = jckpt.restore(str(tmp_path / "port"), jsess.state)
    assert_states_close(back, tsess.state)
    own = CrawlSession(tsess.cfg, device="cpu").restore(str(tmp_path / "port"))
    other = CrawlSession(tsess.cfg, device="cpu").restore(
        str(tmp_path / "jax"))
    assert own.t == other.t == STEPS
    width = 2 + (tsess.cfg.frontier_capacity
                 if tsess.cfg.ordering == "opic_url" else 0)
    assert own.state.order_state.shape[1] == width
    for name, x, y in zip(tsess.state._fields, tsess.state, own.state):
        assert torch.equal(x, y), name
    a, b = own.run(8), other.run(8)
    np.testing.assert_array_equal(a.urls, b.urls)
    assert a.stats == b.stats
