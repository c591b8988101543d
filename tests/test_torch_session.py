"""The port's crawl as a whole against the JAX reference: the same config
runs in both packages and every output and every CrawlState leaf must be
identical. Also the port's own modes, its device default, and a shared
.npz checkpoint in both directions."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import CrawlSession as JaxSession  # noqa: E402
from repro.configs import webparf as jweb  # noqa: E402
from repro.core import stages as JST  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs.base import CrawlConfig  # noqa: E402
from repro_torch.core.stages import state_to_numpy  # noqa: E402

STEPS = 48


def port_cfg(jcfg):
    return CrawlConfig(**{**dataclasses.asdict(jcfg), "kernel_impl": "auto"})


def assert_runs_equal(jrep, jsess, trep, tsess):
    np.testing.assert_array_equal(jrep.urls, trep.urls)
    np.testing.assert_array_equal(jrep.per_step, trep.per_step)
    assert jrep.stats == trep.stats
    assert_states_equal(jsess.state, tsess.state)


def assert_states_equal(jstate, tstate):
    tn = state_to_numpy(tstate)
    for name, leaf in zip(JST.CrawlState._fields, jstate):
        a = np.asarray(leaf)
        assert a.dtype == tn[name].dtype and a.shape == tn[name].shape, name
        np.testing.assert_array_equal(a, tn[name],
                                      err_msg=f"CrawlState.{name} diverged")


@pytest.fixture(scope="module")
def port_run():
    sess = CrawlSession(port_cfg(jweb.reduced()), device="cpu")
    return sess.run(STEPS), sess


@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_reduced_crawl_identical_to_jax(port_run, impl):
    trep, tsess = port_run
    jcfg = dataclasses.replace(jweb.reduced(), kernel_impl=impl)
    jsess = JaxSession(jcfg)
    jrep = jsess.run(STEPS)
    assert_runs_equal(jrep, jsess, trep, tsess)
    assert trep.stats["dedup_bloom"] > 0        # the Bloom dedup ran
    assert trep.fetched > 0


def test_url_hash_crawl_identical_to_jax():
    jcfg = dataclasses.replace(jweb.reduced(), kernel_impl="ref",
                               partitioning="url_hash")
    jsess, tsess = JaxSession(jcfg), CrawlSession(port_cfg(jcfg),
                                                  device="cpu")
    assert_runs_equal(jsess.run(32), jsess, tsess.run(32), tsess)


def test_inject_failure_identical_to_jax():
    """A dead shard gives back every pop (allocate's give-back path) and
    sends nothing at dispatch."""
    jcfg = dataclasses.replace(jweb.reduced(), kernel_impl="ref")
    jsess, tsess = JaxSession(jcfg), CrawlSession(port_cfg(jcfg),
                                                  device="cpu")
    assert_runs_equal(jsess.run(10), jsess, tsess.run(10), tsess)
    jsess.inject_failure(0)
    tsess.inject_failure(0)
    jrep, trep = jsess.run(10), tsess.run(10)
    assert_runs_equal(jrep, jsess, trep, tsess)
    assert trep.fetched == 0 and trep.stats["revived"] > 0


def test_transition_from_shared_checkpoint(tmp_path):
    """A JAX state saved mid-run (step 10, between dispatches) restores in
    the port and steps on identically; the port's checkpoint restores in
    the JAX package leaf for leaf."""
    jcfg = dataclasses.replace(jweb.reduced(), kernel_impl="ref")
    jsess = JaxSession(jcfg)
    jsess.run(10)
    jsess.checkpoint(str(tmp_path / "jax"))
    tsess = CrawlSession(port_cfg(jcfg), device="cpu")
    tsess.restore(str(tmp_path / "jax"))
    assert tsess.t == 10
    assert_states_equal(jsess.state, tsess.state)
    jrep, trep = jsess.run(7), tsess.run(7)
    assert_runs_equal(jrep, jsess, trep, tsess)
    tsess.checkpoint(str(tmp_path / "port"))
    back = jckpt.restore(str(tmp_path / "port"), jsess.state)
    assert_states_equal(back, tsess.state)


def test_modes_identical(port_run):
    trep, tsess = port_run
    cfg = port_cfg(jweb.reduced())
    for mode in ("eager", "scan"):
        sess = CrawlSession(cfg, device="cpu")
        rep = sess.run(STEPS, mode=mode)
        np.testing.assert_array_equal(rep.urls, trep.urls)
        np.testing.assert_array_equal(rep.per_step, trep.per_step)
        assert rep.stats == trep.stats
        for name, a, b in zip(tsess.state._fields, sess.state, tsess.state):
            assert torch.equal(a, b), name
    sess = CrawlSession(cfg, device="cpu")
    events = {5: lambda s: s}                   # a mid-interval event
    with pytest.raises(ValueError):
        sess.run(8, mode="scan", events=events)
    rep = sess.run(STEPS, events=events)        # auto falls back to steps
    np.testing.assert_array_equal(rep.urls, trep.urls)


def test_reset_restarts_the_trajectory():
    cfg = port_cfg(jweb.reduced())
    sess = CrawlSession(cfg, device="cpu")
    a = sess.run(8)
    b = sess.reset().run(8)
    np.testing.assert_array_equal(a.urls, b.urls)
    assert sess.t == 8


def test_default_device_is_cuda():
    cfg = port_cfg(jweb.reduced())
    if torch.cuda.is_available():
        assert CrawlSession(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            CrawlSession(cfg)
