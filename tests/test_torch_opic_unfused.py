"""The ``opic_url`` crawl with unfused dispatch (``fused_dispatch=False``:
select + gather, the Bloom kernel, the twin match and the cell scatter,
then ``insert_valued``), the port against the JAX package over a reduced
run, and one transition at a time from a shared JAX checkpoint: the port
restores the JAX state before a dispatch step, takes that step, and must
land on the JAX package's next state. Tolerances as in
tests/test_torch_opic_session.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import CrawlSession as JaxSession  # noqa: E402
from repro_torch.api import CrawlSession  # noqa: E402
from test_torch_opic_session import (STEPS, assert_runs_close,  # noqa: E402
                                     assert_states_close, jax_cfg, port_cfg)

SPLIT = 19                   # step 19 is a dispatch step (interval 4)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX crawl, checkpointed before and after step SPLIT."""
    d = tmp_path_factory.mktemp("ckpt")
    jsess = JaxSession(jax_cfg("opic_url", fused=False))
    first = jsess.run(SPLIT)
    jsess.checkpoint(str(d / "before"))
    step = jsess.run(1)
    jsess.checkpoint(str(d / "after"))
    rest = jsess.run(STEPS - SPLIT - 1)
    return jsess, (first, step, rest), d


def test_unfused_crawl_matches_jax(jax_run):
    jsess, parts, _ = jax_run
    tsess = CrawlSession(port_cfg(jax_cfg("opic_url", fused=False)),
                         device="cpu")
    trep = tsess.run(STEPS)
    np.testing.assert_array_equal(
        np.concatenate([p.urls for p in parts]), trep.urls)
    np.testing.assert_array_equal(
        np.concatenate([p.per_step for p in parts]), trep.per_step)
    assert parts[-1].stats == trep.stats
    assert_states_close(jsess.state, tsess.state)


def test_one_transition_from_jax_checkpoint(jax_run):
    """The dispatch step SPLIT, from the JAX state before it: the port's
    next state must be the JAX package's, and so must the rest of the run
    from there."""
    jsess, (_, jstep, jrest), d = jax_run
    tsess = CrawlSession(port_cfg(jax_cfg("opic_url", fused=False)),
                         device="cpu").restore(str(d / "before"))
    assert tsess.t == SPLIT and (SPLIT + 1) % tsess.cfg.dispatch_interval == 0
    trep = tsess.run(1)
    after = CrawlSession(tsess.cfg, device="cpu").restore(str(d / "after"))
    np.testing.assert_array_equal(jstep.urls, trep.urls)
    for name, x, y in zip(tsess.state._fields, tsess.state, after.state):
        if x.dtype == torch.float32:
            np.testing.assert_array_max_ulp(x.numpy(), y.numpy(), maxulp=8)
        else:
            assert torch.equal(x, y), name
    assert_runs_close(jrest, jsess, tsess.run(STEPS - SPLIT - 1), tsess)
