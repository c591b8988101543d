"""The port's observability layer against the JAX package: the load
ledger's rows (eager and chunked, a dead shard's lane, the batched mode's
outbox column), the ledger checkpoint written by the JAX session and
restored in the port, telemetry off against on, and the Chrome trace.

The crawl cases run at ``webparf.reduced()`` against one JAX subprocess
(``_torch_play``). Every ledger column is held identical but
``cash_mass`` (1e-6 relative: the port adds by a fixed tree, XLA in its
own order); states and cash as in ``_torch_play``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_play import (assert_case, assert_ledger, play,  # noqa: E402
                         run_jax)
from repro_torch import obs  # noqa: E402
from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs import webparf  # noqa: E402
from repro_torch.configs.base import scaled  # noqa: E402
from repro_torch.core.stages import state_to_numpy  # noqa: E402

IV = webparf.reduced().dispatch_interval
OPIC_URL = {"ordering": "opic_url", "link_pop_bias": 1.0, "telemetry": True}
DEAD = 2

CASES = {
    "opic_url-4": {"over": OPIC_URL, "shards": 4, "ops": [["run", 3 * IV]]},
    "opic_url-4-eager": {"over": OPIC_URL, "shards": 4,
                         "ops": [["run_eager", 3 * IV]]},
    "backlink-1": {"over": {"telemetry": True}, "shards": 1,
                   "ops": [["run", 2 * IV]]},
    # shard DEAD's lane reads 0 from its failure on
    "dead-backlink-4": {"over": {"telemetry": True}, "shards": 4,
                        "ops": [["run", IV], ["fail", DEAD],
                                ["run", 2 * IV]]},
    "batched-opic-4": {"over": {"telemetry": True, "ordering": "opic",
                                "link_pop_bias": 1.0,
                                "coordination": "batched", "comm_quota": 4},
                       "shards": 4, "ops": [["run", 3 * IV]]},
    # a checkpoint taken mid-interval holds the ledger beside the state
    "checkpoint": {"over": OPIC_URL, "shards": 4,
                   "ops": [["run", 2 * IV - 1], ["checkpoint"],
                           ["run", IV + 1]]},
}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("jax_obs"), CASES)


@pytest.mark.parametrize("name", [n for n in CASES if n != "checkpoint"])
def test_ledger_matches_jax(jax_ref, name):
    sess, rec = play(CASES[name])
    assert_case(jax_ref / f"{name}.npz", sess, rec, name)
    tel = rec[max(rec)].telemetry
    assert tel.n_records == rec[max(rec)].steps
    assert tel.names == obs.ledger_metrics(sess.cfg)


def test_eager_and_chunked_ledgers_are_identical(jax_ref):
    """The eager steps and the chunks take the same snapshot: identical
    ledgers in the port, and both equal to the JAX session's."""
    eager, rec_e = play(CASES["opic_url-4-eager"])
    chunk, rec_c = play(CASES["opic_url-4"])
    te, tc = rec_e["run0"].telemetry, rec_c["run0"].telemetry
    np.testing.assert_array_equal(te.steps, tc.steps)
    np.testing.assert_array_equal(te.rows, tc.rows)
    with np.load(jax_ref / "opic_url-4-eager.npz") as z:
        assert_ledger(z["run0.ledger.steps"], z["run0.ledger.rows"], tc,
                      "chunked vs JAX eager")
    names = [e.name for e in chunk.tracer.events if e.ph == "X"]
    assert names.count("run_chunk") == 3
    assert [e.name for e in eager.tracer.events if e.ph == "X"].count(
        "step_dispatch") == 3


def test_dead_shard_lane_is_zeroed():
    _, rec = play(CASES["dead-backlink-4"])
    tel = rec["run2"].telemetry
    assert (tel.rows[:, DEAD] == 0).all()
    live = [s for s in range(4) if s != DEAD]
    assert (tel.col("alive")[:, live] == 1).all()
    assert (tel.col("frontier_depth")[:, live] > 0).all()


def test_outbox_column_counts_parked_urls():
    sess, rec = play(CASES["batched-opic-4"])
    tel = rec["run0"].telemetry
    at_dispatch = tel.per_interval()
    np.testing.assert_array_equal(at_dispatch.col("outbox_fill")[-1],
                                  sess.state.outbox_n.numpy())
    assert tel.metrics()["outbox_peak"] > 0


def test_jax_ledger_checkpoint_restores_in_port(jax_ref):
    """The JAX session's checkpoint (state and obs/ ledger) restores into
    the port, which then steps as JAX did: the restored ledger is JAX's,
    and the records after it and the final state equal JAX's."""
    case = CASES["checkpoint"]
    ckpt = jax_ref / "checkpoint.ckpt"
    sess, rec = play(case, ckpt_dir=ckpt)
    assert sess.t == 3 * IV
    assert_case(jax_ref / "checkpoint.npz", sess, rec, "checkpoint")
    with np.load(ckpt / "obs" / f"step_{2 * IV - 1:010d}" /
                 "arrays.npz") as z:
        saved_steps, saved_rows = z["steps"], z["rows"]
    steps, rows = sess.ledger.arrays()
    np.testing.assert_array_equal(steps[:len(saved_steps)], saved_steps)
    np.testing.assert_array_equal(rows[:len(saved_rows)], saved_rows)
    assert len(steps) == len(saved_steps) + IV + 1


def test_port_ledger_checkpoint_round_trips(tmp_path):
    """The port writes the ledger beside the state and reads it back; a
    checkpoint without one starts a fresh ledger."""
    cfg = scaled(webparf.reduced(), telemetry=True)
    sess = CrawlSession(cfg, device="cpu", n_shards=4)
    sess.run(IV + 1)
    sess.checkpoint(str(tmp_path / "a"))
    steps, rows = sess.ledger.arrays()
    other = CrawlSession(cfg, device="cpu", n_shards=4)
    other.restore(str(tmp_path / "a"))
    s2, r2 = other.ledger.arrays()
    np.testing.assert_array_equal(steps, s2)
    np.testing.assert_array_equal(rows, r2)
    plain = CrawlSession(scaled(cfg, telemetry=False), device="cpu",
                         n_shards=4)
    plain.run(IV)
    plain.checkpoint(str(tmp_path / "b"))
    other.restore(str(tmp_path / "b"))
    assert len(other.ledger) == 0 and other.t == IV


@pytest.mark.parametrize("over", [{}, {"ordering": "opic_url",
                                       "link_pop_bias": 1.0,
                                       "coordination": "batched",
                                       "comm_quota": 4}])
def test_telemetry_off_equals_on(monkeypatch, over):
    """The ledger only reads the state: a crawl with telemetry on (by the
    config or by REPRO_TELEMETRY=1) follows the untraced trajectory, and
    with it off the session has no ledger and no report."""
    cfg = scaled(webparf.reduced(), **over)
    states, reps = [], []
    for flag, env in ((False, None), (True, None), (False, "1")):
        if env is None:
            monkeypatch.delenv("REPRO_TELEMETRY", raising=False)
        else:
            monkeypatch.setenv("REPRO_TELEMETRY", env)
        sess = CrawlSession(scaled(cfg, telemetry=flag), device="cpu",
                            n_shards=4)
        reps.append(sess.run(3 * IV))
        states.append(state_to_numpy(sess.state))
        assert sess.telemetry == (flag or env == "1")
    assert reps[0].telemetry is None and reps[1].telemetry is not None
    for r, s in zip(reps[1:], states[1:]):
        np.testing.assert_array_equal(reps[0].urls, r.urls)
        for k in s:
            np.testing.assert_array_equal(states[0][k], s[k], err_msg=k)
    np.testing.assert_array_equal(reps[1].telemetry.rows,
                                  reps[2].telemetry.rows)


def test_chrome_trace_validates(tmp_path):
    """Spans, the fail and heal instants and the ledger counters export as
    a Chrome trace both validators accept, with the ledger embedded."""
    from repro.obs.trace import validate_chrome_trace as jax_validate
    cfg = scaled(webparf.reduced(), telemetry=True)
    sess = CrawlSession(cfg, device="cpu", n_shards=4)
    sess.run(IV)
    sess.inject_failure(1)
    sess.run(IV)
    sess.heal()
    rep = sess.run(IV + 1)
    tel = sess.telemetry_report()
    path = sess.tracer.write(str(tmp_path / "trace.json"), telemetry=tel)
    with open(path) as f:
        doc = json.load(f)
    assert obs.validate_chrome_trace(doc) == [] == jax_validate(doc)
    phases = {e["ph"] for e in doc["traceEvents"]}
    assert phases == {"X", "i", "C"}
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"run_chunk", "step_fetch", "inject_failure", "heal",
            "frontier_depth", "staging_fill"} <= names
    led = doc["otherData"]["ledger"]
    assert led["names"] == list(tel.names)
    assert len(led["steps"]) == tel.n_records == 3 * IV + 1
    lines = sess.tracer.write(str(tmp_path / "trace.jsonl"), telemetry=tel)
    with open(lines) as f:
        rows = [json.loads(x) for x in f]
    assert len(rows) == len(doc["traceEvents"]) + 1
    assert rep.telemetry.n_records == IV + 1
    assert "imbalance" in rep.telemetry.summary()
    assert obs.validate_chrome_trace({"traceEvents": [{"ph": "Q"}]})


def test_ledger_buffer():
    buf = obs.LedgerBuffer(("a", "b"), 2)
    assert buf.tail() == {} and len(buf) == 0
    buf.append(1, np.ones((2, 2)))
    buf.append_block([2, 3], np.arange(8.0).reshape(2, 2, 2))
    steps, rows = buf.arrays()
    np.testing.assert_array_equal(steps, [1, 2, 3])
    np.testing.assert_array_equal(buf.tail()["b"], [5.0, 7.0])
    with pytest.raises(ValueError, match="shape"):
        buf.append(4, np.ones((3, 2)))
    buf.clear()
    assert buf.arrays()[1].shape == (0, 2, 2)
