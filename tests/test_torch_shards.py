"""The partitioned parallel crawl: the port's 4-shard crawl, batched along
the state's leading axis, against the JAX package's ``shard_map`` over 4
host devices.

One JAX subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``)
runs every case at ``webparf.reduced()`` and writes each case's states and
reports to an ``.npz``; the port replays each case on the CPU. A case is a
list of operations both packages interpret the same way (``play``): runs,
a failure injected before a given step, a heal, a checkpoint.

Tolerances: every int, bool and uint32 leaf and output must be identical.
f32 leaves (order_state, staging_val) are held to 8 ulp, as in
``tests/test_torch_opic_session.py`` (the port's row sums add in a fixed
tree order, XLA's CPU reduction in its own); total cash to 1e-6 relative.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_play import jax_env, niced  # noqa: E402

from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs import webparf  # noqa: E402
from repro_torch.configs.base import scaled  # noqa: E402
from repro_torch.core import crawler as CR  # noqa: E402
from repro_torch.core.stages import CrawlState, SIDX, STATS  # noqa: E402
from repro_torch.core.stages import state_to_numpy  # noqa: E402
from repro_torch.ordering.opic import total_cash  # noqa: E402

N_SHARDS = 4
MAX_ULP = 8
CASH_RTOL = 1e-6
IV = webparf.reduced().dispatch_interval           # 4 steps a dispatch
TIE = 4.0 * (1 << 20)          # the priority of bucket 4, arrival 0

# name -> (config overrides, operations). Each case runs at least three
# dispatch intervals.
CASES = {
    "backlink-webparf": ({}, [["run", 3 * IV]]),
    "backlink-url_hash": ({"partitioning": "url_hash"}, [["run", 3 * IV]]),
    "backlink-random": ({"partitioning": "random"}, [["run", 3 * IV]]),
    "opic": ({"ordering": "opic", "link_pop_bias": 1.0}, [["run", 3 * IV]]),
    "opic_url-fused": ({"ordering": "opic_url", "link_pop_bias": 1.0},
                       [["run", 3 * IV]]),
    "opic_url-unfused": ({"ordering": "opic_url", "link_pop_bias": 1.0,
                          "fused_dispatch": False}, [["run", 3 * IV]]),
    # 8 rows a shard pop 1 URL each against a budget of 4 (url_hash fills
    # every row, where webparf leaves the spare half empty): the per-shard
    # budget bites; before step IV every queued URL gets one priority, so
    # that all of a shard's pops tie at its threshold
    "budget": ({"n_domains": 16, "fetch_batch": 4,
                "partitioning": "url_hash"},
               [["run", IV], ["tie_before", IV], ["run", 2 * IV]]),
    # shard 1 dies mid-interval with values staged: at the dispatch they
    # refund through the sender-side clamp (url_hash fetches pages whose
    # domain lives on another shard)
    "clamp-refund": ({"ordering": "opic", "partitioning": "url_hash",
                      "link_pop_bias": 1.0},
                     [["run", IV], ["fail_before", IV + 2, 1],
                      ["run", 2 * IV]]),
    "heal-backlink": ({}, [["run", IV], ["fail", 1], ["run", IV],
                           ["heal"], ["run", 2 * IV]]),
    "heal-opic_url": ({"ordering": "opic_url", "link_pop_bias": 1.0},
                      [["run", IV], ["fail", 1], ["run", IV], ["heal"],
                       ["run", 2 * IV]]),
    # a JAX checkpoint taken mid-interval, restored into the port, and
    # stepped through a dispatch in each package
    "checkpoint": ({"ordering": "opic_url", "link_pop_bias": 1.0},
                   [["run", 2 * IV - 1], ["checkpoint"], ["run", 1]]),
}

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ.setdefault("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    sys.path.insert(0, "src")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding
    from repro.api import CrawlSession
    from repro.configs import webparf
    from repro.core import crawler as CR
    from repro.core import stages as ST
    from repro.launch.mesh import make_host_mesh

    out, cases, TIE = sys.argv[1], json.loads(sys.argv[2]), float(sys.argv[3])
    mesh = make_host_mesh()
    assert mesh.shape["data"] == 4, mesh.shape
    def commit(sess):
        # a state placed as the step's outputs are: the step then compiles
        # once, not once for the fresh state and once for its own outputs
        sess.state = jax.device_put(sess.state, jax.tree.map(
            lambda p: NamedSharding(sess.mesh, p), ST.state_specs(sess.axes)))

    sessions = {}            # one compiled session per config, reset
    for name, (over, ops) in cases.items():
        key = json.dumps(over, sort_keys=True)
        if key in sessions:
            sess = sessions[key].reset()
        else:
            cfg = dataclasses.replace(webparf.reduced(), kernel_impl="ref",
                                      **over)
            sess = sessions[key] = CrawlSession(cfg, mesh)
        commit(sess)
        rec, events = {}, {}
        for i, op in enumerate(ops):
            if op[0] == "run":
                rep = sess.run(op[1], events=events)
                events = {}
                rec[f"run{i}.urls"] = rep.urls
                rec[f"run{i}.per_step"] = rep.per_step
                for k, v in rep.stats_per_shard.items():
                    rec[f"run{i}.stats.{k}"] = np.asarray(v)
            elif op[0] == "fail_before":
                events = {op[1]: lambda s, d=op[2]: CR.mark_dead(s, [d])}
            elif op[0] == "tie_before":
                events = {op[1]: lambda s: s._replace(f_pri=jnp.where(
                    s.f_valid, jnp.float32(TIE), s.f_pri))}
            elif op[0] == "fail":
                sess.inject_failure(op[1])
            elif op[0] == "heal":
                sess.heal()
                commit(sess)
                for k, v in zip(ST.CrawlState._fields, sess.state):
                    rec[f"heal{i}.{k}"] = np.asarray(v)
            elif op[0] == "checkpoint":
                sess.checkpoint(os.path.join(out, name + ".ckpt"))
        for k, v in zip(ST.CrawlState._fields, sess.state):
            rec[f"final.{k}"] = np.asarray(v)
        np.savez(os.path.join(out, name + ".npz"), **rec)
        print("case", name, flush=True)
    print("jax shards: OK")
""")


def port_cfg(over):
    return scaled(webparf.reduced(), **over)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """Every case's JAX reference, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_shards")
    env = jax_env(out)
    r = subprocess.run([sys.executable, "-c", niced(JAX_SCRIPT), str(out),
                        json.dumps(CASES), str(TIE)], capture_output=True, text=True,
                       timeout=600, cwd=".", env=env)
    if r.returncode != 0 or "jax shards: OK" not in r.stdout:
        raise AssertionError(f"STDOUT:\n{r.stdout[-3000:]}\n"
                             f"STDERR:\n{r.stderr[-3000:]}")
    return out


def play(name, *, ckpt_dir=None, until=None):
    """Replay a case in the port on the CPU. A ``checkpoint`` operation
    restores the JAX package's checkpoint (``ckpt_dir``) into a fresh
    session, which then runs the operations after it. ``until`` stops the
    replay before that step. Returns (session, records)."""
    over, ops = CASES[name]
    cfg = port_cfg(over)
    sess = CrawlSession(cfg, device="cpu", n_shards=N_SHARDS)
    rec, events = {}, {}
    if ckpt_dir is not None:
        at = [op[0] for op in ops].index("checkpoint")
        sess.restore(str(ckpt_dir))
        ops = [["skip"]] * (at + 1) + ops[at + 1:]
    for i, op in enumerate(ops):
        if op[0] == "run":
            steps = op[1] if until is None else min(op[1], until - sess.t)
            rep = sess.run(steps, events=events)
            events = {}
            rec[f"run{i}"] = rep
            if until is not None and sess.t >= until:
                break
        elif op[0] == "fail_before":
            events = {op[1]: lambda s, d=op[2]: CR.mark_dead(s, [d])}
        elif op[0] == "tie_before":
            events = {op[1]: lambda s: s._replace(f_pri=torch.where(
                s.f_valid, torch.tensor(TIE), s.f_pri))}
        elif op[0] == "fail":
            sess.inject_failure(op[1])
        elif op[0] == "heal":
            rec[f"before{i}"] = state_to_numpy(sess.state)
            sess.heal()
            rec[f"heal{i}"] = state_to_numpy(sess.state)
    return sess, rec


def leaves(npz, prefix):
    return {k: npz[f"{prefix}.{k}"] for k in CrawlState._fields}


def assert_states_close(want, got, label):
    for name in CrawlState._fields:
        a, b = want[name], got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, (label, name)
        if a.dtype == np.float32:
            np.testing.assert_array_max_ulp(a, b, maxulp=MAX_ULP)
        else:
            np.testing.assert_array_equal(
                a, b, err_msg=f"{label}: CrawlState.{name} diverged")


def numpy_cash(leaf):
    """total_cash of numpy leaves (the port's own accounting)."""
    os_ = leaf["order_state"].astype(np.float64)
    sv = leaf["staging_val"].astype(np.float64)
    return float(os_[:, 0].sum() + os_[:, 2:].sum() + sum(
        sv[i, :n].sum() for i, n in enumerate(leaf["staging_n"])))


def assert_case(jax_ref, name, sess, rec):
    with np.load(jax_ref / f"{name}.npz") as z:
        for key, rep in rec.items():
            if key.startswith("run"):
                np.testing.assert_array_equal(z[f"{key}.urls"], rep.urls)
                np.testing.assert_array_equal(z[f"{key}.per_step"],
                                              rep.per_step)
                for s in STATS + ("fifo_rebase",):
                    np.testing.assert_array_equal(
                        z[f"{key}.stats.{s}"], rep.stats_per_shard[s],
                        err_msg=f"{name} {key}: stats_per_shard[{s!r}]")
            elif key.startswith("heal"):
                assert_states_close(leaves(z, key), rec[key],
                                    f"{name} {key}")
        want = leaves(z, "final")
    got = state_to_numpy(sess.state)
    assert_states_close(want, got, f"{name} final")
    if sess.cfg.ordering != "backlink":
        np.testing.assert_allclose(total_cash(sess.state), numpy_cash(want),
                                   rtol=CASH_RTOL)


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n != "checkpoint"])
def test_four_shard_crawl_matches_jax(jax_ref, name):
    sess, rec = play(name)
    assert_case(jax_ref, name, sess, rec)
    stats = sess.state.stats.numpy()
    assert (stats[:, SIDX["fetched"]] > 0).all()      # every shard fetched
    assert (stats[:, SIDX["dispatch_recv"]] > 0).all()
    # each shard, dead or alive, counts one round a dispatch
    assert (stats[:, SIDX["dispatch_rounds"]] == sess.t // IV).all()


def test_budget_bites_with_ties():
    """In the budget case each shard pops 8 URLs a step against a budget
    of 4: before the tie no step fetches more than 4 a shard, and the tied
    step admits every tied pop (the ``>=`` of both packages)."""
    cfg = port_cfg(CASES["budget"][0])
    assert cfg.n_slots // N_SHARDS > cfg.fetch_batch      # k_row 1
    sess, rec = play("budget")
    budget = N_SHARDS * cfg.fetch_batch
    assert (rec["run0"].per_step <= budget).all(), rec["run0"].per_step
    assert rec["run2"].per_step[0] > budget, rec["run2"].per_step


def test_clamp_refund_fires():
    """Just before the dispatch after shard 1 dies, shard 1 holds staged
    values whose source page's domain lives on another shard: at the
    dispatch they refund through the sender-side clamp to shard 1's edge
    rows (the JAX parity of that dispatch is the clamp-refund case)."""
    sess, _ = play("clamp-refund", until=2 * IV - 1)
    st = sess.state
    assert not bool(st.shard_alive[1])
    r_local = sess.cfg.n_slots // N_SHARDS
    n1 = int(st.staging_n[1])
    src = st.staging_src[1, :n1].to(torch.int64)
    own_shard = st.slot_of_domain.to(torch.int64)[src] // r_local
    val = st.staging_val[1, :n1]
    foreign = (own_shard != 1) & (val > 0)
    assert (sess.t + 1) % IV == 0                # the next step dispatches
    assert n1 > 0 and bool(foreign.any()), (n1, own_shard)


@pytest.mark.parametrize("name", ["heal-backlink", "heal-opic_url"])
def test_heal_loses_no_url(name):
    """Every URL queued on the dead shard before the heal is queued on a
    survivor after it, and under opic_url the cash balances."""
    sess, rec = play(name)
    at = next(k for k in rec if k.startswith("heal"))
    before, after = rec["before" + at[4:]], rec[at]
    r_local = sess.cfg.n_slots // N_SHARDS
    dead = slice(r_local, 2 * r_local)
    queued = set(before["f_url"][dead][before["f_valid"][dead]].tolist())
    live = np.ones(sess.cfg.n_slots, bool)
    live[dead] = False
    survivors = set(after["f_url"][live][after["f_valid"][live]].tolist())
    assert queued and queued <= survivors
    if sess.cfg.ordering == "opic_url":
        np.testing.assert_allclose(numpy_cash(after), numpy_cash(before),
                                   rtol=CASH_RTOL)


def test_hand_rolled_spmd_crawler_matches_session():
    """``make_spmd_crawler``'s init and step functions, driven by hand
    through a failure and a heal, give the session's state (the JAX
    package's tests/test_session.py does the same for its crawler)."""
    from repro_torch.train.fault import heal_crawler
    sess, _ = play("heal-backlink")
    cfg = sess.cfg
    init, step_f, step_d = CR.make_spmd_crawler(cfg, n_shards=N_SHARDS,
                                                device="cpu")
    state = init()
    for t in range(4 * IV):
        if t == IV:
            state = CR.mark_dead(state, [1])
        if t == 2 * IV:
            state = heal_crawler(state, cfg, [1], N_SHARDS)
        state, _ = (step_d if (t + 1) % IV == 0 else step_f)(state)
    for name, a, b in zip(CrawlState._fields, sess.state, state):
        assert torch.equal(a, b), name


def test_checkpoint_from_jax_steps_identically(jax_ref):
    sess, rec = play("checkpoint", ckpt_dir=jax_ref / "checkpoint.ckpt")
    assert sess.t == 2 * IV
    assert_case(jax_ref, "checkpoint", sess, rec)


def test_session_needs_a_card_without_device():
    cfg = webparf.reduced()
    if torch.cuda.is_available():
        assert CrawlSession(cfg, n_shards=4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            CrawlSession(cfg, n_shards=4)


def test_shard_count_must_divide(tmp_path):
    """3 shards do not split 8 domains; a 2-shard checkpoint does not
    restore into a 4-shard session."""
    with pytest.raises(ValueError, match="split"):
        CrawlSession(webparf.reduced(), device="cpu", n_shards=3)
    sess = CrawlSession(webparf.reduced(), device="cpu", n_shards=2)
    sess.run(IV)
    sess.checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="shards"):
        CrawlSession(webparf.reduced(), device="cpu",
                     n_shards=4).restore(str(tmp_path))
