"""Shared harness of the port's crawl-parity tests: one JAX subprocess
runs a file's cases at ``webparf.reduced()`` and writes each case's
records to an ``.npz``; ``play`` replays a case in the port on the CPU and
``assert_case`` holds the two.

A case is ``{"over": config overrides, "shards": 1 or 4, "stages":
[["politeness", max_per_row] | ["revisit", age_steps]], "ops": [...]}``.
The operations both packages interpret the same way:

  ["run", steps]               CrawlSession.run (its records: urls,
                               per_step, stats per shard, comm, the
                               telemetry window and the rebalances)
  ["run_eager", steps]         the same with mode="eager"
  ["fail", shard]              inject_failure
  ["heal"]                     heal (records the healed state)
  ["checkpoint"]               checkpoint into <out>/<case>.ckpt

The JAX subprocess has 4 host devices; a 1-shard case runs on a mesh of
the first. Sessions are compiled once per (config, shards, stages) and
reset between cases.

Tolerances: every int, bool and uint32 leaf and output identical; f32
state leaves to 8 ulp (the port's row sums add in a fixed tree order,
XLA's CPU reductions in their own); total cash and the ledger's
``cash_mass`` to 1e-6 relative, every other ledger column identical.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

MAX_ULP = 8
CASH_RTOL = 1e-6

try:
    import torch
except ImportError:            # the port's tests skip without torch
    torch = None
else:
    # Six test workers and their JAX subprocesses and gloo worlds share
    # the machine's cores; the port's tests run small tensors, which gain
    # nothing from intra-op threads (a test process imports this module
    # while it collects, so every worker runs torch on one thread).
    torch.set_num_threads(1)


# the CPU priority of the port's helper processes (its JAX references and
# gloo ranks): below the test workers', so that the longest files of the
# run (the JAX package's own, which hold one worker for most of it) are
# not held up by them
HELPER_NICE = 10


def background():
    """Lower this process's CPU priority to ``HELPER_NICE`` (a helper
    process's first act)."""
    os.nice(HELPER_NICE)


def niced(script: str) -> str:
    """``script`` (a subprocess's ``-c`` program) lowering its own CPU
    priority as its first act (a ``preexec_fn`` would fork the
    multithreaded test process)."""
    return f"import os\nos.nice({HELPER_NICE})\n{script}"


def jax_env(out) -> dict:
    """The environment of a JAX subprocess that writes under ``out`` (a
    pytest temporary directory): the CPU platform; XLA's backend
    optimization level 0 (a reference runs each program a few times, so
    compiling is most of its time; the level changes no result the
    port's tests hold, which compare most outputs bit for bit); and one
    XLA compilation cache for every such subprocess of the test session
    (in the session's temporary root, shared by its workers; a file lock
    guards it), so a program that several files' references compile is
    compiled once. A script adds its host device count to
    ``XLA_FLAGS``."""
    out = Path(out).resolve()
    root = next((p for p in out.parents if p.name.startswith("pytest-")
                 and p.parent.name.startswith("pytest-of-")), out.parent)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_backend_optimization_level=0",
           "JAX_COMPILATION_CACHE_DIR": str(root / "jax_compilation_cache"),
           "JAX_COMPILATION_CACHE_MAX_SIZE": str(8 << 30),
           "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"}
    env.pop("REPRO_TELEMETRY", None)
    return env

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ.setdefault("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    sys.path.insert(0, "src")
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from repro.api import CrawlSession
    from repro.configs import webparf
    from repro.core import stages as ST
    from repro.launch.mesh import make_host_mesh

    out, cases = sys.argv[1], json.loads(sys.argv[2])
    meshes = {4: make_host_mesh(),
              1: Mesh(np.array(jax.devices()[:1]), ("data",))}
    assert meshes[4].shape["data"] == 4, meshes[4].shape

    def stages(spec):
        return [ST.make_politeness_stage(a) if kind == "politeness"
                else ST.make_revisit_stage(a) for kind, a in spec]

    def commit(sess):
        # a state placed as the step's outputs are: the step then compiles
        # once, not once for the fresh state and once for its own outputs
        specs = ST.state_specs(sess.axes)
        sess.state = jax.device_put(sess.state, jax.tree.map(
            lambda p: NamedSharding(sess.mesh, p), specs))
        return sess

    sessions = {}
    for name, case in cases.items():
        spec = case.get("stages", [])
        key = json.dumps([case["over"], case["shards"], spec],
                         sort_keys=True)
        if key in sessions:
            sess = sessions[key].reset()
        else:
            cfg = dataclasses.replace(webparf.reduced(), kernel_impl="ref",
                                      **case["over"])
            sess = sessions[key] = CrawlSession(
                cfg, meshes[case["shards"]], extra_stages=stages(spec))
        commit(sess)
        rec = {}
        for i, op in enumerate(case["ops"]):
            if op[0] in ("run", "run_eager"):
                rep = sess.run(op[1], mode="eager" if op[0] == "run_eager"
                               else "auto")
                rec[f"run{i}.urls"] = rep.urls
                rec[f"run{i}.per_step"] = rep.per_step
                for k, v in rep.stats_per_shard.items():
                    rec[f"run{i}.stats.{k}"] = np.asarray(v)
                rec[f"run{i}.comm"] = np.array(json.dumps(rep.comm))
                if rep.telemetry is not None:
                    rec[f"run{i}.ledger.steps"] = rep.telemetry.steps
                    rec[f"run{i}.ledger.rows"] = rep.telemetry.rows
                    rec[f"run{i}.ledger.metrics"] = np.array(json.dumps(
                        {k: v for k, v in rep.telemetry.metrics().items()
                         if not k.startswith(("wall_", "n_"))
                         or k in ("n_records", "n_shards")}))
                rec[f"run{i}.rebalances"] = np.array(json.dumps(
                    [e.asdict() for e in rep.rebalances]))
            elif op[0] == "fail":
                commit(sess.inject_failure(op[1]))
            elif op[0] == "heal":
                commit(sess.heal())
                for k, v in zip(ST.CrawlState._fields, sess.state):
                    rec[f"heal{i}.{k}"] = np.asarray(v)
            elif op[0] == "checkpoint":
                sess.checkpoint(os.path.join(out, name + ".ckpt"))
        for k, v in zip(ST.CrawlState._fields, sess.state):
            rec[f"final.{k}"] = np.asarray(v)
        np.savez(os.path.join(out, name + ".npz"), **rec)
        print("case", name, flush=True)
    print("jax cases: OK")
""")


def run_jax(out, cases, timeout=900, script=None):
    """Run every case in one JAX subprocess (``script``, JAX_SCRIPT by
    default, gets ``out`` and the cases as JSON); returns ``out``."""
    env = jax_env(out)
    r = subprocess.run([sys.executable, "-c", niced(script or JAX_SCRIPT),
                        str(out), json.dumps(cases)], capture_output=True,
                       text=True, timeout=timeout, cwd=".", env=env)
    if r.returncode != 0 or "jax cases: OK" not in r.stdout:
        raise AssertionError(f"STDOUT:\n{r.stdout[-3000:]}\n"
                             f"STDERR:\n{r.stderr[-3000:]}")
    return out


def port_stages(spec):
    from repro_torch.core import stages as ST
    return [ST.make_politeness_stage(a) if kind == "politeness"
            else ST.make_revisit_stage(a) for kind, a in spec]


def play(case, *, ckpt_dir=None):
    """Replay a case in the port on the CPU. With ``ckpt_dir`` the
    session first restores that checkpoint and runs only the operations
    after the case's ``checkpoint``. Returns (session, records)."""
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
    from repro_torch.core.stages import state_to_numpy
    cfg = scaled(webparf.reduced(), **case["over"])
    sess = CrawlSession(cfg, device="cpu", n_shards=case["shards"],
                        extra_stages=port_stages(case.get("stages", [])))
    ops = case["ops"]
    if ckpt_dir is not None:
        at = [op[0] for op in ops].index("checkpoint")
        sess.restore(str(ckpt_dir))
        ops = [["skip"]] * (at + 1) + ops[at + 1:]
    rec = {}
    for i, op in enumerate(ops):
        if op[0] in ("run", "run_eager"):
            rec[f"run{i}"] = sess.run(
                op[1], mode="eager" if op[0] == "run_eager" else "auto")
        elif op[0] == "fail":
            sess.inject_failure(op[1])
        elif op[0] == "heal":
            sess.heal()
            rec[f"heal{i}"] = state_to_numpy(sess.state)
    return sess, rec


def leaves(npz, prefix):
    from repro_torch.core.stages import CrawlState
    return {k: npz[f"{prefix}.{k}"] for k in CrawlState._fields}


def assert_states_close(want, got, label, *, valid_pri_only=False):
    """Every leaf of two states: identical, f32 leaves to MAX_ULP. With
    ``valid_pri_only`` f_pri is compared where f_valid holds: an invalid
    cell's priority is not part of the pop's contract (the JAX package's
    own pop implementations leave different values there)."""
    from repro_torch.core.stages import CrawlState
    for name in CrawlState._fields:
        a, b = want[name], got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, (label, name)
        if name == "f_pri" and valid_pri_only:
            np.testing.assert_array_equal(want["f_valid"], got["f_valid"])
            a, b = a[want["f_valid"]], b[got["f_valid"]]
        if a.dtype == np.float32:
            np.testing.assert_array_max_ulp(a, b, maxulp=MAX_ULP)
        else:
            np.testing.assert_array_equal(
                a, b, err_msg=f"{label}: CrawlState.{name} diverged")


def numpy_cash(leaf):
    """Total cash of numpy leaves: slot cash, the url lane, and what the
    staging buffers and the outbox carry."""
    os_ = leaf["order_state"].astype(np.float64)
    cash = float(os_[:, 0].sum() + os_[:, 2:].sum())
    for val, n in (("staging_val", "staging_n"), ("outbox_val", "outbox_n")):
        v = leaf[val].astype(np.float64)
        cash += sum(v[i, :k].sum() for i, k in enumerate(leaf[n]))
    return cash


def ledger_metrics(tel):
    """A telemetry window's flat metrics without the span timings."""
    return {k: v for k, v in tel.metrics().items()
            if not k.startswith(("wall_", "n_"))
            or k in ("n_records", "n_shards")}


def assert_ledger(want_steps, want_rows, tel, label):
    """A port telemetry window against JAX's: steps and every column
    identical but ``cash_mass``, held to CASH_RTOL."""
    np.testing.assert_array_equal(want_steps, tel.steps)
    assert want_rows.shape == tel.rows.shape, (label, tel.rows.shape)
    ci = tel.names.index("cash_mass")
    rest = np.arange(want_rows.shape[-1]) != ci
    np.testing.assert_array_equal(want_rows[..., rest], tel.rows[..., rest],
                                  err_msg=f"{label}: ledger columns")
    np.testing.assert_allclose(tel.rows[..., ci], want_rows[..., ci],
                               rtol=CASH_RTOL, atol=1e-6,
                               err_msg=f"{label}: cash_mass")


def assert_case(npz_path, sess, rec, label, *, valid_pri_only=False):
    """Every record of a replayed case against the JAX case's."""
    from repro_torch.core.stages import STATS, state_to_numpy
    from repro_torch.ordering.opic import total_cash
    with np.load(npz_path) as z:
        for key, val in rec.items():
            if key.startswith("run"):
                np.testing.assert_array_equal(z[f"{key}.urls"], val.urls)
                np.testing.assert_array_equal(z[f"{key}.per_step"],
                                              val.per_step)
                for s in STATS + ("fifo_rebase",):
                    np.testing.assert_array_equal(
                        z[f"{key}.stats.{s}"], val.stats_per_shard[s],
                        err_msg=f"{label} {key}: stats_per_shard[{s!r}]")
                assert json.loads(str(z[f"{key}.comm"])) == val.comm, label
                if f"{key}.ledger.rows" in z.files:
                    assert_ledger(z[f"{key}.ledger.steps"],
                                  z[f"{key}.ledger.rows"], val.telemetry,
                                  f"{label} {key}")
                    assert json.loads(str(z[f"{key}.ledger.metrics"])) == \
                        ledger_metrics(val.telemetry), label
                else:
                    assert val.telemetry is None, label
                assert json.loads(str(z[f"{key}.rebalances"])) == [
                    e.asdict() for e in val.rebalances], label
            elif key.startswith("heal"):
                assert_states_close(leaves(z, key), val, f"{label} {key}",
                                    valid_pri_only=valid_pri_only)
        want = leaves(z, "final")
    got = state_to_numpy(sess.state)
    assert_states_close(want, got, f"{label} final",
                        valid_pri_only=valid_pri_only)
    if sess.cfg.ordering in ("opic", "opic_url"):
        np.testing.assert_allclose(total_cash(sess.state), numpy_cash(want),
                                   rtol=CASH_RTOL)
