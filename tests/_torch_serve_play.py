"""Shared harness of the port's serve-parity tests: one JAX subprocess
runs a file's ``ServeSession`` cases at ``webparf.reduced()`` and writes
each case's records to an ``.npz``; ``play`` replays a case in the port on
the CPU (or another device) and ``assert_run`` / ``assert_index`` hold
the two.

A case is ``{"shards": 1 or 4, "serve": ServeSession keywords (qps and
load_seed go to the QueryLoad), "ops": [...]}``:

  ["run", steps, recall]       ServeSession.run (its records: the served
                               answers, lags, arrivals, recall, index
                               stats, the crawl's urls and per-step counts)
  ["fail", shard]              inject_failure
  ["heal"]                     heal
  ["checkpoint"]               checkpoint into <out>/<case>.ckpt

Tolerances: the index leaves, the crawl state, lags, arrivals, recall and
the index stats identical; the scores within SCORE_ULP; the served URLs
identical where no two scores are within 2 * SCORE_ULP of each other,
and equal as sets within such a run of near-equal scores (the two
packages may order a near-tie either way). XLA's CPU ``log1p`` differs
from the correctly rounded one by up to 2 ulp (on 27% of idf inputs), and
the port's scores are correctly rounded: SCORE_ULP = 2 is the largest
difference measured over 240 queries x 2,048 random pages (vocab 512 and
4096, doc_len 16 and 64) and every case here.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np

from _torch_play import jax_env, niced

SCORE_ULP = 2

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ.setdefault("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    sys.path.insert(0, "src")
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import webparf
    from repro.core import stages as ST
    from repro.core.index import Index
    from repro.launch.mesh import make_host_mesh
    from repro.serve import QueryLoad, ServeSession

    # the sessions' initial state, jitted: the same leaves as the eager
    # build (checked at reduced() with 1 and 4 shards) in a quarter of
    # its compile time
    from repro.core import crawler as CR
    CR.init_state = jax.jit(ST.init_state, static_argnums=(0, 1))

    out, cases = sys.argv[1], json.loads(sys.argv[2])
    meshes = {4: make_host_mesh(),
              1: Mesh(np.array(jax.devices()[:1]), ("data",))}
    cfg = dataclasses.replace(webparf.reduced(), kernel_impl="ref")

    def commit(sess):
        c = sess.crawl
        c.state = jax.device_put(c.state, jax.tree.map(
            lambda p: NamedSharding(c.mesh, p), ST.state_specs(c.axes)))
        return sess

    for name, case in cases.items():
        kw = dict(case["serve"])
        load = QueryLoad(cfg, qps=kw.pop("qps"), seed=kw.pop("load_seed"))
        sess = commit(ServeSession(cfg, meshes[case["shards"]], load=load,
                                   **kw))
        rec = {}
        for i, op in enumerate(case["ops"]):
            if op[0] == "run":
                r = sess.run(op[1], recall=op[2])
                for f in ("top_urls", "top_scores", "lag_steps",
                          "arrival_step"):
                    rec[f"run{i}.{f}"] = getattr(r, f)
                rec[f"run{i}.recall"] = np.float64(
                    np.nan if r.recall_at_k is None else r.recall_at_k)
                rec[f"run{i}.index"] = np.array(json.dumps(r.index))
                rec[f"run{i}.urls"] = r.crawl.urls
                rec[f"run{i}.per_step"] = r.crawl.per_step
            elif op[0] == "fail":
                commit(sess.inject_failure(op[1]))
            elif op[0] == "heal":
                commit(sess.heal())
            elif op[0] == "checkpoint":
                sess.checkpoint(os.path.join(out, name + ".ckpt"))
        for k, v in zip(Index._fields, sess.index):
            rec[f"index.{k}"] = np.asarray(v)
        for k, v in zip(ST.CrawlState._fields, sess.crawl.state):
            rec[f"state.{k}"] = np.asarray(v)
        np.savez(os.path.join(out, name + ".npz"), **rec)
        print("case", name, flush=True)
    print("jax cases: OK")
""")


def run_jax(out, cases, timeout=600):
    """Run every case in one JAX subprocess; returns ``out``."""
    env = jax_env(out)
    r = subprocess.run([sys.executable, "-c", niced(JAX_SCRIPT), str(out),
                        json.dumps(cases)], capture_output=True, text=True,
                       timeout=timeout, cwd=".", env=env)
    if r.returncode != 0 or "jax cases: OK" not in r.stdout:
        raise AssertionError(f"STDOUT:\n{r.stdout[-3000:]}\n"
                             f"STDERR:\n{r.stderr[-3000:]}")
    return out


def make_session(case, device="cpu"):
    from repro_torch.configs import webparf
    from repro_torch.serve import QueryLoad, ServeSession
    cfg = webparf.reduced()
    kw = dict(case["serve"])
    load = QueryLoad(cfg, qps=kw.pop("qps"), seed=kw.pop("load_seed"))
    return ServeSession(cfg, device, n_shards=case["shards"], load=load,
                        **kw)


def play(case, *, device="cpu", ckpt_dir=None):
    """Replay a case in the port. With ``ckpt_dir`` the session first
    restores that checkpoint and runs only the operations after the
    case's ``checkpoint``. Returns (session, {op index: ServeReport})."""
    sess = make_session(case, device)
    ops = case["ops"]
    if ckpt_dir is not None:
        at = [op[0] for op in ops].index("checkpoint")
        sess.restore(str(ckpt_dir))
        ops = [["skip"]] * (at + 1) + ops[at + 1:]
    rec = {}
    for i, op in enumerate(ops):
        if op[0] == "run":
            rec[i] = sess.run(op[1], recall=op[2])
        elif op[0] == "fail":
            sess.inject_failure(op[1])
        elif op[0] == "heal":
            sess.heal()
    return sess, rec


def ulps(a, b):
    """|a - b| in f32 ulps, elementwise (finite values of one sign)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def assert_served(want_u, want_s, got_u, got_s, label):
    """Served answers: scores within SCORE_ULP (the same -inf pads), URLs
    in the same order outside runs of near-equal scores and the same set
    inside one. A run that reaches the last of k ranks, in a row of k
    finite scores, may hold a different document at the cut: there only
    its scores are held."""
    assert want_u.shape == got_u.shape, (label, want_u.shape, got_u.shape)
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(fin, np.isfinite(got_s), err_msg=label)
    assert ulps(want_s[fin], got_s[fin]).max(initial=0) <= SCORE_ULP, label
    np.testing.assert_array_equal(want_u[~fin], got_u[~fin], err_msg=label)
    for r in range(want_u.shape[0]):
        k = int(fin[r].sum())
        lo = 0
        while lo < k:
            hi = lo + 1
            while hi < k and ulps(want_s[r, hi - 1:hi],
                                  want_s[r, hi:hi + 1])[0] <= 2 * SCORE_ULP:
                hi += 1
            a, b = want_u[r, lo:hi], got_u[r, lo:hi]
            if hi < want_u.shape[1] or k < want_u.shape[1]:
                assert sorted(a) == sorted(b), (label, r, a, b)
            lo = hi


def assert_index(npz, prefix, index, label):
    from repro_torch.core.index import Index
    for k, v in zip(Index._fields, index):
        got = v.cpu().numpy()
        want = npz[f"{prefix}.{k}"]
        if k == "doc_url":
            want = want.astype(np.int64)
        np.testing.assert_array_equal(want, got,
                                      err_msg=f"{label}: Index.{k}")


def assert_run(npz, key, rep, label):
    """One ServeReport against the JAX run's records."""
    assert_served(npz[f"{key}.top_urls"], npz[f"{key}.top_scores"],
                  rep.top_urls, rep.top_scores, f"{label} {key}")
    for f in ("lag_steps", "arrival_step"):
        np.testing.assert_array_equal(npz[f"{key}.{f}"], getattr(rep, f),
                                      err_msg=f"{label} {key}: {f}")
    want = float(npz[f"{key}.recall"])
    assert (rep.recall_at_k is None) == np.isnan(want), label
    if rep.recall_at_k is not None:
        assert rep.recall_at_k == want, (label, key, rep.recall_at_k, want)
    assert json.loads(str(npz[f"{key}.index"])) == rep.index, label
    np.testing.assert_array_equal(npz[f"{key}.urls"], rep.crawl.urls)
    np.testing.assert_array_equal(npz[f"{key}.per_step"], rep.crawl.per_step)
