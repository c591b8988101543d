"""The crawl API's remaining surface in the port, against the JAX
package: ``CrawlSession``'s ``score_fn``, ``stages`` and
``dispatch_stage`` keywords (as ``tests/test_ordering.py`` holds them in
JAX), ``make_learned_ordering``, the ordering-quality metrics,
``dedup.fp_rate``, the crawl CLI's report and ``trace_report``. The JAX
runs share one 4-device subprocess; the 1-shard sessions run on a mesh of
its first device.

Tolerances: every crawl output and state leaf identical (f32 leaves to
``_torch_play.MAX_ULP``); the learned scorer's scores within 2 ulp with
equal priority buckets (XLA's CPU ``logistic`` and torch's ``sigmoid``
differ by up to 2 ulp: ROADMAP Queue 3); ``fp_rate`` within 2 ulp; the
CLI's lines identical but for its wall-clock figures."""
import json
import re
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dedup as JDD  # noqa: E402
from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs import webparf  # noqa: E402
from repro_torch.configs.base import scaled  # noqa: E402
from repro_torch.core import dedup as TDD  # noqa: E402
from repro_torch.core import frontier as TF  # noqa: E402
from repro_torch.core import ranker  # noqa: E402
from repro_torch.core import stages as ST  # noqa: E402
from repro_torch.core.stages import state_to_numpy  # noqa: E402
from _torch_play import assert_states_close, leaves, run_jax  # noqa: E402

STEPS = 8
CLI = ["--steps", "16", "--domains", "16", "--capacity", "128",
       "--fetch-batch", "16"]
# the learned model both packages score with: a linear probe over the 8
# url_features and a logistic
LEARNED_W = [1.5, 0.6, -0.2, 0.3, 0.1, -0.1, 0.05, 0.2]
LEARNED_B = -0.8

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ.setdefault("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=4"
    import contextlib, dataclasses, io, json, sys
    sys.path.insert(0, "src")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from repro.api import CrawlSession
    from repro.configs import webparf
    from repro.core import crawler as CR
    from repro.core import ranker
    from repro.core import stages as ST
    from repro.launch import crawl as cli
    from repro.ordering import make_learned_ordering, register_ordering

    # the initial state jitted: the same leaves as the eager build, in a
    # quarter of its compile time
    CR.init_state = jax.jit(ST.init_state, static_argnums=(0, 1))
    out, spec = sys.argv[1], json.loads(sys.argv[2])
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    w = jnp.asarray(spec["w"], jnp.float32)
    register_ordering(make_learned_ordering(
        lambda p, f: jax.nn.sigmoid(f @ p + spec["b"]), w,
        name="learned_test"))

    def commit(sess):
        sess.state = jax.device_put(sess.state, jax.tree.map(
            lambda p: NamedSharding(sess.mesh, p),
            ST.state_specs(sess.axes)))
        return sess

    for name in ("backlink", "learned_test"):
        cfg = dataclasses.replace(webparf.reduced(), kernel_impl="ref",
                                  ordering=name)
        sess = commit(CrawlSession(cfg, mesh))
        rep = sess.run(spec["steps"])
        rec = {"urls": rep.urls, "per_step": rep.per_step,
               "quality": np.array(json.dumps(rep.ordering_quality))}
        for k, v in zip(ST.CrawlState._fields, sess.state):
            rec[f"final.{k}"] = np.asarray(v)
        np.savez(os.path.join(out, name + ".npz"), **rec)
    cfg = webparf.reduced()
    urls = jnp.asarray(np.random.default_rng(0).integers(
        0, 1 << cfg.url_space_log2, 4096).astype(np.uint32))
    scorer = ranker.make_learned_scorer(
        lambda p, f: jax.nn.sigmoid(f @ p + spec["b"]), w)
    np.save(os.path.join(out, "learned_scores.npy"),
            np.asarray(jax.jit(lambda u: scorer(u, cfg))(urls)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(spec["cli"] + ["--trace-out",
                                os.path.join(out, "jax.trace.json")])
    with open(os.path.join(out, "cli.txt"), "w") as f:
        f.write(buf.getvalue())
    print("jax cases: OK")
""")


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    spec = {"w": LEARNED_W, "b": LEARNED_B, "steps": STEPS, "cli": CLI}
    return run_jax(tmp_path_factory.mktemp("jax_api"), spec,
                   script=JAX_SCRIPT)


def _run(**kw):
    cfg = scaled(webparf.reduced(), **kw.pop("over", {}))
    sess = CrawlSession(cfg, device="cpu", **kw)
    return sess, sess.run(STEPS)


def _assert_same_crawl(a, b, label):
    (sa, ra), (sb, rb) = a, b
    np.testing.assert_array_equal(ra.urls, rb.urls, err_msg=label)
    np.testing.assert_array_equal(ra.per_step, rb.per_step, err_msg=label)
    assert ra.stats == rb.stats, label
    na, nb = state_to_numpy(sa.state), state_to_numpy(sb.state)
    for k in na:
        np.testing.assert_array_equal(na[k], nb[k], err_msg=f"{label}: {k}")


def _assert_matches_jax(npz_path, sess, rep, label):
    with np.load(npz_path) as z:
        np.testing.assert_array_equal(z["urls"], rep.urls, err_msg=label)
        np.testing.assert_array_equal(z["per_step"], rep.per_step)
        assert_states_close(leaves(z, "final"), state_to_numpy(sess.state),
                            label)
        return json.loads(str(z["quality"]))


def test_score_fn_override_equals_default_and_jax(jax_out):
    """``score_fn=ranker.score_urls`` is the default backlink ordering,
    in every leaf, in the port and against JAX's default run."""
    default = _run()
    legacy = _run(score_fn=ranker.score_urls)
    _assert_same_crawl(default, legacy, "score_fn override")
    _assert_matches_jax(jax_out / "backlink.npz", *legacy, "score_fn")


@pytest.mark.parametrize("ordering", ["backlink", "opic"])
def test_hand_built_stages_equal_assembled_pipeline(ordering):
    """``stages=`` replaces the pipeline as given: the assembled one
    written out by hand (a stateful ordering's update stage included)
    crawls the same, and ``stages`` with ``extra_stages`` is refused."""
    from repro_torch.ordering import get_ordering
    over = dict(ordering=ordering)
    upd = get_ordering(ordering).update_stage
    pipeline = [ST.allocate, ST.fetch_analyze,
                *([] if upd is None else [upd]), ST.extract_stage]
    _assert_same_crawl(_run(over=over), _run(over=over, stages=pipeline),
                       f"stages {ordering}")
    # a pipeline without extract never queues an outlink
    _, rep = _run(over=over, stages=[ST.allocate, ST.fetch_analyze])
    assert rep.stats["discovered"] == 0 and rep.fetched > 0
    with pytest.raises(ValueError, match="either"):
        CrawlSession(webparf.reduced(), device="cpu", stages=pipeline,
                     extra_stages=[ST.make_politeness_stage(1)])
    with pytest.raises(ValueError, match="at least one"):
        CrawlSession(webparf.reduced(), device="cpu", stages=[])


def test_third_party_dispatch_stage_runs_on_dispatch_steps_only():
    calls = []

    def dispatch(ctx, state, carry):
        calls.append(int(state.step))
        return ST.dispatch_exchange(ctx, state, carry)

    default = _run()
    mine = _run(dispatch_stage=dispatch)
    _assert_same_crawl(default, mine, "dispatch_stage")
    iv = webparf.reduced().dispatch_interval
    assert calls == [t for t in range(STEPS) if (t + 1) % iv == 0]
    # a dispatch stage that ships nothing: no exchange rounds
    _, rep = _run(dispatch_stage=lambda ctx, st, c: (st, c, {}))
    assert rep.stats["dispatch_rounds"] == 0 and rep.fetched > 0


def _port_apply(p, f):
    return torch.sigmoid(f @ p + LEARNED_B)


def test_learned_ordering_selected_by_name_matches_jax(jax_out):
    from repro_torch.ordering import (get_ordering, make_learned_ordering,
                                      orderings, register_ordering)
    w = torch.tensor(LEARNED_W, dtype=torch.float32)
    if "learned_test" not in orderings():
        register_ordering(make_learned_ordering(_port_apply, w,
                                                name="learned_test"))
    pol = get_ordering("learned_test")
    assert not pol.stateful and pol.update_stage is None
    sess, rep = _run(over=dict(ordering="learned_test"))
    _assert_matches_jax(jax_out / "learned_test.npz", sess, rep, "learned")
    # its scores: within 2 ulp of JAX's, in the same priority buckets
    cfg = webparf.reduced()
    urls = np.random.default_rng(0).integers(
        0, 1 << cfg.url_space_log2, 4096).astype(np.int64)
    got = ranker.make_learned_scorer(_port_apply, w)(
        torch.from_numpy(urls), cfg)
    want = np.load(jax_out / "learned_scores.npy")
    np.testing.assert_array_max_ulp(want, got.numpy(), maxulp=2)
    zero = torch.zeros(len(urls), dtype=torch.int32)
    np.testing.assert_array_equal(
        TF.encode_priority(torch.from_numpy(want), zero,
                           cfg.n_priority_buckets).numpy(),
        TF.encode_priority(got, zero, cfg.n_priority_buckets).numpy())


def test_ordering_quality_matches_jax(jax_out):
    from repro.ordering import quality as JQ
    from repro_torch.ordering import quality as TQ
    sess, rep = _run()
    want = _assert_matches_jax(jax_out / "backlink.npz", sess, rep,
                               "quality")
    assert rep.ordering_quality == want
    cfg = webparf.reduced()
    np.testing.assert_array_equal(
        JQ.coverage_curve(rep.urls, rep.per_step, cfg),
        TQ.coverage_curve(rep.urls, rep.per_step, cfg))
    half = rep.urls[: len(rep.urls) // 2]
    ref_j = JQ.pooled_hot_set([rep.urls, half[::-1]], cfg)
    ref_t = TQ.pooled_hot_set([rep.urls, half[::-1]], cfg)
    np.testing.assert_array_equal(ref_j, ref_t)
    assert len(ref_t) > 0
    assert TQ.hot_page_recall(half, cfg, ref_t) == \
        JQ.hot_page_recall(half, cfg, ref_j)
    assert TQ.ordering_quality(np.array([], np.uint32), np.zeros(0), cfg) \
        == JQ.ordering_quality(np.array([], np.uint32), np.zeros(0), cfg)


def test_fp_rate_matches_jax():
    n = np.array([0, 1, 7, 100, 5000, 60000, 2 ** 20], np.int32)
    for bits_log2, k in ((16, 4), (24, 4), (10, 3)):
        want = np.asarray(jax.jit(
            lambda x: JDD.fp_rate(JDD.Bloom(None, bits_log2), x, k))(
                jnp.asarray(n)))
        got = TDD.fp_rate(TDD.Bloom(None, bits_log2), torch.from_numpy(n),
                          k).numpy()
        np.testing.assert_array_max_ulp(want, got, maxulp=2)


WALL = re.compile(r"^\d+ pages in [\d.]+s \(\d+ pages/s simulated\)$")


def _cli_lines(text):
    """The CLI's report without its wall-clock figures: the throughput
    line's times and the span table's are masked, and the trace line
    keeps its event count (it names each package's reporter)."""
    lines, spans = [], False
    for line in text.splitlines():
        if WALL.match(line):
            line = line.split(" in ")[0]
        elif line.startswith("== spans =="):
            spans = True
        elif spans and line.strip():
            line = " ".join(line.split()[:3])       # category, span, count
        elif spans:
            spans = False
        if line.startswith("trace written:"):
            line = line.split(" events;")[0]
        lines.append(line)
    return lines


def test_crawl_cli_report_equals_jax(jax_out, capsys, tmp_path):
    from repro_torch.launch import crawl
    trace = tmp_path / "port.trace.json"
    assert crawl.main(CLI + ["--shards", "4", "--device", "cpu",
                             "--trace-out", str(trace)]) == 0
    got = capsys.readouterr().out
    want = (jax_out / "cli.txt").read_text()
    got_l, want_l = _cli_lines(got), _cli_lines(want)
    want_l = [ln.replace(str(jax_out / "jax.trace.json"), str(trace))
              for ln in want_l]
    assert got_l == want_l
    # eager steps and whole chunks: the same report (the trace aside)
    for mode in ("eager", "scan"):
        assert crawl.main(CLI + ["--shards", "4", "--device", "cpu",
                                 "--mode", mode]) == 0
        assert _cli_lines(capsys.readouterr().out) == \
            got_l[:got_l.index("== per-interval shard load ==") - 1], mode


def test_crawl_cli_needs_a_card_by_default(capsys):
    """Without ``--device`` the CLI runs on cuda (raises with no card);
    ``--kernel-impl`` takes ``auto`` only; fail and heal run."""
    from repro_torch.launch import crawl
    if torch.cuda.is_available():
        assert crawl.main(["--steps", "4", "--domains", "16"]) == 0
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            crawl.main(["--steps", "4", "--domains", "16"])
    with pytest.raises(SystemExit):
        crawl.main(["--kernel-impl", "ref", "--device", "cpu"])
    assert crawl.main(CLI + ["--device", "cpu", "--shards", "4",
                             "--fail-shard", "1", "--fail-at", "4",
                             "--heal-at", "8", "--ordering", "opic_url",
                             "--coordination", "batched", "--comm-quota",
                             "64", "--politeness", "1", "--revisit",
                             "32"]) == 0
    out = capsys.readouterr().out
    assert "shard 1 died" in out and "rebalanced" in out and \
        "coordination[batched]" in out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trace_report_renders_either_packages_trace(writer, jax_out,
                                                    tmp_path, capsys):
    from repro.launch import trace_report as jrep
    from repro_torch.launch import crawl
    from repro_torch.launch import trace_report as trep
    path = jax_out / "jax.trace.json"
    if writer == "port":
        path = tmp_path / "port.trace.jsonl"
        crawl.main(CLI + ["--shards", "4", "--device", "cpu",
                          "--trace-out", str(path)])
    capsys.readouterr()
    assert trep.main([str(path)]) == 0
    got = capsys.readouterr().out
    assert got.startswith("valid Chrome trace") and \
        "== per-interval shard load ==" in got and "run_chunk" in got
    assert jrep.main([str(path)]) == 0
    assert _cli_lines(capsys.readouterr().out) == _cli_lines(got)
