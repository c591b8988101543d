"""The port's index and serve layer (``repro_torch/core/index.py``,
``repro_torch/serve``) against the JAX package's: the index leaves, the
query terms and page tokens, the TF-IDF scores and the served answers of
``ServeSession`` at ``webparf.reduced()`` with 1 and 4 shards, through a
fail/heal, and a JAX serve checkpoint restored by the port. The JAX
sessions run in one 4-device subprocess (``_torch_serve_play``); the
index functions run in this process. Tolerances: ``_torch_serve_play``."""
import json
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import webparf as jweb  # noqa: E402
from repro.core import index as JIX  # noqa: E402
from repro.core import webgraph as JW  # noqa: E402
from repro_torch.configs import webparf as tweb  # noqa: E402
from repro_torch.core import index as TIX  # noqa: E402
from repro_torch.core import webgraph as TW  # noqa: E402
from _torch_serve_play import (SCORE_ULP, assert_index, assert_run,  # noqa
                               assert_served, make_session, play, run_jax,
                               ulps)

JCFG, TCFG = jweb.reduced(), tweb.reduced()
SERVE = dict(qps=3.0, load_seed=0, doc_len=16, vocab=512, top_k=5)
CASES = {
    # 1 shard, an index that fills: docs refused at capacity are counted
    "one": {"shards": 1, "serve": {**SERVE, "index_capacity": 64},
            "ops": [["run", 16, True]]},
    # 4 shards: serve, checkpoint, shard 1 dies, serve, heal, serve
    "four": {"shards": 4, "serve": {**SERVE, "index_capacity": 1024},
             "ops": [["run", 8, False], ["checkpoint"], ["fail", 1],
                     ["run", 4, False], ["heal"], ["run", 8, True]]},
}


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("jax_serve"), CASES)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# the JAX functions jitted (one compile a shape, not one an op)
_jadd = jax.jit(JIX.add_batch, static_argnums=3)
_jtokens = jax.jit(JW.page_tokens, static_argnums=1,
                   static_argnames=("n_tokens", "vocab"))
_jterms = jax.jit(jax.vmap(lambda s, d, vocab: JIX.query_terms(
    s, 8, vocab, d, JCFG), in_axes=(0, 0, None)), static_argnums=2)
_jscores = jax.jit(jax.vmap(JIX.score_docs, in_axes=(None, 0)))
_jsearch = jax.jit(jax.vmap(partial(JIX.search, k=10), in_axes=(None, 0)))


def _jax_index(cap, urls, mask, doc_len=16, vocab=512):
    idx = JIX.init_index(cap, doc_len, vocab)
    return _jadd(idx, jnp.asarray(urls.astype(np.uint32)),
                 jnp.asarray(mask), JCFG)


def _assert_same_index(j, t, label):
    for k, a, b in zip(JIX.Index._fields, j, t):
        a = np.asarray(a)
        np.testing.assert_array_equal(
            a.astype(np.int64) if k == "doc_url" else a, b.numpy(),
            err_msg=f"{label}: Index.{k}")


def test_page_tokens_and_query_terms_match_jax():
    urls = np.random.default_rng(0).integers(
        0, 1 << JCFG.url_space_log2, 500).astype(np.uint32)
    for n_tokens, vocab in ((16, 512), (64, 4096), (7, 100)):
        np.testing.assert_array_equal(
            np.asarray(_jtokens(jnp.asarray(urls), JCFG, n_tokens=n_tokens,
                                vocab=vocab)),
            TW.page_tokens(_t(urls), TCFG, n_tokens=n_tokens,
                           vocab=vocab).numpy())
    seeds = np.array([0, 1, 7, 2 ** 31 - 1, 123456789], np.uint32)
    doms = np.array([0, 3, 15, 7, 1], np.int32)
    want = np.asarray(_jterms(jnp.asarray(seeds), jnp.asarray(doms), 512))
    np.testing.assert_array_equal(
        want, TIX.query_terms(_t(seeds), 8, 512, _t(doms), TCFG).numpy())
    for i, (s, d) in enumerate(zip(seeds, doms)):
        np.testing.assert_array_equal(
            want[i], TIX.query_terms(int(s), 8, 512, int(d), TCFG).numpy())


@pytest.mark.parametrize("cap", [8, 64])
def test_add_batch_matches_jax_at_capacity(cap):
    """Leaves identical, docs past capacity refused and counted, never
    overwritten; a blocked index adds each block's own batch."""
    rng = np.random.default_rng(cap)
    a = rng.integers(1, 1 << JCFG.url_space_log2, 40).astype(np.uint32)
    ma = rng.random(40) < 0.7
    b = rng.integers(1, 1 << JCFG.url_space_log2, 40).astype(np.uint32)
    mb = rng.random(40) < 0.5
    j = _jadd(_jax_index(cap, a, ma), jnp.asarray(b), jnp.asarray(mb),
              JCFG)
    t = TIX.init_index(cap, 16, 512)
    t = TIX.add_batch(t, _t(a), torch.from_numpy(ma), TCFG)
    t = TIX.add_batch(t, _t(b), torch.from_numpy(mb), TCFG)
    _assert_same_index(j, t, f"cap {cap}")
    want_drop = max(0, int(ma.sum() + mb.sum()) - cap)
    assert int(t.n_dropped) == want_drop and int(t.n_docs) == min(
        cap, int(ma.sum() + mb.sum()))
    # two blocks at once: each equals its own JAX index
    blk = TIX.init_index(cap, 16, 512, blocks=2)
    blk = TIX.add_batch(blk, _t(np.stack([a, b])),
                        torch.from_numpy(np.stack([ma, mb])), TCFG)
    for i, (u, m) in enumerate(((a, ma), (b, mb))):
        _assert_same_index(_jax_index(cap, u, m),
                           TIX.Index(*(x[i] for x in blk)), f"block {i}")


def test_incremental_adds_equal_one_batch_add():
    rng = np.random.default_rng(5)
    urls = rng.integers(1, 1 << JCFG.url_space_log2, 300).astype(np.uint32)
    mask = rng.random(300) < 0.8
    one = TIX.add_batch(TIX.init_index(200, 16, 512), _t(urls),
                        torch.from_numpy(mask), TCFG)
    inc = TIX.init_index(200, 16, 512)
    for lo, hi in ((0, 7), (7, 150), (150, 300)):
        inc = TIX.add_batch(inc, _t(urls[lo:hi]),
                            torch.from_numpy(mask[lo:hi]), TCFG)
    for k, x, y in zip(TIX.Index._fields, one, inc):
        assert torch.equal(x, y), k
    _assert_same_index(_jax_index(200, urls, mask), one, "one batch")


@pytest.mark.parametrize("doc_len,vocab", [(16, 512), (64, 4096)])
def test_score_docs_and_search_match_jax(doc_len, vocab):
    """Scores within SCORE_ULP (the -inf of empty slots identical), the
    top-k URLs equal but where a near-tie may order either way."""
    rng = np.random.default_rng(doc_len)
    urls = rng.integers(1, 1 << JCFG.url_space_log2, 700).astype(np.uint32)
    mask = np.ones(700, bool)
    j = _jax_index(1024, urls, mask, doc_len, vocab)
    t = TIX.add_batch(TIX.init_index(1024, doc_len, vocab), _t(urls),
                      torch.from_numpy(mask), TCFG)
    seeds = np.arange(1, 25, dtype=np.uint32)
    terms = _jterms(jnp.asarray(seeds), jnp.asarray(
        (seeds - 1) % JCFG.n_domains, jnp.int32), vocab)        # (24, Q)
    a = np.asarray(_jscores(j, terms))
    b = TIX.score_docs(TIX.Index(*(x[None] for x in t)),
                       _t(terms)[None])[0].numpy()
    fin = np.isfinite(a)
    np.testing.assert_array_equal(fin, np.isfinite(b))
    assert ulps(a[fin], b[fin]).max() <= SCORE_ULP
    for q in range(3):           # the unbatched entry point: the same bits
        np.testing.assert_array_equal(
            b[q], TIX.score_docs(t, _t(terms[q])).numpy())
    want_s, want_u = _jsearch(j, terms)
    got = [TIX.search(t, _t(x), k=10) for x in np.asarray(terms)]
    assert_served(np.asarray(want_u).astype(np.int64), np.asarray(want_s),
                  np.stack([u.numpy() for _, u in got]),
                  np.stack([s.numpy() for s, _ in got]),
                  f"search {doc_len}/{vocab}")


def test_serve_one_shard_matches_jax(jax_out):
    sess, rec = play(CASES["one"])
    with np.load(jax_out / "one.npz") as z:
        assert_run(z, "run0", rec[0], "one")
        assert_index(z, "index", sess.index, "one")
    assert rec[0].index["index_dropped"] > 0 and rec[0].index_full
    assert rec[0].n_queries > 0 and rec[0].recall_at_k is not None


def test_serve_four_shards_through_fail_heal_matches_jax(jax_out):
    from _torch_play import assert_states_close, leaves
    from repro_torch.core.stages import state_to_numpy
    sess, rec = play(CASES["four"])
    with np.load(jax_out / "four.npz") as z:
        for i, rep in rec.items():
            assert_run(z, f"run{i}", rep, "four")
        assert_index(z, "index", sess.index, "four")
        assert_states_close(leaves(z, "state"),
                            state_to_numpy(sess.crawl.state), "four")
    assert all(r.n_queries > 0 for r in rec.values())
    assert rec[5].recall_at_k is not None and rec[5].index_full is False
    # the dead shard fetched nothing while dead, and its index block
    # stopped growing
    assert rec[3].crawl.stats_per_shard["fetched"][1] == \
        rec[0].crawl.stats_per_shard["fetched"][1]


def test_jax_serve_checkpoint_restored_by_port(jax_out):
    """A serve checkpoint JAX wrote mid-run, restored by the port, goes
    on to the same answers, lags and index. Recall is left out: after a
    restore the oracle's page stream restarts, while the JAX session that
    wrote the checkpoint kept its own."""
    sess, rec = play(CASES["four"], ckpt_dir=jax_out / "four.ckpt")
    assert sess.t == 20
    with np.load(jax_out / "four.npz") as z:
        for i, rep in rec.items():
            key = f"run{i}"
            assert_served(z[f"{key}.top_urls"], z[f"{key}.top_scores"],
                          rep.top_urls, rep.top_scores, key)
            for f in ("lag_steps", "arrival_step"):
                np.testing.assert_array_equal(z[f"{key}.{f}"],
                                              getattr(rep, f))
            assert json.loads(str(z[f"{key}.index"])) == rep.index
            np.testing.assert_array_equal(z[f"{key}.urls"], rep.crawl.urls)
        assert_index(z, "index", sess.index, "restored")


def test_port_serve_checkpoint_round_trips_and_jax_reads_it(tmp_path):
    """The port's own checkpoint: a fresh session restores it and serves
    the same continuation, and the JAX package's checkpoint reader takes
    its files as written."""
    from repro.train import checkpoint as jckpt
    case = {"shards": 4, "serve": {**SERVE, "index_capacity": 256},
            "ops": []}
    a = make_session(case)
    a.run(8, recall=False)
    a.checkpoint(str(tmp_path))
    cursor = a._q_cursor
    ra = a.run(8, recall=False)
    b = make_session(case).restore(str(tmp_path))
    assert (b.t, b.watermark, b._q_cursor) == (8, 8, cursor)
    target = {"index": JIX.Index(*(jnp.zeros(tuple(v.shape), d)
                                   for v, d in zip(b.index, (
                                       jnp.uint32, jnp.int32, bool,
                                       jnp.int32, jnp.int32, jnp.int32)))),
              "watermark": jnp.int32(0), "q_cursor": jnp.int32(0)}
    tree = jckpt.restore(str(tmp_path / "serve"), target, step=8)
    assert (int(tree["watermark"]), int(tree["q_cursor"])) == (8, cursor)
    for k, x, y in zip(TIX.Index._fields, tree["index"], b.index):
        np.testing.assert_array_equal(np.asarray(x).astype(np.int64),
                                      y.numpy().astype(np.int64), err_msg=k)
    rb = b.run(8, recall=False)
    np.testing.assert_array_equal(ra.top_urls, rb.top_urls)
    np.testing.assert_array_equal(ra.top_scores, rb.top_scores)
    for k, x, y in zip(TIX.Index._fields, a.index, b.index):
        assert torch.equal(x, y), k


def test_serve_session_answer_and_telemetry_spans():
    from repro_torch.configs.base import scaled
    from repro_torch.serve import ServeSession
    sess = ServeSession(scaled(TCFG, telemetry=True), "cpu", n_shards=2,
                        qps=4.0, index_capacity=512, doc_len=16, vocab=512,
                        top_k=5)
    rep = sess.run(8)
    names = {e.name for e in sess.tracer.events}
    assert {"query_batch", "index_fold", "run_chunk"} <= names
    assert rep.telemetry is not None and "freshness_lag_mean" in \
        rep.telemetry.metrics()
    s, u = sess.answer([0, 1, 2])
    assert s.shape == u.shape == (3, 5)
    assert (u[np.isfinite(s)] > 0).all()
    with pytest.raises(ValueError, match="multiples"):
        sess.run(3)


def test_serve_cli_runs_on_cpu_and_needs_a_card_by_default(tmp_path,
                                                           capsys):
    from repro_torch.launch import serve_search
    argv = ["--steps", "8", "--domains", "16", "--shards", "2",
            "--fail-shard", "1", "--fail-at", "4", "--heal-at", "8",
            "--index-capacity", "512", "--ckpt-dir", str(tmp_path)]
    if torch.cuda.is_available():
        assert serve_search.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            serve_search.main(argv)
    assert serve_search.main(argv + ["--device", "cpu", "--trace"]) == 0
    out = capsys.readouterr().out
    assert "ServeReport" in out and "shard 1 died" in out and \
        "== spans ==" in out
