"""The port's crawl -> training-data pipeline against the JAX reference,
on the CPU: ``data.pipeline`` (LM batches, crawl edges, ranker examples)
and ``freshness.page_tokens_versioned`` with integer outputs identical bit
for bit; then the slice as a whole, the port's crawl of the reduced
webparf config tokenized and trained on, against the JAX pipeline and
trainer fed the same URLs; and the train CLI end to end.

Tolerances: integer leaves equal; the ranker's f32 features and target
equal bit for bit (``popularity`` takes its root in f64, correctly
rounded as XLA's is). The slice's losses over 4 AdamW steps within 1e-5
(measured 4.8e-7), as ``tests/test_torch_train.py`` holds them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget  # noqa: E402
from repro.configs.base import scaled as jscaled  # noqa: E402
from repro.core import freshness as JF  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import checkpoint as JC  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs import get_reduced as tget  # noqa: E402
from repro_torch.configs.base import scaled as tscaled  # noqa: E402
from repro_torch.core import freshness as TF  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402

CRAWL_STEPS = 24


@pytest.fixture(scope="module")
def crawl():
    """The port's CPU crawl of the reduced webparf config: (config, URLs)."""
    cfg = tget("webparf")
    urls = CrawlSession(cfg, device="cpu").run(CRAWL_STEPS).urls
    assert urls.dtype == np.uint32 and len(urls) > 100
    return cfg, urls


def drawn_urls(cfg, n=300, seed=3):
    return np.random.default_rng(seed).integers(
        0, 1 << cfg.url_space_log2, n).astype(np.uint32)


@pytest.mark.parametrize("batch,seq_len,vocab", [(4, 32, 256), (2, 64, 997),
                                                 (3, 128, 151936)])
def test_lm_batches_match_reference(crawl, batch, seq_len, vocab):
    cfg, urls = crawl
    want = list(JP.lm_batches(urls, cfg, batch=batch, seq_len=seq_len,
                              vocab=vocab))
    got = list(TP.lm_batches(urls, cfg, batch=batch, seq_len=seq_len,
                             vocab=vocab, device="cpu"))
    assert len(got) == len(want) > 0
    for (jt, jl), (tt, tl) in zip(want, got):
        assert tt.dtype == tl.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tt[:, 1:].numpy(), tl[:, :-1].numpy())


@pytest.mark.parametrize("link_pop_bias", [0.0, 1.0])
def test_crawl_edges_match_reference(crawl, link_pop_bias):
    cfg, urls = crawl
    jcfg = jscaled(jget("webparf"), link_pop_bias=link_pop_bias)
    tcfg = tscaled(cfg, link_pop_bias=link_pop_bias)
    for u in (urls, drawn_urls(cfg)):
        (js, jd), (ts, td) = JP.crawl_edges(u, jcfg), \
            TP.crawl_edges(u, tcfg, device="cpu")
        assert ts.dtype == td.dtype == np.int64
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(td, jd)


def test_ranker_examples_match_reference(crawl):
    cfg, urls = crawl
    for u in (urls, drawn_urls(cfg)):
        (jx, jy), (tx, ty) = JP.ranker_examples(u, jget("webparf")), \
            TP.ranker_examples(u, cfg, device="cpu")
        assert tx.shape == (len(u), 8) and tx.dtype == ty.dtype == \
            torch.float32
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("step", [0, 5, 40, 1000])
def test_page_tokens_versioned_match_reference(step):
    cfg = tget("webparf")
    u = drawn_urls(cfg, 200, seed=step)
    want = np.asarray(JF.page_tokens_versioned(
        jnp.asarray(u), step, jget("webparf"), n_tokens=12, vocab=4096))
    url = torch.from_numpy(u.astype(np.int64))
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = TF.page_tokens_versioned(url, s, cfg, n_tokens=12, vocab=4096)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    if step >= 40:
        # new content after a change (a page changes every 8 to 40 steps)
        assert (TF.page_tokens_versioned(url, 0, cfg, n_tokens=12,
                                         vocab=4096).numpy() != want).any()


def test_crawl_tokens_train_matches_reference(crawl):
    """The slice: the port's crawl -> its tokens -> 4 train steps, against
    JAX's ``lm_batches`` and trainer on the same URLs and weights."""
    cfg, urls = crawl
    jcfg = jscaled(jget("qwen2-1.5b"), dtype="float32")
    tcfg = tscaled(tget("qwen2-1.5b"), dtype="float32")
    kw = dict(batch=4, seq_len=32, vocab=tcfg.vocab_size)
    jb = list(JP.lm_batches(urls, jget("webparf"), **kw))[:4]
    tb = list(TP.lm_batches(urls, cfg, device="cpu", **kw))[:4]
    assert len(tb) == 4
    params = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    jopt, topt = jadamw(lr=3e-3), adamw(lr=3e-3)
    jstep = jax.jit(JTR.make_train_step(
        lambda p, b: JT.lm_loss(p, jcfg, b[0], b[1]), jopt))
    tstep = TTR.make_train_step(
        lambda p, b: TT.lm_loss(p, tcfg, b[0], b[1]), topt)
    jst = JTR.init_train_state(params, jopt)
    tst = TTR.init_train_state({k: torch.from_numpy(np.array(v)) for k, v
                                in JC._flatten(params).items()}, topt)
    for b, c in zip(jb, tb):
        np.testing.assert_array_equal(c[0].numpy(), np.asarray(b[0]))
        jst, jm = jstep(jst, b)
        tst, tm = tstep(tst, c)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5


def test_train_cli_end_to_end(tmp_path, capsys):
    args = TL.build_parser().parse_args(
        ["--steps", "4", "--crawl-steps", "20", "--batch", "2",
         "--seq-len", "32", "--log-every", "2", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "2", "--device", "cpu"])
    state = TL.train_lm(args)
    out = capsys.readouterr().out
    assert "crawled" in out and "step     4" in out and "final loss" in out
    assert int(state.step) == 4
    assert TC.all_steps(str(tmp_path)) == [2, 4]
    keys = set(TC.load(str(tmp_path)))
    assert {"step", "opt_state/count", "params/embed",
            "opt_state/m/layers/attn/wq", "opt_state/v/final_norm"} <= keys
    assert TL.main(["--steps", "2", "--crawl-steps", "20", "--batch", "2",
                    "--seq-len", "32", "--device", "cpu"]) == 0
