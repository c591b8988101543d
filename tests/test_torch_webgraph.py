"""The port's synthetic web, classifier and ranker against the JAX package:
the same inputs (numpy, from a seed) through both, compared bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import webparf as jweb  # noqa: E402
from repro.core import classifier as JCLS  # noqa: E402
from repro.core import ranker as JRK  # noqa: E402
from repro.core import webgraph as JW  # noqa: E402
from repro.ordering import policies as JORD  # noqa: E402
from repro_torch.configs.base import CrawlConfig  # noqa: E402
from repro_torch.core import classifier as TCLS  # noqa: E402
from repro_torch.core import ranker as TRK  # noqa: E402
from repro_torch.core import webgraph as TW  # noqa: E402
from repro_torch.ordering import policies as TORD  # noqa: E402


def port_cfg(jcfg):
    return CrawlConfig(**{**dataclasses.asdict(jcfg), "kernel_impl": "auto"})


CFGS = {"reduced": jweb.reduced(), "config": jweb.CONFIG}


@pytest.fixture(params=sorted(CFGS))
def cfgs(request):
    jcfg = CFGS[request.param]
    return jcfg, port_cfg(jcfg)


def urls_for(jcfg, shape, seed=0):
    """URL ids over the config's space plus raw uint32 extremes."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 1 << jcfg.url_space_log2, shape, dtype=np.uint64)
    u.reshape(-1)[:4] = [0, 1, (1 << jcfg.url_space_log2) - 1,
                         (1 << jcfg.url_space_log2) - 2]
    return u.astype(np.uint32)


def both(fn_j, fn_t, u, *args):
    a = np.asarray(fn_j(jnp.asarray(u), *args))
    b = fn_t(torch.tensor(u.astype(np.int64)), *args).numpy()
    return a, b


def assert_same(a, b):
    """Same values; ints compared as int64, floats bit for bit."""
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("salt", [0, 7, 11, 101, 202])
def test_mix_and_hash2_bit_identical(salt):
    rng = np.random.default_rng(salt)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 1, 0xFFFFFFFF]
    y = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    assert_same(*both(JW._mix, TW._mix, x, salt))
    a = np.asarray(JW.hash2(jnp.asarray(x), jnp.asarray(y), salt))
    b = TW.hash2(torch.tensor(x.astype(np.int64)),
                 torch.tensor(y.astype(np.int64)), salt).numpy()
    assert_same(a, b)
    assert_same(*both(JW._uniform, TW._uniform, x))


def test_url_geometry_bit_identical(cfgs):
    jcfg, tcfg = cfgs
    u = urls_for(jcfg, (64, 33))
    assert_same(np.asarray(JW.domain_of(jnp.asarray(u), jcfg)),
                TW.domain_of(torch.tensor(u.astype(np.int64)), tcfg).numpy())
    assert_same(np.asarray(JW.canonical(jnp.asarray(u), jcfg)),
                TW.canonical(torch.tensor(u.astype(np.int64)), tcfg).numpy())
    assert_same(np.asarray(JW.popularity(jnp.asarray(u), jcfg)),
                TW.popularity(torch.tensor(u.astype(np.int64)), tcfg).numpy())
    assert_same(np.asarray(JW.is_hub(jnp.asarray(u), jcfg)),
                TW.is_hub(torch.tensor(u.astype(np.int64)), tcfg).numpy())
    d = np.random.default_rng(1).integers(0, jcfg.n_domains, u.shape)
    assert_same(np.asarray(JW.make_url(jnp.asarray(d), jnp.asarray(u), jcfg)),
                TW.make_url(torch.tensor(d), torch.tensor(u.astype(np.int64)),
                            tcfg).numpy())


@pytest.mark.parametrize("bias", [0.0, 0.3])
def test_outlinks_bit_identical(cfgs, bias):
    jcfg, tcfg = cfgs
    jcfg = dataclasses.replace(jcfg, link_pop_bias=bias)
    tcfg = dataclasses.replace(tcfg, link_pop_bias=bias)
    u = urls_for(jcfg, (32, 8), seed=3)
    a = np.asarray(JW.outlinks(jnp.asarray(u), jcfg, JW.zipf_cumweights(jcfg)))
    b = TW.outlinks(torch.tensor(u.astype(np.int64)), tcfg,
                    TW.zipf_cumweights(tcfg)).numpy()
    assert a.shape == b.shape
    assert_same(a, b)


def test_zipf_and_sample_domain_bit_identical(cfgs):
    jcfg, tcfg = cfgs
    cj, ct = JW.zipf_cumweights(jcfg), TW.zipf_cumweights(tcfg)
    assert_same(np.asarray(cj), ct.numpy())
    h = np.random.default_rng(5).integers(0, 1 << 32, 8192,
                                          dtype=np.uint64).astype(np.uint32)
    # hashes that land exactly on a cumulative weight test the search side
    h[:8] = np.minimum(np.asarray(cj[:8], np.float64) * 4294967296.0,
                       0xFFFFFFFF).astype(np.uint32)
    assert_same(np.asarray(JW.sample_domain(jnp.asarray(h), cj)),
                TW.sample_domain(torch.tensor(h.astype(np.int64)), ct).numpy())


def test_hub_seeds_bit_identical(cfgs):
    jcfg, tcfg = cfgs
    a = np.asarray(JW.hub_seeds(jcfg))
    b = TW.hub_seeds(tcfg).numpy()
    assert a.shape == b.shape
    assert_same(a, b)


def test_classifier_and_ranker_bit_identical(cfgs):
    jcfg, tcfg = cfgs
    u = urls_for(jcfg, (16, 64), seed=7)
    src = np.random.default_rng(8).integers(0, jcfg.n_domains, u.shape)
    ut = torch.tensor(u.astype(np.int64))
    for step in (0, 5, 123):
        a = np.asarray(JCLS.predict_domain(jnp.asarray(u),
                                           jnp.asarray(src, jnp.int32), jcfg,
                                           step=jnp.int32(step)))
        b = TCLS.predict_domain(ut, torch.tensor(src), tcfg,
                                step=torch.tensor(step, dtype=torch.int32))
        assert_same(a, b.numpy())
    assert_same(np.asarray(JCLS.page_domain(jnp.asarray(u), jcfg)),
                TCLS.page_domain(ut, tcfg).numpy())
    assert_same(np.asarray(JRK.score_urls(jnp.asarray(u), jcfg)),
                TRK.score_urls(ut, tcfg).numpy())
    assert_same(np.asarray(JRK.url_features(jnp.asarray(u), jcfg)),
                TRK.url_features(ut, tcfg).numpy())


@pytest.mark.parametrize("name", ["fifo", "backlink", "learned"])
def test_ordering_scores_match(name):
    jcfg = jweb.reduced()
    tcfg = port_cfg(jcfg)
    u = urls_for(jcfg, (8, 64), seed=9)
    fj = JORD.get_ordering(name).make_score_fn(jcfg, n_shards=1, axes=())
    ft = TORD.get_ordering(name).make_score_fn(tcfg, n_shards=1)
    a = np.asarray(fj(jnp.asarray(u), jcfg, None))
    b = ft(torch.tensor(u.astype(np.int64)), tcfg, None).numpy()
    if name == "learned":
        # the logits agree bit for bit, but XLA's logistic and torch's
        # sigmoid differ by up to 2 f32 ulp (XLA's is itself up to 2 ulp
        # from the correctly rounded value); every score must still land in
        # the same priority bucket (encode_priority's clamp)
        assert a.dtype == b.dtype == np.float32
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
        assert (np.abs(a - b) <= 2 * ulp).all()
        nb = jcfg.n_priority_buckets

        def bucket(s):
            return np.clip((s * np.float32(nb)).astype(np.int32), 0, nb - 1)
        np.testing.assert_array_equal(bucket(a), bucket(b))
    else:
        assert_same(a, b)
    assert TORD.ORD_WIDTH == JORD.ORD_WIDTH and TORD.ORD_URL0 == JORD.ORD_URL0
