"""The port's frontier (the plain select, insert with overflow, the FIFO
rebase) and router against the JAX package. Inputs are made with numpy from
a seed; results must be identical. The frontier_select CUDA kernel is held
against its plain version in tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import frontier as JF  # noqa: E402
from repro.core import router as JRT  # noqa: E402
from repro.kernels.frontier_select.ops import select as jax_select  # noqa: E402
from repro_torch.core import frontier as TF  # noqa: E402
from repro_torch.core import router as TRT  # noqa: E402
from repro_torch.kernels.frontier_select import ops as SOPS  # noqa: E402
from repro_torch.kernels.frontier_select.ref import NEG  # noqa: E402


def rows(R, C, *, seed, fill=0.6, ties=False):
    """Frontier rows as the crawl keeps them: invalid cells hold NEG; row 0
    is empty and row 1 full when R > 1."""
    rng = np.random.default_rng(seed)
    url = rng.integers(1, 1 << 24, (R, C)).astype(np.uint32)
    valid = rng.random((R, C)) < fill
    if R > 1:
        valid[0], valid[1] = False, True
    pri = (rng.integers(0, 3, (R, C)) if ties else
           rng.permutation(R * C).reshape(R, C)).astype(np.float32)
    return url, np.where(valid, pri, np.float32(NEG)), valid


def port_select(url, pri, valid, k, *, unaligned=False):
    p, v = torch.tensor(pri), torch.tensor(valid)
    if unaligned:           # contiguous views one element into a buffer
        R, C = pri.shape
        p = torch.empty(R * C + 1)[1:].view(R, C).copy_(p)
        v = torch.empty(R * C + 1, dtype=torch.bool)[1:].view(R, C).copy_(v)
    out = SOPS.select(torch.tensor(url.astype(np.int64)), p, v, k=k,
                      return_idx=True)
    return [o.numpy() for o in out] + [p.numpy(), v.numpy()]


# The shapes the CUDA kernel's cases add (tests/test_torch_cuda.py), at
# R <= 3: C not a multiple of 4, k = C, unaligned views, rows past the
# kernel's register and shared-memory residency, fewer valid cells than k,
# an all-equal row, the CLI's and the reduced config's widths.
POP_SHAPES = [(3, 1001, 5), (2, 37, 37), (3, 4096, 3), (2, 16384, 4),
              (2, 20000, 3), (2, 70000, 3), (3, 128, 8), (3, 256, 6),
              (3, 512, 1), (3, 64, 1), (3, 512, 3), (3, 64, 5)]
POP_LAYOUT = {(3, 4096, 3): "unaligned", (3, 128, 8): "sparse",
              (3, 256, 6): "equal"}


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("R,C,k", [(1, 32, 1), (4, 64, 4), (2, 128, 8)]
                         + POP_SHAPES)
def test_select_plain_matches_jax(R, C, k, ties, impl):
    layout = POP_LAYOUT.get((R, C, k))
    url, pri, valid = rows(R, C, seed=R * C + k, ties=ties,
                           fill=0.03 if layout == "sparse" else 0.6)
    if layout == "equal":
        pri[-1], valid[-1] = 7.0, True
    ju, jp, jm, jpri, jval, jidx = (np.asarray(a) for a in jax_select(
        jnp.asarray(url), jnp.asarray(pri), jnp.asarray(valid), k=k,
        impl=impl, return_idx=True))
    tu, tp, tm, tidx, tpri, tval = port_select(
        url, pri, valid, k, unaligned=layout == "unaligned")
    np.testing.assert_array_equal(jm, tm)
    # masked lanes are unspecified by contract: compare the popped ones
    np.testing.assert_array_equal(np.where(jm, ju, 0), tu)
    np.testing.assert_array_equal(np.where(jm, jp, 0), np.where(tm, tp, 0))
    np.testing.assert_array_equal(np.where(jm, jidx, -1),
                                  np.where(tm, tidx, -1))
    np.testing.assert_array_equal(jpri, tpri)
    np.testing.assert_array_equal(jval, tval)
    if R > 1:
        assert not tm[0].any() and tm[1].all()


def frontier_pair(R, C, *, seed, fill):
    """The same frontier in both packages, filled by one insert."""
    rng = np.random.default_rng(seed)
    urls = rng.integers(1, 1 << 24, (R, C)).astype(np.uint32)
    scores = rng.random((R, C)).astype(np.float32)
    mask = rng.random((R, C)) < fill
    jf = JF.insert(JF.init_frontier(R, C), jnp.asarray(urls),
                   jnp.asarray(scores), jnp.asarray(mask), n_buckets=8)
    tf = TF.insert(TF.init_frontier(R, C, "cpu"),
                   torch.tensor(urls.astype(np.int64)),
                   torch.tensor(scores), torch.tensor(mask), n_buckets=8)
    return jf, tf


def assert_frontiers_equal(jf, tf):
    for name, a, b in zip(JF.Frontier._fields, jf, tf):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_array_equal(a.astype(b.dtype) if name == "url"
                                      else a, b, err_msg=name)


def insert_both(jf, tf, M, *, seed, fill=0.8, n_buckets=8):
    R = jf.url.shape[0]
    rng = np.random.default_rng(seed)
    urls = rng.integers(1, 1 << 24, (R, M)).astype(np.uint32)
    scores = rng.random((R, M)).astype(np.float32)
    scores[:, :2] = [0.0, 0.999]
    mask = rng.random((R, M)) < fill
    jf = JF.insert(jf, jnp.asarray(urls), jnp.asarray(scores),
                   jnp.asarray(mask), n_buckets=n_buckets)
    tf = TF.insert(tf, torch.tensor(urls.astype(np.int64)),
                   torch.tensor(scores), torch.tensor(mask),
                   n_buckets=n_buckets)
    return jf, tf


@pytest.mark.parametrize("fill", [0.0, 0.5, 0.95])
def test_insert_with_overflow_matches_jax(fill):
    jf, tf = frontier_pair(4, 64, seed=1, fill=fill)
    assert_frontiers_equal(jf, tf)
    jf, tf = insert_both(jf, tf, 48, seed=2)
    assert_frontiers_equal(jf, tf)
    if fill > 0.5:
        assert int(tf.n_dropped.sum()) > 0          # frontier_drop > 0


def test_fifo_rebase_matches_jax():
    """Arrival counters near 2^20 force the rank compaction on some rows."""
    jf, tf = frontier_pair(4, 64, seed=3, fill=0.5)
    arr = np.array([(1 << 20) - 10, 5, (1 << 20) - 40, (1 << 20) - 1],
                   np.int32)
    jf = jf._replace(arrival=jnp.asarray(arr))
    tf = tf._replace(arrival=torch.tensor(arr))
    jf, tf = insert_both(jf, tf, 16, seed=4)
    assert_frontiers_equal(jf, tf)
    assert int(tf.n_rebased.sum()) >= 2
    for seed in (5, 6):                   # later inserts after the rebase
        jf, tf = insert_both(jf, tf, 16, seed=seed)
        assert_frontiers_equal(jf, tf)


def test_select_then_insert_round_trip_matches_jax():
    jf, tf = frontier_pair(3, 32, seed=8, fill=0.7)
    ju, jp, jm, jfr = JF.select(jf, 4)
    tu, tp, tm, tfr = TF.select(tf, 4)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    assert_frontiers_equal(jfr, tfr)
    jfr = JF.insert(jfr, ju, jnp.full(ju.shape, 0.3), jm, n_buckets=8)
    tfr = TF.insert(tfr, tu, torch.full(tu.shape, 0.3), tm, n_buckets=8)
    assert_frontiers_equal(jfr, tfr)


def test_encode_priority_and_occupancy_match_jax():
    rng = np.random.default_rng(9)
    s = rng.random(256).astype(np.float32)
    s[:6] = [0.0, 0.124999, 0.125, 0.5, 0.999, 0.9999999]
    a = rng.integers(0, 1 << 21, 256).astype(np.int32)
    jp = np.asarray(JF.encode_priority(jnp.asarray(s), jnp.asarray(a), 8))
    tp = TF.encode_priority(torch.tensor(s), torch.tensor(a), 8).numpy()
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(
        np.asarray(JF._decode_arrival(jnp.asarray(jp))),
        TF._decode_arrival(torch.tensor(tp)).numpy())
    valid = rng.random(256) < 0.6
    np.testing.assert_array_equal(
        np.asarray(JF.bucket_occupancy(jnp.asarray(jp), jnp.asarray(valid),
                                       8)),
        TF.bucket_occupancy(torch.tensor(tp), torch.tensor(valid), 8).numpy())


@pytest.mark.parametrize("N,n_dest,cap", [(64, 4, 8), (100, 7, 30),
                                          (256, 1, 300)])
def test_pack_buckets_with_drops_matches_jax(N, n_dest, cap):
    rng = np.random.default_rng(N)
    payload = rng.integers(0, 1 << 32, (N, 2), dtype=np.uint64).astype(
        np.uint32)
    dest = rng.integers(0, n_dest, N).astype(np.int32)
    valid = rng.random(N) < 0.8
    jb, jm, jd, jk = JRT.pack_buckets(jnp.asarray(payload), jnp.asarray(dest),
                                      n_dest, cap, valid=jnp.asarray(valid),
                                      return_keep=True)
    tb, tm, td, tk = TRT.pack_buckets(torch.tensor(payload.astype(np.int64)),
                                      torch.tensor(dest), n_dest, cap,
                                      valid=torch.tensor(valid),
                                      return_keep=True)
    np.testing.assert_array_equal(np.asarray(jb).astype(np.int64), tb.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    assert int(jd) == int(td)
    if cap < N // n_dest:
        assert int(td) > 0
    ex = TRT.exchange(tb[None])
    assert ex.shape == (n_dest, 1, cap, 2) and torch.equal(ex[:, 0], tb)


def test_wrapper_counts_only_kernel_launches():
    before = SOPS.KERNEL.launches
    port_select(*rows(2, 32, seed=0), 2)
    assert SOPS.KERNEL.launches == before
