"""The port's dedup (the bloom plain versions, byte per bit and packed in
int32 words, the packing itself, exact dedup) against the JAX package.
Inputs are made with numpy from a seed; results must be identical, words
compared as uint32. The bloom CUDA kernels are held against their plain
versions in tests/test_torch_cuda.py, which imports no JAX so that it runs
on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import dedup as JDD  # noqa: E402
from repro.kernels.bloom import bloom as JBL  # noqa: E402
from repro.kernels.bloom.ops import probe_insert as jax_probe  # noqa: E402
from repro_torch.core import dedup as TDD  # noqa: E402
from repro_torch.kernels.bloom import ops as BOPS  # noqa: E402
from repro_torch.kernels.bloom.ref import pack_bits, unpack_bits  # noqa: E402


def batch(R, M, b, *, seed, dup=0.0, fill=0.7, prefill=0, masked_row=False):
    """(bits, urls, mask): URLs repeat with probability ``dup`` (anywhere
    in the row, so within and across 256-URL tiles); ``prefill`` URLs per
    row were inserted before; a fully masked row when ``masked_row``."""
    rng = np.random.default_rng(seed)
    urls = rng.integers(0, 1 << 24, (R, M)).astype(np.uint32)
    rep = rng.random((R, M)) < dup
    src = rng.integers(0, M, (R, M))
    urls = np.where(rep, urls[np.arange(R)[:, None], src], urls)
    mask = rng.random((R, M)) < fill
    if masked_row:
        mask[-1] = False
    bits = np.zeros((R, 1 << b), np.uint8)
    if prefill:
        pre = np.concatenate([urls[:, :prefill // 2],
                              rng.integers(0, 1 << 24, (R, prefill - prefill
                                                        // 2))], 1)
        _, jb = jax_probe(jnp.asarray(bits), jnp.asarray(pre, jnp.uint32),
                          jnp.ones(pre.shape, bool), k=3, impl="ref")
        bits = np.asarray(jb)
    return bits, urls, mask


def port_bloom(bits, urls, mask, k):
    bt = torch.tensor(bits)
    seen = BOPS.probe_insert(bt, torch.tensor(urls.astype(np.int64)),
                             torch.tensor(mask), k=k)
    return seen.numpy(), bt.numpy()


CASES = [  # (R, M, b, k, dup, prefill, masked_row): tests/test_kernels.py's
    (1, 256, 10, 2, 0.0, 0, False),     # matrix, then duplicates within and
    (4, 256, 12, 4, 0.0, 0, False),     # across tiles, ragged M, a fully
    (2, 512, 14, 3, 0.0, 0, False),     # masked row and a pre-filled filter
    (8, 512, 11, 5, 0.0, 0, False),
    (2, 512, 12, 4, 0.5, 0, False),
    (3, 300, 10, 4, 0.4, 64, True),
    (2, 100, 9, 3, 0.6, 16, False),
    (4, 640, 12, 4, 0.3, 128, True),
]


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("R,M,b,k,dup,prefill,masked_row", CASES)
def test_bloom_plain_matches_jax(R, M, b, k, dup, prefill, masked_row, impl):
    bits, urls, mask = batch(R, M, b, seed=R * M + b, dup=dup,
                             prefill=prefill, masked_row=masked_row)
    js, jb = jax_probe(jnp.asarray(bits), jnp.asarray(urls),
                       jnp.asarray(mask), k=k, impl=impl)
    ts, tb = port_bloom(bits, urls, mask, k)
    np.testing.assert_array_equal(np.asarray(js), ts)
    np.testing.assert_array_equal(np.asarray(jb), tb)
    if dup or prefill:
        assert ts.any(), "the case should see some URLs"


def test_bloom_fully_masked_batch_is_a_noop():
    bits, urls, mask = batch(2, 300, 10, seed=3, prefill=32)
    seen, out = port_bloom(bits, urls, np.zeros_like(mask), 4)
    assert not seen.any()
    np.testing.assert_array_equal(out, bits)


def test_bloom_tiles_in_order():
    """A URL repeated in a later tile is seen; within a tile it is not."""
    urls = np.arange(512, dtype=np.uint32)[None] + 1000
    urls[0, 300] = urls[0, 10]             # tile 1 repeats a tile-0 URL
    urls[0, 20] = urls[0, 10]              # tile 0 repeats it too
    mask = np.ones_like(urls, bool)
    seen, _ = port_bloom(np.zeros((1, 1 << 16), np.uint8), urls, mask, 4)
    assert seen[0, 300] and not seen[0, 20] and not seen[0, 10]


def test_bloom_incremental_matches_batch():
    """Inserting in two batches leaves the filter as one batch does."""
    _, urls, _ = batch(1, 128, 12, seed=11)
    mask = np.ones_like(urls, bool)
    zero = np.zeros((1, 1 << 12), np.uint8)
    _, once = port_bloom(zero, urls, mask, 3)
    _, half = port_bloom(zero, urls[:, :64], mask[:, :64], 3)
    _, twice = port_bloom(half, urls[:, 64:], mask[:, 64:], 3)
    np.testing.assert_array_equal(once, twice)


def test_bit_indices_match_jax():
    u = np.random.default_rng(1).integers(0, 1 << 32, (4, 97),
                                          dtype=np.uint64).astype(np.uint32)
    for k, b in ((1, 8), (4, 24), (7, 31)):
        a = np.asarray(JDD._bit_indices(jnp.asarray(u), k, b))
        t = TDD._bit_indices(torch.tensor(u.astype(np.int64)), k, b).numpy()
        np.testing.assert_array_equal(a.astype(np.int64), t)


@pytest.mark.parametrize("shape,dup", [((1, 64), 0.5), ((5, 33), 0.8),
                                       ((3, 256), 0.0), ((2, 1), 0.0)])
def test_exact_dedup_matches_jax(shape, dup):
    rng = np.random.default_rng(shape[1])
    u = rng.integers(0, 50 if dup else 1 << 32, shape,
                     dtype=np.uint64).astype(np.uint32)
    u.reshape(-1)[:1] = 0xFFFFFFFF          # the sort's sentinel value
    m = rng.random(shape) < 0.8
    a = np.asarray(JDD.exact_dedup(jnp.asarray(u), jnp.asarray(m)))
    t = TDD.exact_dedup(torch.tensor(u.astype(np.int64)),
                        torch.tensor(m)).numpy()
    np.testing.assert_array_equal(a, t)


def test_wrapper_counts_only_kernel_launches():
    """On CPU tensors the wrapper takes the plain version and counts no
    launch."""
    before = BOPS.KERNEL.launches
    port_bloom(*batch(2, 64, 8, seed=0), 3)
    assert BOPS.KERNEL.launches == before


# ---------------------------------------------------------------------------
# the packed filter: int32 words carrying uint32 bit patterns
# ---------------------------------------------------------------------------

def as_words(w):
    """uint32 words (numpy) -> the port's int32 tensor, same bits."""
    return torch.tensor(np.ascontiguousarray(w, np.uint32).view(np.int32))


def as_uint32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("R,n,fill", [(3, 1 << 10, 0.5), (2, 32, 1.0),
                                      (4, 1 << 12, 0.02), (1, 64, 0.0)])
def test_pack_bits_matches_jax(R, n, fill):
    """Bit for bit as uint32, words with bit 31 set among them, and the
    round trip through the port's unpack."""
    bits = (np.random.default_rng(n + R).random((R, n)) < fill).astype(
        np.uint8)
    if fill:
        bits[:, 31::32] = 1                  # every word has bit 31 set
    words = pack_bits(torch.tensor(bits))
    assert words.dtype == torch.int32 and words.shape == (R, n // 32)
    np.testing.assert_array_equal(np.asarray(JBL.pack_bits(
        jnp.asarray(bits))), as_uint32(words))
    np.testing.assert_array_equal(unpack_bits(words).numpy(), bits)
    out = torch.full((R, n), 7, dtype=torch.uint8)
    assert unpack_bits(words, out=out) is out
    np.testing.assert_array_equal(out.numpy(), bits)


def test_unpack_bits_matches_jax():
    w = np.random.default_rng(5).integers(0, 1 << 32, (3, 40),
                                          dtype=np.uint64).astype(np.uint32)
    w[0, 0], w[0, 1] = 0xFFFFFFFF, 0x80000000
    np.testing.assert_array_equal(
        np.asarray(JBL.unpack_bits(jnp.asarray(w))),
        unpack_bits(as_words(w)).numpy())


def random_words(R, b, seed):
    """A filter that already holds bits, bit 31 set in many words."""
    w = np.random.default_rng(seed).integers(
        0, 1 << 32, (R, (1 << b) // 32), dtype=np.uint64).astype(np.uint32)
    return w & np.uint32(0x80010001)


PACKED_CASES = [  # (R, M, b, k, dup, masked_row): tests/test_kernels.py's
    (2, 256, 12, 4, 0.0, False),        # matrix, then URLs colliding on a
    (4, 512, 11, 3, 0.0, False),        # row of 1 and 4 words, duplicates
    (2, 128, 5, 4, 0.5, False),         # within and across tiles and a
    (3, 96, 7, 3, 0.5, True),           # fully masked row
]


@pytest.mark.parametrize("R,M,b,k,dup,masked_row", PACKED_CASES)
def test_bloom_packed_matches_jax(R, M, b, k, dup, masked_row):
    _, urls, mask = batch(R, M, b, seed=R * M + b, dup=dup,
                          masked_row=masked_row)
    w0 = random_words(R, b, seed=M)
    js, jw = JBL.bloom_probe_insert_packed(
        jnp.asarray(w0), jnp.asarray(urls), jnp.asarray(mask), k=k,
        url_tile=32, interpret=True)
    tw = as_words(w0)
    ts = BOPS.probe_insert_packed(tw, torch.tensor(urls.astype(np.int64)),
                                  torch.tensor(mask), k=k, url_tile=32)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jw), as_uint32(tw))
    assert ts.any() and (as_uint32(tw) != w0).any()


@pytest.mark.parametrize("R,M,b,k", [(3, 300, 10, 4), (2, 100, 6, 3)])
def test_bloom_packed_ragged_matches_jax(R, M, b, k):
    """M not a multiple of the tile: the JAX packed kernel takes no ragged
    M, so the port is held against JAX's padded byte-per-bit probe, packed."""
    bits, urls, mask = batch(R, M, b, seed=M + b, dup=0.4, prefill=16,
                             masked_row=True)
    js, jb = jax_probe(jnp.asarray(bits), jnp.asarray(urls),
                       jnp.asarray(mask), k=k, impl="interpret", url_tile=32)
    tw = pack_bits(torch.tensor(bits))
    ts = BOPS.probe_insert_packed(tw, torch.tensor(urls.astype(np.int64)),
                                  torch.tensor(mask), k=k, url_tile=32)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(JBL.pack_bits(jb)),
                                  as_uint32(tw))
    assert ts.any()


@pytest.mark.parametrize("R,M,b,k,dup,prefill,masked_row", CASES + [
    (2, 300, 5, 4, 0.5, 16, True), (3, 64, 6, 2, 0.8, 0, False)])
def test_bloom_packed_matches_bytewise(R, M, b, k, dup, prefill, masked_row):
    """Inside the port, the packed walk equals the byte-per-bit walk bit
    for bit (the tile 256 of the crawl, and a tile of 32)."""
    bits, urls, mask = batch(R, M, b, seed=R * M + b, dup=dup,
                             prefill=prefill, masked_row=masked_row)
    u, m = torch.tensor(urls.astype(np.int64)), torch.tensor(mask)
    for tile in (256, 32):
        tb = torch.tensor(bits)
        tw = pack_bits(tb)
        s1 = BOPS.probe_insert(tb, u, m, k=k, url_tile=tile)
        s2 = BOPS.probe_insert_packed(tw, u, m, k=k, url_tile=tile)
        assert torch.equal(s1, s2)
        assert torch.equal(pack_bits(tb), tw)


def test_bloom_packed_checks_its_inputs():
    u = torch.zeros((2, 8), dtype=torch.int64)
    m = torch.ones((2, 8), dtype=torch.bool)
    with pytest.raises(TypeError):
        BOPS.probe_insert_packed(torch.zeros((2, 4), dtype=torch.uint8), u,
                                 m, k=3)
    with pytest.raises(ValueError, match="power of two"):
        BOPS.probe_insert_packed(torch.zeros((2, 3), dtype=torch.int32), u,
                                 m, k=3)
    before = BOPS.PACKED.launches
    BOPS.probe_insert_packed(torch.zeros((2, 4), dtype=torch.int32), u, m,
                             k=3)
    assert BOPS.PACKED.launches == before
