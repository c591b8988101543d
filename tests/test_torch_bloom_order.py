"""A numpy model of how the Hopper ``bloom`` kernel (csrc/bloom.cu) keeps
the tile order, held against the JAX package's Bloom probe-and-insert and
the port's plain versions on the same seeded inputs.

The kernel compacts a row's live lanes a window of whole tiles at a time
and walks each tile that holds one: all of the tile's items probe, then
(after a barrier) each writes only the bits it found clear, and a barrier
comes before the next tile probes. The model below takes the same windows
and tiles, so that a logic error in the design shows here, before any run
on the card; two broken orders (a barrier left out) must differ from
JAX."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.bloom.ops import probe_insert as jax_probe  # noqa: E402
from repro_torch.kernels.bloom.ref import (  # noqa: E402
    bloom_packed_ref, bloom_ref, pack_bits)

M32 = 0xFFFFFFFF
WINDOW = 4096          # csrc/bloom.cu kLaneWindow


def _mix(x, salt):
    x = (x & M32) ^ ((salt * 0x9E3779B9 + 0x85EBCA6B) & M32)
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & M32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def positions(urls, k, b):
    """urls (n,) -> (n, k) bit positions, as the kernel hashes them."""
    u = urls.astype(np.uint64)
    h1 = _mix((u + np.uint64(_mix(101, 7))) & np.uint64(M32), 0)
    h2 = _mix((u + np.uint64(_mix(202, 7))) & np.uint64(M32), 0) | 1
    j = np.arange(k, dtype=np.uint64)
    return ((h1[:, None] + j * h2[:, None]) & np.uint64((1 << b) - 1)
            ).astype(np.int64)


def tiles(live, tile):
    """The kernel's walk over a window's live lanes (sorted): (g0, g1) with
    [g0, g1) the live lanes of one tile, in order."""
    g0 = 0
    while g0 < len(live):
        t0 = live[g0] // tile
        g1 = g0 + int(np.searchsorted(live[g0:], (t0 + 1) * tile))
        yield g0, g1
        g0 = g1


def model(bits, urls, mask, *, k, tile, rule="walk"):
    """The kernel's algorithm on byte-per-bit rows, on a copy. Returns
    (seen, bits', stats). ``rule`` is "walk" (the design) or one of two
    broken orders the tests must catch: "same_tile" (no barrier between a
    tile's probes and its inserts: each item inserts before the next one
    probes) and "whole_window" (no barrier between tiles: the window's items
    all probe before any inserts)."""
    bits = bits.copy()
    R, M = urls.shape
    b = bits.shape[1].bit_length() - 1
    seen = np.zeros((R, M), bool)
    chunk = WINDOW // tile * tile
    stats = {"windows": 0, "walked_tiles": 0, "seen_by_order": 0}
    for r in range(R):
        for c0 in range(0, M, chunk):
            stats["windows"] += 1
            live = np.nonzero(mask[r, c0:c0 + chunk])[0]
            at_start = bits[r].copy()
            spans = list(tiles(live, tile))
            if rule == "whole_window" and spans:
                spans = [(0, len(live))]
            for g0, g1 in spans:
                lanes = live[g0:g1]
                pos = positions(urls[r, c0 + lanes], k, b)
                stats["walked_tiles"] += 1
                if rule == "same_tile":
                    for i, lane in enumerate(lanes):
                        seen[r, c0 + lane] = (bits[r, pos[i]] == 1).all()
                        bits[r, pos[i]] = 1
                    continue
                found = bits[r, pos] == 1
                seen[r, c0 + lanes] = found.all(axis=1)
                bits[r, pos[~found]] = 1
            stats["seen_by_order"] += int((
                seen[r, c0 + live] &
                ~(at_start[positions(urls[r, c0 + live], k, b)] == 1)
                .all(axis=1)).sum())
    return seen, bits, stats


def case(R, M, b, k, *, seed, fill, dup=0.0, prefill=0, front=0,
         masked_row=False):
    """(bits, urls uint32, mask): URLs below 2^30 that repeat with
    probability ``dup`` anywhere in the row; ``prefill`` URLs a row
    inserted before, half of them re-sent; ``front`` > 0 lays the
    row out as the crawl's dispatch does: about ``front`` live lanes
    packed at the front of each row."""
    rng = np.random.default_rng(seed)
    urls = rng.integers(0, 1 << 30, (R, M)).astype(np.uint32)
    src = rng.integers(0, M, (R, M))
    urls = np.where(rng.random((R, M)) < dup,
                    urls[np.arange(R)[:, None], src], urls)
    if front:
        n = rng.poisson(front, R)
        mask = np.arange(M)[None] < n[:, None]
    else:
        mask = rng.random((R, M)) < fill
    if masked_row:
        mask[-1] = False
    bits = np.zeros((R, 1 << b), np.uint8)
    if prefill:
        pre = np.concatenate([urls[:, :prefill // 2], rng.integers(
            0, 1 << 30, (R, prefill - prefill // 2)).astype(np.uint32)], 1)
        for r in range(R):
            bits[r, positions(pre[r], k, b).reshape(-1)] = 1
    return bits, urls, mask


# name: (R, M, b, k, tile, case kwargs)
CASES = {
    # the crawl's layout: a few live lanes packed at each row's front
    "crawl_front": (6, 4096, 12, 4, 256, dict(front=4, fill=0, dup=0.3,
                                              prefill=64)),
    # scattered live lanes re-sending URLs of earlier tiles
    "scattered": (4, 4096, 10, 4, 256, dict(fill=0.01, dup=0.5)),
    # a small filter: later tiles seen through bits earlier tiles set
    "small_b": (3, 512, 6, 3, 64, dict(fill=0.3, prefill=4)),
    "small_b5": (2, 256, 5, 2, 32, dict(fill=0.5)),
    # dense tiles, 230 items of 8 positions
    "dense": (2, 1024, 12, 8, 256, dict(fill=0.9, dup=0.3)),
    "k9": (2, 600, 10, 9, 128, dict(fill=0.5, dup=0.4)),
    "k1": (3, 700, 8, 1, 128, dict(fill=0.6, dup=0.5)),
    "tile1": (2, 64, 7, 3, 1, dict(fill=0.7, dup=0.5)),
    "tile32": (3, 1024, 6, 4, 32, dict(fill=0.1, dup=0.5)),
    "tile1024": (2, 5000, 14, 4, 1024, dict(fill=0.05, dup=0.5)),
    "windows": (1, 10000, 16, 4, 256, dict(fill=0.05, dup=0.5)),
    "masked": (4, 300, 10, 4, 256, dict(fill=0.6, dup=0.4, prefill=32,
                                        masked_row=True)),
    "all_masked": (3, 512, 9, 4, 256, dict(fill=0.0, prefill=32)),
}
# small enough for JAX's interpret mode, which unrolls the (R, M / tile) grid
INTERPRET = ["small_b", "small_b5", "masked", "tile32", "k9"]


def inputs(name):
    R, M, b, k, tile, kw = CASES[name]
    bits, urls, mask = case(R, M, b, k, seed=R * M + b + k + tile, **kw)
    return bits, urls, mask, k, tile


def jax_run(bits, urls, mask, k, tile, impl):
    s, out = jax_probe(jnp.asarray(bits), jnp.asarray(urls),
                       jnp.asarray(mask), k=k, impl=impl, url_tile=tile)
    return np.asarray(s), np.asarray(out)


@pytest.mark.parametrize("name", list(CASES))
def test_order_model_matches_jax_ref(name):
    bits, urls, mask, k, tile = inputs(name)
    seen, out, _ = model(bits, urls, mask, k=k, tile=tile)
    js, jb = jax_run(bits, urls, mask, k, tile, "ref")
    np.testing.assert_array_equal(seen, js)
    np.testing.assert_array_equal(out, jb)


@pytest.mark.parametrize("name", INTERPRET)
def test_order_model_matches_jax_interpret(name):
    bits, urls, mask, k, tile = inputs(name)
    seen, out, _ = model(bits, urls, mask, k=k, tile=tile)
    js, jb = jax_run(bits, urls, mask, k, tile, "interpret")
    np.testing.assert_array_equal(seen, js)
    np.testing.assert_array_equal(out, jb)


@pytest.mark.parametrize("name", list(CASES))
def test_order_model_matches_port_plain(name):
    """Against the port's plain versions, byte per bit and packed (ragged
    M included: the plain walk takes a short last tile, as the kernel)."""
    bits, urls, mask, k, tile = inputs(name)
    seen, out, _ = model(bits, urls, mask, k=k, tile=tile)
    u, m = torch.tensor(urls.astype(np.int64)), torch.tensor(mask)
    tb = torch.tensor(bits)
    ts = bloom_ref(tb, u, m, k=k, url_tile=tile)
    np.testing.assert_array_equal(ts.numpy(), seen)
    np.testing.assert_array_equal(tb.numpy(), out)
    tw = pack_bits(torch.tensor(bits))
    ws = bloom_packed_ref(tw, u, m, k=k, url_tile=tile)
    np.testing.assert_array_equal(ws.numpy(), seen)
    assert torch.equal(tw, pack_bits(torch.tensor(out)))


# what each case must reach: more than one window a row, and a URL seen
# only through bits that an earlier tile of its own window set
REACHES = {"crawl_front": (False, False), "scattered": (False, True),
           "small_b": (False, True), "small_b5": (False, True),
           "dense": (False, True), "k9": (False, True), "k1": (False, True),
           "tile1": (False, True), "tile32": (False, True),
           "tile1024": (True, True), "windows": (True, True),
           "masked": (False, True), "all_masked": (False, False)}


@pytest.mark.parametrize("name", list(REACHES))
def test_order_model_reaches_its_paths(name):
    bits, urls, mask, k, tile = inputs(name)
    seen, _, st = model(bits, urls, mask, k=k, tile=tile)
    R, M = urls.shape
    windows, by_order = REACHES[name]
    assert (st["windows"] > R) == windows, st
    assert (st["seen_by_order"] > 0) == by_order, st
    assert st["walked_tiles"] == sum(
        len(np.unique(np.nonzero(mask[r])[0] // tile)) for r in range(R))
    if name == "crawl_front":
        assert seen.any(), st
    assert not seen[~mask].any()


@pytest.mark.parametrize("rule", ["same_tile", "whole_window"])
def test_broken_order_rules_are_caught(rule):
    """Each order with a barrier left out differs from JAX on some case:
    the cases can see a logic error in the tile order."""
    bad = []
    for name in ("scattered", "small_b", "tile1", "tile32"):
        bits, urls, mask, k, tile = inputs(name)
        seen, out, _ = model(bits, urls, mask, k=k, tile=tile, rule=rule)
        js, jb = jax_run(bits, urls, mask, k, tile, "ref")
        bad.append(not (np.array_equal(seen, js) and np.array_equal(out, jb)))
    assert any(bad)
