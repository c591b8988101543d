"""``dedup_deposit`` on batches that re-send queued URLs, on the CPU.

The port's plain version against JAX's ``ref`` and ``interpret`` on the
twin cases the card tests use (``_twin_cases.twin_case``): twins at the
first and last column, a URL queued twice (the lower column wins), a lower
column invalid, one cell hit twice in a tile, no-twin refunds of -0.0,
all-masked rows, M not a multiple of the tile, tiles of 1 and 1024, and
60%-valid queues. Values are dyadic here (the card tests draw them of
mixed magnitude), so the refunds must be identical whatever order XLA adds
in.

Then pure-Python models of the two pieces of the CUDA kernel
(``csrc/dedup_deposit.cu``) whose order matters and which the card cannot
show step by step: the refund, summed by one warp as the same halving tree
(each lane halves its own positions while the half is 32 or wider, then
shuffles), must be bit-equal to ``tree_sum`` on sparse tiles with -0.0
among the values; and the twin lookup, the valid cells compacted in
column order into a hash that keeps the lowest index, a chunk of columns
at a time when the queue is too long, must find the same cell as the
plain version's ``first_twin``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.dedup_deposit.ops import \
    dedup_deposit as jax_dd  # noqa: E402
from repro_torch.kernels.bloom.ref import pack_bits  # noqa: E402
from repro_torch.kernels.dedup_deposit.ops import (  # noqa: E402
    dedup_deposit, dedup_deposit_packed)
from repro_torch.kernels.dedup_deposit.ref import (  # noqa: E402
    first_twin, sorted_queue)
from repro_torch.kernels.rowsum import tree_sum  # noqa: E402
from _twin_cases import TWIN_CASES, twin_case  # noqa: E402


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("R,M,C,b,tile,fill", TWIN_CASES)
def test_dedup_deposit_twins_match_jax(R, M, C, b, tile, fill, impl):
    """seen, the filter, the lane and the refund identical to JAX's; the
    packed plain version the same as the byte-per-bit one."""
    bits, urls, mask, val, f_url, f_valid, table = twin_case(
        R, M, C, b, seed=R + M + C + tile, queue_fill=fill, dyadic=True)
    J = lambda a, dt=None: jnp.asarray(a, dt)  # noqa: E731
    seen, jbits, jtable, refund = (np.asarray(a) for a in jax_dd(
        J(bits), J(urls, jnp.uint32), J(mask), J(val), J(f_url, jnp.uint32),
        J(f_valid), J(table), k=4, impl=impl, url_tile=tile))
    T = torch.tensor
    rest = [T(urls), T(mask), T(val), T(f_url), T(f_valid)]
    tb, tt = T(bits), T(table)
    s, r = dedup_deposit(tb, *rest, tt, k=4, url_tile=tile)
    np.testing.assert_array_equal(seen, s.numpy())
    np.testing.assert_array_equal(jbits, tb.numpy())
    np.testing.assert_array_equal(jtable, tt.numpy())
    np.testing.assert_array_equal(refund.view(np.uint32),
                                  r.numpy().view(np.uint32))
    assert seen.any() and (jtable != table).any() and (refund != 0).any()
    tw, tt2 = pack_bits(T(bits)), T(table)
    s2, r2 = dedup_deposit_packed(tw, *rest, tt2, k=4, url_tile=tile)
    assert torch.equal(s2, s) and torch.equal(tt2, tt)
    assert torch.equal(r2.view(torch.int32), r.view(torch.int32))
    assert torch.equal(tw, pack_bits(tb))


def warp_tree(x):
    """The kernel's refund tree over one tile, in float32: the leaves at
    their positions in a buffer of the power-of-two width P (absent +0.0);
    lane l halves its own positions l, l + 32, ... while the half is 32 or
    wider; then lane l < h adds lane l + h's value, h = min(P, 32) / 2 down
    to 1 (the shuffles)."""
    w = len(x)
    P = 1
    while P < w:
        P *= 2
    buf = [np.float32(0.0)] * P
    buf[:w] = [np.float32(v) for v in x]
    h = P // 2
    while h >= 32:
        for lane in range(32):
            for j in range(lane, h, 32):
                buf[j] = np.float32(buf[j] + buf[j + h])
        h //= 2
    reg = [buf[lane] if lane < P else np.float32(0.0) for lane in range(32)]
    h = min(P, 32) // 2
    while h >= 1:
        reg = [np.float32(reg[lane] + reg[lane + h]) if lane < h
               else reg[lane] for lane in range(32)]
        h //= 2
    return reg[0]


@pytest.mark.parametrize("width,density,seed", [
    (1, 1.0, 0), (3, 0.7, 1), (31, 0.2, 2), (32, 0.5, 3), (33, 0.1, 4),
    (100, 0.05, 5), (256, 0.02, 6), (256, 0.6, 7), (1000, 0.01, 8),
    (1024, 0.3, 9)])
def test_refund_tree_model_matches_tree_sum(width, density, seed):
    """Random sparse tiles, values of mixed sign and magnitude with -0.0
    among them, and a tile of -0.0 alone: the warp's tree gives tree_sum's
    bits."""
    rng = np.random.default_rng(seed)
    for trial in range(4):
        x = np.zeros(width, np.float32)
        live = rng.random(width) < density
        vals = (rng.standard_normal(width)
                * 10.0 ** rng.integers(-6, 6, width)).astype(np.float32)
        vals[rng.random(width) < 0.25] = -0.0
        x[live] = vals[live]
        if trial == 3:
            x = np.where(live, np.float32(-0.0), np.float32(0.0))
        want = tree_sum(torch.tensor(x)).numpy()
        got = np.float32(warp_tree(x))
        assert got.view(np.uint32) == want.view(np.uint32), (trial, got,
                                                             want)


def url_hash(u):
    """The kernel's hash of a URL: murmur3's finalizer on its two halves
    XORed."""
    x = (u ^ (u >> 32)) & 0xFFFFFFFF
    x ^= (11 * 0x9E3779B9 + 0x85EBCA6B) & 0xFFFFFFFF
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & 0xFFFFFFFF
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)


def twin_model(u, f_url, f_valid, *, cap):
    """The kernel's lowest-column twin of URL u in one row, or -1: the valid
    cells compacted in column order (the whole row when at most ``cap``
    are valid, else ``cap`` columns at a time, in order) into a
    linear-probing hash of 2 * ``cap`` slots that keeps the lowest index of
    each URL."""
    C = len(f_url)
    cols = [c for c in range(C) if f_valid[c]]
    chunks = ([cols] if len(cols) <= cap else
              [[c for c in cols if c0 <= c < c0 + cap]
               for c0 in range(0, C, cap)])
    for chunk in chunks:
        urls = [int(f_url[c]) for c in chunk]
        slots = [-1] * (2 * cap)
        for i, x in enumerate(urls):
            h = url_hash(x) % (2 * cap)
            while slots[h] >= 0 and urls[slots[h]] != x:
                h = (h + 1) % (2 * cap)
            slots[h] = i if slots[h] < 0 else min(slots[h], i)
        h = url_hash(u) % (2 * cap)
        while slots[h] >= 0:
            if urls[slots[h]] == u:
                return chunk[slots[h]]
            h = (h + 1) % (2 * cap)
    return -1


@pytest.mark.parametrize("C,fill,cap", [
    (64, 0.3, 1024), (2048, 0.6, 1024), (600, 0.6, 1024), (300, 0.5, 64),
    (300, 0.9, 16)])
def test_twin_lookup_model_matches_first_twin(C, fill, cap):
    """In one piece and in chunks (the shipped sizes, then small ones so
    that a 300-cell row takes five chunks, or 19 nearly full ones), on the
    card cases' rows: the same cell as ``first_twin`` for every live
    lane."""
    bits, urls, mask, val, f_url, f_valid, table = twin_case(
        2, 300, C, 12, seed=C, queue_fill=fill)
    hit, cell = first_twin(torch.tensor(urls), torch.tensor(mask),
                           sorted_queue(torch.tensor(f_url),
                                        torch.tensor(f_valid)))
    want = np.where(hit.numpy(), cell.numpy(), -1)
    for r in range(urls.shape[0]):
        for m in np.nonzero(mask[r])[0]:
            assert twin_model(int(urls[r, m]), f_url[r], f_valid[r],
                              cap=cap) == want[r, m]
