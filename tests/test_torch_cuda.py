"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX (the machine with the card has none), so that

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

runs it there; without a card every test skips. Inputs are made with numpy
from a seed, and the crawl kernels must equal their plain versions exactly;
flash_attention must agree with its plain version within the reference's
tolerances (2e-5 f32, 2e-2 bf16), since the two sum in different orders;
flash_attention_tc also within a few bf16 ulps of a plain version that
rounds p to bf16 as it does."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs import webparf  # noqa: E402
from repro_torch.core.stages import state_to_numpy  # noqa: E402
from repro_torch.kernels.bloom import ops as BOPS  # noqa: E402
from repro_torch.kernels.bloom.ref import (  # noqa: E402
    bloom_packed_ref, bloom_ref, pack_bits)
from repro_torch.configs.base import scaled  # noqa: E402
from repro_torch.kernels.dedup_deposit import ops as DOPS  # noqa: E402
from repro_torch.kernels.dedup_deposit.ref import (  # noqa: E402
    dedup_deposit_packed_ref, dedup_deposit_ref)
from repro_torch.kernels.flash_attention import ops as FOPS  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_ref  # noqa: E402
from repro_torch.kernels.frontier_select import ops as SOPS  # noqa: E402
from repro_torch.kernels.frontier_select.ref import (  # noqa: E402
    NEG, select_harvest_ref, select_ref)
from repro_torch.kernels.opic_update import ops as OOPS  # noqa: E402
from repro_torch.kernels.opic_update.ref import opic_ref  # noqa: E402
from repro_torch.ordering.opic import total_cash  # noqa: E402
from _twin_cases import TWIN_CASES, twin_case  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def rows(R, C, *, seed, fill=0.6, ties=False):
    """Frontier rows: invalid cells hold NEG; row 0 empty, row 1 full."""
    rng = np.random.default_rng(seed)
    url = rng.integers(1, 1 << 30, (R, C)).astype(np.int64)
    valid = rng.random((R, C)) < fill
    if R > 1:
        valid[0], valid[1] = False, True
    pri = (rng.integers(0, 3, (R, C)) if ties else
           rng.permutation(R * C).reshape(R, C)).astype(np.float32)
    return url, np.where(valid, pri, np.float32(NEG)), valid


# The pop kernel's cases beyond the first five: C not a multiple of 4 (the
# scalar path), k = C (whole rows popped), unaligned views (the scalar path
# at C % 4 == 0), rows past register residency (C > 8192: keys in shared
# memory; 70000: past shared memory, a read of the row a round), fewer
# valid cells than k, an all-equal row, and the CLI's and the reduced
# config's widths (512, 64: several rows a block).
POP_SHAPES = [(3, 1001, 5), (2, 37, 37), (4, 4096, 3), (2, 16384, 4),
              (2, 20000, 3), (2, 70000, 3), (4, 128, 8), (3, 256, 6),
              (64, 512, 1), (16, 64, 1), (64, 512, 3), (16, 64, 5)]
# (R, C, k) -> the rows' layout where it is not rows()' own: "unaligned"
# (pri and valid are contiguous views one element into larger buffers),
# "sparse" (3% of the cells valid), "equal" (the last row holds one key in
# every cell)
POP_LAYOUT = {(4, 4096, 3): "unaligned", (4, 128, 8): "sparse",
              (3, 256, 6): "equal"}


def pop_rows(device, R, C, k, *, fill=0.6, ties=False):
    """(url, pri, valid) on ``device`` laid out as POP_LAYOUT says, and
    whether the kernel takes its vector path on them."""
    layout = POP_LAYOUT.get((R, C, k))
    url, pri, valid = rows(R, C, seed=R + C + k, ties=ties,
                           fill=0.03 if layout == "sparse" else fill)
    if layout == "equal":
        pri[-1], valid[-1] = 7.0, True
    u = torch.tensor(url, device=device)
    p, v = torch.tensor(pri, device=device), torch.tensor(valid, device=device)
    if layout == "unaligned":
        bp = torch.empty(R * C + 1, dtype=p.dtype, device=device)
        bv = torch.empty(R * C + 1, dtype=v.dtype, device=device)
        p = bp[1:].view(R, C).copy_(p)
        v = bv[1:].view(R, C).copy_(v)
    return u, p, v, C % 4 == 0 and layout != "unaligned"


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("R,C,k", [(1, 32, 1), (4, 64, 4), (2, 128, 8),
                                   (3, 37, 5), (512, 4096, 1)] + POP_SHAPES)
def test_select_kernel_matches_plain(cuda, R, C, k, ties):
    u, p1, v1, vec = pop_rows(cuda, R, C, k, ties=ties)
    assert SOPS.vector_path(p1, v1) == vec
    p2, v2 = p1.clone(), v1.clone()
    n0 = SOPS.KERNEL.launches
    got = SOPS.select(u, p1, v1, k=k, return_idx=True)
    want = select_ref(u, p2, v2, k=k, return_idx=True)
    torch.cuda.synchronize()
    assert SOPS.KERNEL.launches == n0 + 1
    for a, b in zip((*got, p1, v1), (*want, p2, v2)):
        assert torch.equal(a, b)


def batch(R, M, b, *, seed, dup=0.0, fill=0.7, prefill=0, masked_row=False,
          k_prefill=3, device="cpu"):
    """(bits on ``device``, urls, mask) with repeats within and across
    tiles; the URLs of each row's first ``prefill`` lanes inserted before
    (by the plain version, with ``k_prefill`` hashes). ``fill`` is the share
    of live lanes, or one of the crawl's sparse layouts at about 4 live
    lanes a row: "front" (packed at the row's front, as the dispatch packs
    them; some rows empty) or "scattered" (anywhere in the row)."""
    rng = np.random.default_rng(seed)
    urls = rng.integers(0, 1 << 30, (R, M)).astype(np.int64)
    rep = rng.random((R, M)) < dup
    urls = np.where(rep, urls[np.arange(R)[:, None],
                              rng.integers(0, M, (R, M))], urls)
    if fill == "front":
        mask = np.arange(M)[None] < rng.poisson(4, R)[:, None]
    elif fill == "scattered":
        mask = rng.random((R, M)) < 4 / M
    else:
        mask = rng.random((R, M)) < fill
    if masked_row:
        mask[-1] = False
    bits = torch.zeros((R, 1 << b), dtype=torch.uint8, device=device)
    if prefill:
        bloom_ref(bits, torch.tensor(urls[:, :prefill], device=device),
                  torch.ones((R, prefill), dtype=torch.bool, device=device),
                  k=k_prefill)
    return bits, urls, mask


@pytest.mark.parametrize("R,M,b,k,dup,prefill,masked_row", [
    (1, 256, 10, 2, 0.0, 0, False), (4, 256, 12, 4, 0.0, 0, False),
    (2, 512, 14, 3, 0.0, 0, False), (8, 512, 11, 5, 0.0, 0, False),
    (2, 512, 12, 4, 0.5, 0, False), (3, 300, 10, 4, 0.4, 64, True),
    (2, 100, 9, 3, 0.6, 16, False), (16, 4096, 24, 4, 0.3, 512, True)])
def test_bloom_kernel_matches_plain(cuda, R, M, b, k, dup, prefill,
                                   masked_row):
    bits, urls, mask = batch(R, M, b, seed=R + M, dup=dup, prefill=prefill,
                             masked_row=masked_row)
    b1 = bits.to(cuda)
    b2 = b1.clone()
    u = torch.tensor(urls, device=cuda)
    m = torch.tensor(mask, device=cuda)
    n0 = BOPS.KERNEL.launches
    s1 = BOPS.probe_insert(b1, u, m, k=k)
    s2 = bloom_ref(b2, u, m, k=k, url_tile=min(256, M))
    torch.cuda.synchronize()
    assert BOPS.KERNEL.launches == n0 + 1
    assert torch.equal(s1, s2) and torch.equal(b1, b2)
    if prefill:
        assert bool(s1.any())


@pytest.mark.parametrize("R,M,b,k,dup,prefill,masked_row", [
    (2, 256, 12, 4, 0.0, 0, False), (4, 512, 11, 3, 0.0, 0, False),
    (2, 128, 5, 4, 0.5, 8, False), (3, 300, 7, 4, 0.4, 64, True),
    (2, 100, 9, 3, 0.6, 16, False), (16, 4096, 24, 4, 0.3, 512, True)])
def test_bloom_packed_kernel_matches_plain(cuda, R, M, b, k, dup, prefill,
                                          masked_row):
    """On int32 words with bit 31 set in many of them; rows of one word (b
    5), where every URL of a tile collides on it."""
    bits, urls, mask = batch(R, M, b, seed=R + M + 1, dup=dup,
                             prefill=prefill, masked_row=masked_row)
    bits[:, 31::64] = 1
    w1 = pack_bits(bits).to(cuda)
    w2 = w1.clone()
    u = torch.tensor(urls, device=cuda)
    m = torch.tensor(mask, device=cuda)
    n0 = BOPS.PACKED.launches
    s1 = BOPS.probe_insert_packed(w1, u, m, k=k)
    s2 = bloom_packed_ref(w2, u, m, k=k, url_tile=min(256, M))
    torch.cuda.synchronize()
    assert BOPS.PACKED.launches == n0 + 1
    assert torch.equal(s1, s2) and torch.equal(w1, w2)
    assert bool((w1 < 0).any())
    if dup or prefill:
        assert bool(s1.any())


# (R, M, b, k, tile, fill, dup, prefill, masked_row): the crawl's (512,
# 4,096) at b 24 with ~4 live lanes a row, packed at the front and
# scattered, URLs inserted before re-sent; an all-masked batch; M past the
# kernel's 4,096-lane window and M not a multiple of the tile; tiles of 1
# and 1,024 (4 items a thread); dense tiles; k 1, 8, 9 and 33 (past the
# 32 found bits a thread keeps); small filters
# (b 5-9), where a later tile is seen through bits that earlier tiles set,
# some already in the filter. The filter is made on the card, the prefill
# with the batch's own k.
LAYOUT_CASES = [
    (512, 4096, 24, 4, 256, "front", 0.3, 2, False),
    (512, 4096, 24, 4, 256, "scattered", 0.3, 2048, False),
    (8, 512, 12, 4, 256, 0.0, 0.0, 64, False),
    (4, 5000, 14, 4, 256, 0.3, 0.4, 64, False),
    (2, 10000, 16, 4, 256, 0.05, 0.5, 0, True),
    (3, 300, 10, 3, 1, 0.7, 0.5, 16, False),
    (2, 5000, 14, 4, 1024, 0.05, 0.5, 0, False),
    (4, 1024, 12, 8, 256, 0.95, 0.3, 0, False),
    (2, 2048, 14, 4, 1024, 0.95, 0.3, 64, False),
    (3, 700, 8, 1, 128, 0.6, 0.5, 0, False),
    (2, 600, 10, 8, 128, 0.5, 0.4, 32, False),
    (2, 600, 10, 9, 128, 0.5, 0.4, 32, False),
    (2, 600, 14, 33, 128, 0.5, 0.4, 32, False),
    (3, 512, 5, 2, 32, 0.5, 0.0, 4, False),
    (3, 512, 7, 3, 64, 0.3, 0.0, 8, False),
    (2, 1024, 9, 4, 128, 0.2, 0.2, 16, False)]


@pytest.mark.parametrize("R,M,b,k,tile,fill,dup,prefill,masked_row",
                         LAYOUT_CASES)
def test_bloom_kernel_layouts_match_plain(cuda, R, M, b, k, tile, fill, dup,
                                          prefill, masked_row):
    b1, urls, mask = batch(R, M, b, seed=R + M + k + tile, dup=dup,
                           fill=fill, prefill=prefill, masked_row=masked_row,
                           k_prefill=k, device=cuda)
    b2 = b1.clone()
    u = torch.tensor(urls, device=cuda)
    m = torch.tensor(mask, device=cuda)
    n0 = BOPS.KERNEL.launches
    s1 = BOPS.probe_insert(b1, u, m, k=k, url_tile=tile)
    s2 = bloom_ref(b2, u, m, k=k, url_tile=min(tile, M))
    torch.cuda.synchronize()
    assert BOPS.KERNEL.launches == n0 + 1
    assert torch.equal(s1, s2) and torch.equal(b1, b2)
    if prefill and mask.any():
        assert bool(s1.any())


@pytest.mark.parametrize("R,M,b,k,tile,fill,dup,prefill,masked_row",
                         LAYOUT_CASES + [
                             (4, 700, 5, 3, 64, 0.6, 0.3, 0, False),
                             (2, 2048, 5, 8, 1024, 0.9, 0.0, 0, False)])
def test_bloom_packed_kernel_layouts_match_plain(cuda, R, M, b, k, tile,
                                                 fill, dup, prefill,
                                                 masked_row):
    """As above on int32 words with bit 31 set in many of them; rows of one
    word (b 5), where every URL of a tile collides on it."""
    bits, urls, mask = batch(R, M, b, seed=R + M + k + tile + 1, dup=dup,
                             fill=fill, prefill=prefill,
                             masked_row=masked_row, k_prefill=k, device=cuda)
    bits[:, 31::64] = 1
    w1 = pack_bits(bits)
    del bits
    w2 = w1.clone()
    u = torch.tensor(urls, device=cuda)
    m = torch.tensor(mask, device=cuda)
    n0 = BOPS.PACKED.launches
    s1 = BOPS.probe_insert_packed(w1, u, m, k=k, url_tile=tile)
    s2 = bloom_packed_ref(w2, u, m, k=k, url_tile=min(tile, M))
    torch.cuda.synchronize()
    assert BOPS.PACKED.launches == n0 + 1
    assert torch.equal(s1, s2) and torch.equal(w1, w2)
    assert bool((w1 < 0).any())
    if (dup or prefill) and mask.any():
        assert bool(s1.any())


@pytest.mark.parametrize("R,C,k,fill", [(4, 64, 4, 0.6), (2, 128, 8, 1.0),
                                        (3, 37, 5, 0.0), (512, 4096, 1, 0.6)]
                         + [(*s, 0.6) for s in POP_SHAPES])
def test_select_harvest_kernel_matches_plain(cuda, R, C, k, fill):
    """On the url lane as the stages hold it: a strided view of a wider
    array, with 0 cash on invalid cells."""
    u, p1, v1, vec = pop_rows(cuda, R, C, k, fill=fill)
    assert SOPS.vector_path(p1, v1) == vec
    lane = np.random.default_rng(R).random((R, C)) * v1.cpu().numpy()
    wide = torch.zeros((R, 2 + C), device=cuda)
    wide[:, 2:] = torch.tensor(lane, dtype=torch.float32, device=cuda)
    p2, v2, w2 = p1.clone(), v1.clone(), wide.clone()
    n0 = SOPS.HARVEST.launches
    got = SOPS.select_harvest(u, p1, v1, wide[:, 2:], k=k)
    want = select_harvest_ref(u, p2, v2, w2[:, 2:], k=k)
    torch.cuda.synchronize()
    assert SOPS.HARVEST.launches == n0 + 1
    for a, b in zip((*got, p1, v1, wide), (*want, p2, v2, w2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,R,N,tile,skew", [
    (1, 512, 8192, 256, None), (3, 5, 300, 64, None), (2, 64, 77, 256, None),
    (512, 4096, 4096, 256, None),
    (1, 512, 8192, 256, "half"),            # skewed spend
    (1, 512, 8192, 256, "one"),             # every item on one target
    (3, 64, 4000, 32, "one"),
    (2, 100, 20000, 1024, None),            # N past one chunk of 8192
    (1, 300, 17000, 256, "half"),
    (1, 10000, 3000, 256, None),            # R past one range of 4096
    (3, 9000, 5000, 128, None)])
def test_opic_update_kernel_matches_plain(cuda, B, R, N, tile, skew):
    """Duplicate targets, wrapping and out-of-range rows, a masked row;
    skewed items ("half": every other item on one target; "one": every
    item, through the wrap at -1), several chunks, several ranges."""
    rng = np.random.default_rng(B + R + N)
    cash = torch.tensor(rng.random((B, R)), dtype=torch.float32, device=cuda)
    rows_ = rng.integers(-R - 2, R + 2, (B, N))
    if skew == "half":
        rows_[:, ::2] = R // 3
    elif skew == "one":
        rows_[:] = -1
    rows_ = torch.tensor(rows_, device=cuda)
    contrib = torch.tensor(rng.random((B, N)) * 10.0 ** rng.integers(
        -6, 3, (B, N)), dtype=torch.float32, device=cuda)
    mask = torch.tensor(rng.random((B, N)) < 0.8, device=cuda)
    if B > 1:
        mask[-1] = False
    c2, cash0 = cash.clone(), cash.clone()
    n0 = OOPS.KERNEL.launches
    OOPS.scatter_cash(cash, rows_, contrib, mask, tile=tile)
    opic_ref(c2, rows_, contrib, mask, tile=tile)
    torch.cuda.synchronize()
    assert OOPS.KERNEL.launches == n0 + 1
    assert torch.equal(cash, c2) and not torch.equal(cash, cash0)


@pytest.mark.parametrize("R,C,M", [(5, 16, 40), (512, 4096, 4096)])
def test_opic_update_cells_on_the_strided_lane(cuda, R, C, M):
    """scatter_cash_cells' row-aligned form on the url lane as the stages
    hold it (a strided view of a wider array), a few live items a row."""
    rng = np.random.default_rng(R + C)
    wide = torch.zeros((R, 2 + C), device=cuda)
    wide[:, 2:] = torch.tensor(rng.random((R, C)), dtype=torch.float32,
                               device=cuda)
    w2 = wide.clone()
    cols = torch.tensor(rng.integers(-1, C + 1, (R, M)), device=cuda)
    vals = torch.tensor(rng.random((R, M)), dtype=torch.float32, device=cuda)
    fits = torch.tensor(rng.random((R, M)) < 0.05, device=cuda)
    n0 = OOPS.KERNEL.launches
    OOPS.scatter_cash_cells(wide[:, 2:], None, cols, vals, fits)
    opic_ref(w2[:, 2:], cols, vals, fits & (cols >= 0) & (cols < C))
    torch.cuda.synchronize()
    assert OOPS.KERNEL.launches == n0 + 1
    assert torch.equal(wide, w2)


def dedup_case(R, M, C, b, dup, cuda, *, seed):
    """Queued twins (a URL queued twice among them), URLs inserted before
    and gone, repeats within and across tiles, a masked row. Returns the
    byte-per-bit filter (on the CPU), the arguments after it (on the card)
    and the url lane as a strided view of a wider array."""
    rng = np.random.default_rng(seed)
    f_url = rng.integers(1, 1 << 20, (R, C))
    f_url[:, 1] = f_url[:, 2]
    f_valid = rng.random((R, C)) < 0.7
    pick = rng.random((R, M))
    queued = np.take_along_axis(f_url, rng.integers(0, C, (R, M)), axis=1)
    gone = rng.integers(1 << 20, 1 << 21, (R, M))
    urls = np.where(pick < dup / 2, queued,
                    np.where(pick < dup, gone,
                             rng.integers(1 << 21, 1 << 22, (R, M))))
    urls[:, M // 2:] = np.where(rng.random((R, M - M // 2)) < dup,
                                urls[:, :M - M // 2], urls[:, M // 2:])
    mask = rng.random((R, M)) < 0.8
    if R > 1:
        mask[-1] = False
    bits = torch.zeros((R, 1 << b), dtype=torch.uint8)
    bloom_ref(bits, torch.tensor(np.concatenate([f_url, gone], 1)),
              torch.tensor(np.concatenate([f_valid, np.ones_like(mask)], 1)),
              k=4)
    t = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    args = [t(urls), t(mask), t(rng.random((R, M)).astype(np.float32)),
            t(f_url), t(f_valid)]
    wide = torch.zeros((R, 2 + C), device=cuda)
    wide[:, 2:] = torch.tensor(rng.random((R, C)) * f_valid,
                               dtype=torch.float32, device=cuda)
    return bits, args, wide


@pytest.mark.parametrize("R,M,C,b,tile,dup", [
    (1, 64, 32, 10, 32, 0.3), (4, 96, 64, 12, 32, 0.5),
    (3, 300, 50, 10, 128, 0.5), (2, 100, 40, 9, 256, 0.9),
    (16, 4096, 4096, 24, 256, 0.3)])
def test_dedup_deposit_kernel_matches_plain(cuda, R, M, C, b, tile, dup):
    """Queued twins (a URL queued twice among them), URLs inserted before
    and gone, repeats within and across tiles, a masked row."""
    bits, args, wide = dedup_case(R, M, C, b, dup, cuda, seed=R + M + C)
    b1, w1 = bits.to(cuda), wide.clone()
    b2, w2 = b1.clone(), wide.clone()
    n0 = DOPS.KERNEL.launches
    s1, r1 = DOPS.dedup_deposit(b1, *args, w1[:, 2:], k=4, url_tile=tile)
    s2, r2 = dedup_deposit_ref(b2, *args, w2[:, 2:], k=4,
                               url_tile=min(tile, M))
    torch.cuda.synchronize()
    assert DOPS.KERNEL.launches == n0 + 1
    for a, b_ in ((s1, s2), (b1, b2), (w1, w2), (r1, r2)):
        assert torch.equal(a, b_)
    assert bool(s1.any()) and not torch.equal(w1, wide)


@pytest.mark.parametrize("R,M,C,b,tile,dup", [
    (1, 64, 32, 10, 32, 0.3), (4, 96, 64, 12, 32, 0.5),
    (3, 300, 50, 10, 128, 0.5), (2, 100, 40, 5, 256, 0.9),
    (16, 4096, 4096, 24, 256, 0.3)])
def test_dedup_deposit_packed_kernel_matches_plain(cuda, R, M, C, b, tile,
                                                  dup):
    """The packed kernel against its plain version, and the packed entry
    (``packed=True``: pack, kernel, unpack) against the byte-per-bit kernel,
    on the same inputs; rows of one word (b 5) among them."""
    bits, args, wide = dedup_case(R, M, C, b, dup, cuda,
                                  seed=R + M + C + b)
    w1 = pack_bits(bits).to(cuda)
    w2, wide1, wide2 = w1.clone(), wide.clone(), wide.clone()
    n0 = DOPS.PACKED.launches
    s1, r1 = DOPS.dedup_deposit_packed(w1, *args, wide1[:, 2:], k=4,
                                       url_tile=tile)
    s2, r2 = dedup_deposit_packed_ref(w2, *args, wide2[:, 2:], k=4,
                                      url_tile=min(tile, M))
    torch.cuda.synchronize()
    assert DOPS.PACKED.launches == n0 + 1
    for a, b_ in ((s1, s2), (w1, w2), (wide1, wide2), (r1, r2)):
        assert torch.equal(a, b_)
    assert bool(s1.any()) and not torch.equal(wide1, wide)
    b3, b4 = bits.to(cuda), bits.clone().to(cuda)
    wide3, wide4 = wide.clone(), wide.clone()
    s3, r3 = DOPS.dedup_deposit(b3, *args, wide3[:, 2:], k=4, url_tile=tile,
                                packed=True)
    s4, r4 = DOPS.dedup_deposit(b4, *args, wide4[:, 2:], k=4, url_tile=tile)
    torch.cuda.synchronize()
    assert DOPS.PACKED.launches == n0 + 2
    for a, b_ in ((s3, s4), (b3, b4), (wide3, wide4), (r3, r4), (s3, s1),
                  (wide3, wide1)):
        assert torch.equal(a, b_)
    assert torch.equal(pack_bits(b3), w1)


@pytest.mark.parametrize("ordering,fused", [("opic", True),
                                            ("opic_url", True),
                                            ("opic_url", False)])
def test_opic_session_on_card_matches_cpu(cuda, ordering, fused):
    """The OPIC crawls through the kernels equal the crawls through the
    plain versions, in every output and state leaf, and conserve cash."""
    cfg = scaled(webparf.reduced(), ordering=ordering, fused_dispatch=fused,
                 link_pop_bias=1.0)
    reps, states = {}, {}
    for dev in (cuda, "cpu"):
        sess = CrawlSession(cfg, device=dev)
        key = torch.device(dev).type
        reps[key], states[key] = sess.run(48), state_to_numpy(sess.state)
        np.testing.assert_allclose(total_cash(sess.state), cfg.n_domains,
                                   rtol=1e-6)
    np.testing.assert_array_equal(reps["cuda"].urls, reps["cpu"].urls)
    assert reps["cuda"].stats == reps["cpu"].stats
    for name in states["cpu"]:
        np.testing.assert_array_equal(states["cuda"][name],
                                      states["cpu"][name], err_msg=name)


def test_session_on_card_matches_cpu(cuda):
    """The crawl through the kernels equals the crawl through the plain
    versions, in every output and state leaf."""
    cfg = webparf.reduced()
    reps, states = {}, {}
    for dev in (cuda, "cpu"):
        sess = CrawlSession(cfg, device=dev)
        key = torch.device(dev).type
        reps[key], states[key] = sess.run(48), state_to_numpy(sess.state)
    np.testing.assert_array_equal(reps["cuda"].urls, reps["cpu"].urls)
    np.testing.assert_array_equal(reps["cuda"].per_step,
                                  reps["cpu"].per_step)
    assert reps["cuda"].stats == reps["cpu"].stats
    assert reps["cuda"].stats["dedup_bloom"] > 0
    for name in states["cpu"]:
        np.testing.assert_array_equal(states["cuda"][name],
                                      states["cpu"][name], err_msg=name)


def test_score_fn_override_on_card_equals_default(cuda):
    """``score_fn=ranker.score_urls`` on the card is the default backlink
    crawl in every output and state leaf."""
    from repro_torch.core import ranker
    cfg = webparf.reduced()
    reps, states = {}, {}
    for key, kw in (("default", {}), ("score_fn",
                                      {"score_fn": ranker.score_urls})):
        sess = CrawlSession(cfg, device=cuda, n_shards=4, **kw)
        reps[key], states[key] = sess.run(16), state_to_numpy(sess.state)
    np.testing.assert_array_equal(reps["default"].urls,
                                  reps["score_fn"].urls)
    assert reps["default"].stats == reps["score_fn"].stats
    for name in states["default"]:
        np.testing.assert_array_equal(states["default"][name],
                                      states["score_fn"][name],
                                      err_msg=name)


def test_serve_session_on_card_matches_cpu(cuda):
    """ServeSession at reduced() with 4 shards, through a fail and a heal:
    the index leaves, the served answers and their scores, the lags,
    arrivals, recall and the crawl identical on the card and the CPU (the
    port's scores are correctly rounded and add in one order)."""
    from _torch_serve_play import play
    case = {"shards": 4,
            "serve": dict(qps=3.0, load_seed=0, doc_len=16, vocab=512,
                          top_k=5, index_capacity=1024),
            "ops": [["run", 8, False], ["fail", 1], ["run", 4, False],
                    ["heal"], ["run", 8, True]]}
    got = {torch.device(d).type: play(case, device=d) for d in (cuda, "cpu")}
    (sa, ra), (sb, rb) = got["cuda"], got["cpu"]
    for i in ra:
        a, b = ra[i], rb[i]
        assert a.n_queries > 0
        for f in ("top_urls", "top_scores", "lag_steps", "arrival_step"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"run {i}: {f}")
        assert (a.recall_at_k, a.index) == (b.recall_at_k, b.index)
        np.testing.assert_array_equal(a.crawl.urls, b.crawl.urls)
    for x, y in zip(sa.index, sb.index):
        np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())


CLI_SIZE = dict(n_domains=32, frontier_capacity=512, fetch_batch=32,
                bloom_bits_log2=16, dispatch_capacity=1024,
                url_space_log2=24)             # launch/crawl.py's defaults


@pytest.mark.parametrize("ordering,fused", [("backlink", True),
                                            ("opic", True),
                                            ("opic_url", True),
                                            ("opic_url", False)])
def test_four_shard_crawl_on_card_matches_cpu(cuda, ordering, fused):
    """A 4-shard CLI-size crawl through the kernels equals the crawl
    through the plain versions in every output and state leaf."""
    cfg = scaled(webparf.CONFIG, ordering=ordering, fused_dispatch=fused,
                 link_pop_bias=0.0 if ordering == "backlink" else 1.0,
                 **CLI_SIZE)
    reps, states = {}, {}
    for dev in (cuda, "cpu"):
        sess = CrawlSession(cfg, device=dev, n_shards=4)
        key = torch.device(dev).type
        reps[key], states[key] = sess.run(32), state_to_numpy(sess.state)
    np.testing.assert_array_equal(reps["cuda"].urls, reps["cpu"].urls)
    np.testing.assert_array_equal(reps["cuda"].per_step,
                                  reps["cpu"].per_step)
    assert reps["cuda"].stats == reps["cpu"].stats
    assert (reps["cuda"].stats_per_shard["fetched"] > 0).all()
    for name in states["cpu"]:
        np.testing.assert_array_equal(states["cuda"][name],
                                      states["cpu"][name], err_msg=name)


@pytest.mark.parametrize("ordering,fused", [("backlink", True),
                                            ("opic", True),
                                            ("opic_url", True),
                                            ("opic_url", False)])
def test_four_shard_launches_equal_one_shard(cuda, ordering, fused):
    """Each kernel launches as many times in 4 shards' steps as in one
    shard's: the shards are batched, not looped. A fetch batch of 8 makes
    both paths enforce the fetch budget (at the CLI's 32, 4 shards of 16
    rows fit it and skip the budget's give-back), so both run the same
    stages."""
    from repro_torch.kernels import launch_counts, reset_launches
    cfg = scaled(webparf.CONFIG, ordering=ordering, fused_dispatch=fused,
                 link_pop_bias=0.0 if ordering == "backlink" else 1.0,
                 **{**CLI_SIZE, "fetch_batch": 8})
    counts = {}
    for n_shards in (1, 4):
        sess = CrawlSession(cfg, device=cuda, n_shards=n_shards)
        reset_launches()
        sess.run(16)
        torch.cuda.synchronize()
        counts[n_shards] = launch_counts()
    assert counts[4] == counts[1] and sum(counts[4].values()) >= 16


def test_four_shard_heal_on_card_matches_cpu(cuda):
    """Shard 1 fails at a dispatch boundary and is healed at the next: the
    card and the CPU agree in every leaf, and the cash balances."""
    cfg = scaled(webparf.CONFIG, ordering="opic_url", link_pop_bias=1.0,
                 **CLI_SIZE)
    iv = cfg.dispatch_interval
    states = {}
    for dev in (cuda, "cpu"):
        sess = CrawlSession(cfg, device=dev, n_shards=4)
        sess.run(iv)
        sess.inject_failure(1)
        sess.run(iv)
        cash = total_cash(sess.state)
        sess.heal()
        np.testing.assert_allclose(total_cash(sess.state), cash, rtol=1e-6)
        sess.run(2 * iv)
        states[torch.device(dev).type] = state_to_numpy(sess.state)
    for name in states["cpu"]:
        np.testing.assert_array_equal(states["cuda"][name],
                                      states["cpu"][name], err_msg=name)


def tc_plain(q, k, v, causal, block=64):
    """What flash_attention_tc computes, in plain f32: the online softmax
    over 64-key tiles in order, scores scaled by 1/sqrt(hd) and log2(e) in
    f32, p = exp2(s - m) with the running max m, l the sum of the f32 p,
    acc += bf16(p) . v; returns acc / max(l, 1e-30) and l. Only p's
    rounding to bf16 (and the exp2 form) sets it apart from flash_ref."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    f32 = torch.float32
    qf = q.to(f32)
    kf = k.to(f32).repeat_interleave(Hq // Hkv, dim=1)
    vf = v.to(f32).repeat_interleave(Hq // Hkv, dim=1)
    scale2 = (torch.tensor(1 / math.sqrt(hd), dtype=f32)
              * torch.tensor(1.4426950408889634, dtype=f32)).item()
    m = torch.full((B, Hq, Sq, 1), -1e30, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hq, Sq, hd), dtype=f32, device=q.device)
    rows = torch.arange(Sq, device=q.device)[:, None]
    for k0 in range(0, Skv, block):
        kt, vt = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        s = (qf @ kt.transpose(-1, -2)) * scale2
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2], device=q.device)
            s = s.masked_fill(rows < cols, -1e30)
        n = torch.maximum(m, s.amax(-1, keepdim=True))
        c = torch.exp2(m - n)
        p = torch.exp2(s - n)
        l = l * c + p.sum(-1, keepdim=True)
        acc = acc * c + p.to(torch.bfloat16).to(f32) @ vt
        m = n
    return acc / l.clamp_min(1e-30), l


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (0 at 0)."""
    a = x.abs()
    _, e = torch.frexp(a)
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8),
                       torch.zeros_like(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd,group,S", [(8, 1, 32), (16, 3, 192),
                                        (32, 6, 256), (64, 1, 192),
                                        (96, 6, 32), (128, 6, 256),
                                        (128, 3, 100), (128, 1, 100),
                                        (128, 6, 192), (64, 6, 100),
                                        (96, 1, 192), (128, 6, 2048)])
def test_flash_attention_kernel_matches_plain(cuda, hd, group, S, causal,
                                              dtype):
    """Every head dim the kernels instantiate, GQA groups, ragged tiles;
    q, k, v as the projections lay them out ((B, S, H, hd) transposed).
    Each case launches the kernel its route names, once, and no other.
    flash_attention_tc is also held to tc_plain, which rounds p to bf16 as
    it does: within 2 bf16 ulps of |want| (the output's rounding) plus two
    p's rounded to the other bf16 neighbour, each at most 2^-7 max|v| / l
    (l the row's softmax sum in units of its largest term)."""
    rng = np.random.default_rng(hd + group + S)
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(rng.standard_normal((2, S, H, hd)),
                            dtype=torch.float32).to(cuda, dt).transpose(1, 2)
               for H in (2 * group, 2, 2))
    name = FOPS.route("cuda", dt, hd).name
    assert name == ("flash_attention_tc" if dtype == "bfloat16" and
                    hd in (64, 96, 128) else "flash_attention")
    n0 = (FOPS.KERNEL.launches, FOPS.TC_KERNEL.launches)
    got = FOPS.attention(q, k, v, causal=causal)
    qg, kf, vf, g = FOPS._gqa_fold(q, k, v)
    want = flash_ref(qg, kf, vf, causal=causal, group=g).reshape(q.shape)
    torch.cuda.synchronize()
    tc = name == "flash_attention_tc"
    assert (FOPS.KERNEL.launches, FOPS.TC_KERNEL.launches) == \
        (n0[0] + (not tc), n0[1] + tc)
    assert got.dtype == dt and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    if tc:
        want, l = tc_plain(q, k, v, causal)
        vmax = v.float().abs().amax(dim=2, keepdim=True).repeat_interleave(
            group, dim=1)
        err = (got.float() - want).abs()
        assert bool((err <= 2 * bf16_ulp(want)
                     + 2 * 2.0 ** -7 * vmax / l).all()), float(err.max())


def test_lm_on_card_matches_cpu(cuda):
    """The reduced qwen2 in f32 with the same weights on both devices:
    prefill (through the kernel) and 8 teacher-forced decode steps give
    logits within 1e-4. TF32 is off, as it would round the products."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = scaled(get_reduced("qwen2-1.5b"), dtype="float32")
        cpu = T.init_lm(cfg, seed=0, device="cpu")
        card = T.params_from_numpy(cfg, T.params_to_numpy(cpu), device=cuda)
        toks = torch.tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 24)))
        n0 = FOPS.KERNEL.launches
        out = {}
        for name, m in (("cuda", card), ("cpu", cpu)):
            t = toks.to(m.device)
            lg, cache = T.prefill_step(m, t[:, :16], max_len=24)
            logs = [lg]
            for i in range(16, 24):
                lg, cache = T.decode_step(m, t[:, i:i + 1], cache)
                logs.append(lg)
            out[name] = torch.cat(logs, 1).cpu()
        assert FOPS.KERNEL.launches == n0 + cfg.n_layers
        np.testing.assert_allclose(out["cuda"].numpy(), out["cpu"].numpy(),
                                   rtol=0, atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("theta", [1e4, 1e5, 5e5, 1e6])
@pytest.mark.parametrize("hd", [8, 16, 64, 96, 128])
def test_rope_on_card_equals_cpu(cuda, hd, theta):
    """RoPE's inverse frequencies on the card equal the CPU's bit for bit
    (which equal the reference's, tests/test_torch_lm.py), and apply_rope
    in f32 at positions 524,272-524,287 agrees within 1e-6."""
    from repro_torch.models import layers as L
    card = L.rope_freqs(hd, theta, cuda).cpu()
    host = L.rope_freqs(hd, theta, "cpu")
    assert torch.equal(card.view(torch.int32), host.view(torch.int32))
    x = torch.tensor(np.random.default_rng(hd).standard_normal(
        (2, 2, 16, hd)), dtype=torch.float32)
    pos = torch.arange(524272, 524288)
    got = L.apply_rope(x.to(cuda), pos.to(cuda), theta).cpu()
    assert float((got - L.apply_rope(x, pos, theta)).abs().max()) <= 1e-6


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("R,M,C,b,tile,fill", TWIN_CASES)
def test_dedup_deposit_twins_on_card(cuda, R, M, C, b, tile, fill, packed):
    """Both layouts on re-sent queued URLs, with values of mixed magnitude
    (so the order of every deposit and of the refund tree shows in the
    bits): seen, the filter, the lane (a strided view) and the refund equal
    the plain version's (torch.equal), with twins hit, refunds made and one
    refund of -0.0 values among them."""
    bits, urls, mask, val, f_url, f_valid, table = twin_case(
        R, M, C, b, seed=R + M + C + tile, queue_fill=fill)
    t = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    args = [t(urls), t(mask), t(val), t(f_url), t(f_valid)]
    filt = torch.tensor(bits)
    filt = (pack_bits(filt) if packed else filt).to(cuda)
    wide = torch.zeros((R, 2 + C), device=cuda)
    wide[:, 2:] = t(table)
    f1, w1, f2, w2 = filt, wide.clone(), filt.clone(), wide.clone()
    kern = DOPS.PACKED if packed else DOPS.KERNEL
    fn = DOPS.dedup_deposit_packed if packed else DOPS.dedup_deposit
    ref = dedup_deposit_packed_ref if packed else dedup_deposit_ref
    n0 = kern.launches
    s1, r1 = fn(f1, *args, w1[:, 2:], k=4, url_tile=tile)
    s2, r2 = ref(f2, *args, w2[:, 2:], k=4, url_tile=min(tile, M))
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1
    for a, b_ in ((s1, s2), (f1, f2), (w1, w2), (r1, r2)):
        assert torch.equal(a, b_)
    assert bool(s1.any()) and not torch.equal(w1, wide)
    assert bool((r1 != 0).any())


def flash_case(rng, B, Hq, Hkv, Sq, Skv, hd, dtype, device, *, view):
    """q (B, Hq, Sq, hd), k, v (B, Hkv, Skv, hd): ``view`` "projection"
    lays them out as (B, S, H, hd) transposed, "contiguous" as they are,
    "padded" as every other row of a wider array whose rows are not
    16-byte aligned (the f32 tile loads then go through the threads, not
    cp.async)."""
    dt = getattr(torch, dtype)
    out = []
    for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)):
        x = torch.tensor(rng.standard_normal((B, S, H, hd)),
                         dtype=torch.float32).to(device, dt)
        if view == "projection":
            out.append(x.transpose(1, 2))
        elif view == "contiguous":
            out.append(x.transpose(1, 2).contiguous())
        else:
            wide = torch.zeros((B, H, 2 * S, hd + 1), dtype=dt,
                               device=device)
            wide[:, :, ::2, :hd] = x.transpose(1, 2)
            out.append(wide[:, :, ::2, :hd])
    return out


# (hd, group, Sq, Skv, causal, view, dtype): f32 at every head dim with
# ragged lengths, Sq != Skv (not causal), GQA groups 1/2/6, strided views,
# S 2048; bf16 at the small head dims the CUDA-core route takes
FLASH_CASES = (
    [(hd, 2, S, S, True, "projection", "float32")
     for hd in (8, 16, 32, 64, 96, 128) for S in (1, 63, 65, 2047)]
    + [(hd, g, 70, 200, False, "padded", "float32")
       for hd in (16, 128) for g in (1, 2, 6)]
    + [(hd, 6, 130, 65, False, "contiguous", "float32") for hd in (32, 96)]
    + [(128, 6, 2048, 2048, True, "projection", "float32"),
       (64, 1, 2048, 2048, False, "padded", "float32")]
    + [(hd, g, S, S, c, "projection", "bfloat16")
       for hd in (8, 16, 32) for g, S, c in ((1, 65, True), (6, 200, False))])


@pytest.mark.parametrize("hd,group,Sq,Skv,causal,view,dtype", FLASH_CASES)
def test_flash_attention_split_tf32_cases(cuda, hd, group, Sq, Skv, causal,
                                          view, dtype):
    """The CUDA-core route (split TF32 on the tensor cores) against the
    plain version: within 2e-5 in f32 and 2e-2 in bf16, one launch of
    flash_attention and none of flash_attention_tc."""
    rng = np.random.default_rng(hd * 7 + group + Sq + Skv)
    q, k, v = flash_case(rng, 2, 2 * group, 2, Sq, Skv, hd, dtype, cuda,
                         view=view)
    assert FOPS.route("cuda", q.dtype, hd) is FOPS.KERNEL
    n0 = (FOPS.KERNEL.launches, FOPS.TC_KERNEL.launches)
    got = FOPS.attention(q, k, v, causal=causal)
    qg, kf, vf, g = FOPS._gqa_fold(q, k, v)
    want = flash_ref(qg, kf, vf, causal=causal, group=g).reshape(q.shape)
    torch.cuda.synchronize()
    assert (FOPS.KERNEL.launches, FOPS.TC_KERNEL.launches) == \
        (n0[0] + 1, n0[1])
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


# the attention's autograd (the kernel forward, the plain backward) against
# autograd through flash_ref, both on the card: |got - want| <= tol *
# max|want| (chip_smoke.TRAIN_BWD_TOL: the bf16 gradients' own rounding and
# the tc forward's p rounding; in f32 the split-TF32 forward's O)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd,group,S", [(16, 3, 40), (64, 2, 200),
                                        (128, 6, 130)])
def test_flash_attention_backward_on_card(cuda, hd, group, S, causal,
                                          dtype):
    rng = np.random.default_rng(hd + S)
    q, k, v = flash_case(rng, 2, 2 * group, 2, S, S, hd, dtype, cuda,
                         view="projection")
    do = torch.tensor(rng.standard_normal(tuple(q.shape)),
                      dtype=torch.float32, device=cuda).to(q.dtype)

    def grads(fn):
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(fn(*xs), xs, do)

    def plain(a, b, c):
        qg, kf, vf, g = FOPS._gqa_fold(a, b, c)
        return flash_ref(qg, kf, vf, causal=causal, group=g).reshape(a.shape)
    n0 = FOPS.KERNEL.launches + FOPS.TC_KERNEL.launches
    got = grads(lambda a, b, c: FOPS.attention(a, b, c, causal=causal,
                                               block_k=64))
    assert FOPS.KERNEL.launches + FOPS.TC_KERNEL.launches == n0 + 1
    want = grads(plain)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == q.dtype
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= BWD_TOL[dtype] * float(
            b.abs().max())


def test_training_on_card_matches_cpu(cuda, tmp_path):
    """The reduced qwen2 in f32, 6 AdamW steps from the same weights and
    batches on both devices: losses within 1e-4, one flash_attention
    launch a layer a step (remat off), and run_with_failures on the card
    equal to the uninterrupted card run bit for bit. TF32 is off."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import fault
    from repro_torch.train.trainer import init_train_state, make_train_step
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = scaled(get_reduced("qwen2-1.5b"), dtype="float32")
        params = T.stack_params(T.init_lm(cfg, seed=0, device="cpu"))
        rng = np.random.default_rng(2)
        batches = [tuple(torch.tensor(rng.integers(0, cfg.vocab_size,
                                                   (4, 64)),
                                      dtype=torch.int32) for _ in range(2))
                   for _ in range(6)]
        opt = adamw(lr=warmup_cosine(3e-3, 2, 6))
        step = make_train_step(lambda p, b: T.lm_loss(p, cfg, b[0], b[1]),
                               opt)

        def start(dev):
            return (init_train_state({k: v.to(dev) for k, v in
                                      params.items()}, opt),
                    [tuple(x.to(dev) for x in b) for b in batches])
        losses, states = {}, {}
        for dev in (cuda, torch.device("cpu")):
            st, bs = start(dev)
            n0 = FOPS.KERNEL.launches
            losses[dev.type] = []
            for b in bs:
                st, m = step(st, b)
                losses[dev.type].append(float(m["loss"]))
            if dev.type == "cuda":
                assert FOPS.KERNEL.launches == n0 + cfg.n_layers * 6
            states[dev.type] = st
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=0,
                                   atol=1e-4)
        st, bs = start(cuda)
        replayed = fault.run_with_failures(
            step, st, bs, ckpt_dir=str(tmp_path), ckpt_every=2,
            plan=fault.FailurePlan(fail_at=(3, 5)))
        a, b = ckpt.flatten(states["cuda"]), ckpt.flatten(replayed)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "arctic-480b"])
def test_moe_block_on_card_matches_cpu(cuda, arch, factor):
    """One MoE layer of the reduced model in f32 with the same weights on
    both devices (TF32 off: it would round the f32 router's products and
    flip experts): output and aux within 1e-5, the same experts and keep
    (at factor 0.5 assignments drop), and no host sync on the card (the
    block runs under torch's sync debug mode set to raise)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import layers as L
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = scaled(get_reduced(arch), dtype="float32")
        cfg = scaled(cfg, moe=scaled(cfg.moe, capacity_factor=factor))
        cpu = L.init_moe(torch.Generator().manual_seed(0), cfg,
                         torch.float32, "cpu")
        card = L.MoE(cfg, torch.float32, cuda)
        with torch.no_grad():
            for (_, a), (_, b) in zip(card.named_parameters(),
                                      cpu.named_parameters()):
                a.copy_(b)
        x = torch.tensor(np.random.default_rng(1).standard_normal(
            (4, 64, cfg.d_model)), dtype=torch.float32)
        routes = {}

        def run(p, x):
            logits = (x.reshape(-1, cfg.d_model) @ p.router)[None]
            cap = L.moe_capacity(cfg.moe, logits.shape[1])
            routes[x.device.type] = [t.cpu() for t in L.moe_dispatch(
                logits, cfg.moe, cap)[1:4]]
            return L.moe_block(p, cfg, x)
        want, want_aux = run(cpu, x)
        xc = x.to(cuda)
        L.moe_block(card, cfg, xc)          # warm-up: the first cuBLAS call
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, got_aux = L.moe_block(card, cfg, xc)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        run(card, xc)
        for a, b in zip(routes["cuda"], routes["cpu"]):
            assert torch.equal(a, b)
        assert bool((~routes["cpu"][2]).any()) == (factor == 0.5)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)
        assert abs(float(got_aux) - float(want_aux)) <= 1e-5 * float(
            want_aux)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


GNN_RECSYS = ("gat-cora", "bert4rec", "dien", "wide-deep", "dcn-v2")


def zoo_case(arch):
    """A reduced GNN/RecSys arch's (loss, serve, params on the CPU, train
    batch, serve batch), the batches as numpy trees."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R
    cfg = get_reduced(arch)
    if cfg.family == "gnn":
        rng = np.random.default_rng(3)
        N, E, F, C = 64, 256, 16, 4
        g = G.Graph(rng.normal(size=(N, F)).astype(np.float32),
                    rng.integers(0, N, E).astype(np.int32),
                    rng.integers(0, N, E).astype(np.int32),
                    rng.random(E) < 0.9,
                    rng.integers(0, C, N).astype(np.int32),
                    rng.random(N) < 0.5)
        return (lambda p, b: G.gat_loss(p, cfg, b),
                lambda p, b: G.gat_forward(p, cfg, b),
                G.init_gat(0, cfg, F, C, device="cpu"), g, g)
    shape = lambda kind, b: ShapeSpec(kind, kind, dict(batch=b))
    return (lambda p, b: R.TRAIN_LOSS[cfg.kind](p, cfg, b),
            lambda p, b: R.SERVE[cfg.kind](p, cfg, b),
            R.INIT[cfg.kind](0, cfg, device="cpu"),
            R.make_batch(cfg, shape("train", 16), numpy=True),
            R.make_batch(cfg, shape("serve", 8), rng_key=1, numpy=True))


@pytest.mark.parametrize("arch", GNN_RECSYS)
def test_gnn_recsys_on_card_match_cpu(cuda, arch):
    """The reduced arch in f32 (TF32 off) from the same weights and batches
    on both devices: 4 AdamW steps' losses within 1e-4, the serve outputs
    within 1e-5 (BERT4Rec: its top-k scores, and each id valid); then the
    same 4 steps again on the card, equal to the first run bit for bit
    (the fixed-order gathers and segment sums of models/segment.py)."""
    from repro_torch.models.recsys import to_device as tree_to
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import init_train_state, make_train_step
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        loss, serve, params, tb, sb = zoo_case(arch)
        step = make_train_step(loss, adamw(lr=1e-3))
        runs = []
        for dev in (cuda, torch.device("cpu"), cuda):
            st = init_train_state({k: v.to(dev) for k, v in params.items()},
                                  adamw(lr=1e-3))
            b, losses = tree_to(tb, dev), []
            for _ in range(4):
                st, m = step(st, b)
                losses.append(float(m["loss"]))
            with torch.no_grad():
                out = serve({k: v.to(dev) for k, v in params.items()},
                            tree_to(sb, dev))
            runs.append((losses, st, out))
        (lc, sc, oc), (lh, _, oh), (_, s2, _) = runs
        np.testing.assert_allclose(lc, lh, rtol=0, atol=1e-4)
        oc, oh = (o[0] if isinstance(o, tuple) else o for o in (oc, oh))
        np.testing.assert_allclose(oc.cpu().numpy(), oh.numpy(), rtol=0,
                                   atol=1e-5)
        if isinstance(runs[0][2], tuple):
            ids = runs[0][2][1]
            assert bool(((ids >= 0) & (ids < 512)).all())
        a, b = ckpt.flatten(sc), ckpt.flatten(s2)
        assert [k for k in a if a[k].tobytes() != b[k].tobytes()] == []
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
