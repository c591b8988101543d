"""The twin cases of ``dedup_deposit``, shared by its CPU and card tests:
dispatch batches that re-send URLs still queued in their row."""
import numpy as np
import torch

from repro_torch.kernels.bloom.ref import bloom_ref


def twin_case(R, M, C, b, *, seed, queue_fill, dyadic=False, k=4):
    """A dispatch batch as the crawl sends it, in numpy: arrivals re-send
    URLs still queued in their row (twins), URLs inserted before and no
    longer queued (refunds, a third of them valued -0.0) and fresh URLs.
    Planted in every row: twins at the first and the last column; a URL
    queued at columns 1 and 2 (column 1 must win); a URL queued at column
    4, invalid, and at C - 2, valid (C - 2 must win); column 0 hit twice
    in the first tile; the last row all masked. Values are float32 of
    mixed magnitude (1e-4 to 1e3), so a deposit or a refund added in
    another order than the plain version's changes the bits; ``dyadic``
    draws multiples of 1/8 instead, where every order gives the same bits
    (for a comparison with XLA, whose order is its own). Returns (bits,
    urls, mask, val, f_url, f_valid, table)."""
    rng = np.random.default_rng(seed)
    f_url = rng.integers(1, 1 << 20, (R, C))
    f_valid = rng.random((R, C)) < queue_fill
    f_valid[:, [0, 1, 2, C - 2, C - 1]] = True
    f_url[:, 2] = f_url[:, 1]
    f_url[:, 4] = f_url[:, C - 2]
    f_valid[:, 4] = False
    gone = rng.integers(1 << 20, 1 << 21, (R, M))
    fresh = rng.integers(1 << 21, 1 << 22, (R, M))
    rows = np.arange(R)[:, None]
    order = np.argsort(~f_valid, axis=1, kind="stable")
    j = (rng.random((R, M)) * f_valid.sum(axis=1)[:, None]).astype(np.int64)
    queued = f_url[rows, order[rows, j]]
    pick = rng.random((R, M))
    urls = np.where(pick < 0.35, queued, np.where(pick < 0.65, gone, fresh))
    urls[:, :5] = np.stack([f_url[:, 0], f_url[:, C - 1], f_url[:, 2],
                            f_url[:, 0], f_url[:, C - 2]], axis=1)[:, :M]
    mask = rng.random((R, M)) < 0.8
    mask[:, :5] = True
    if R > 1:
        mask[-1] = False
    if dyadic:
        val = (rng.integers(1, 64, (R, M)) / 8.0).astype(np.float32)
    else:
        val = (rng.random((R, M)) * 10.0 ** rng.integers(-4, 4, (R, M))
               ).astype(np.float32)
    val[(urls == gone) & (rng.random((R, M)) < 0.33)] = -0.0
    bits = torch.zeros((R, 1 << b), dtype=torch.uint8)
    bloom_ref(bits, torch.tensor(np.concatenate([f_url, gone], 1)),
              torch.ones((R, C + M), dtype=torch.bool), k=k)
    table = (rng.random((R, C)) * f_valid).astype(np.float32)
    return bits.numpy(), urls, mask, val, f_url, f_valid, table


# (R, M, C, b, tile, queue_fill): the crawl's sparse queue with M not a
# multiple of the tile, tiles of 1 and 1024, queues hashed in one piece
# (360 valid) and larger than one shared-memory chunk (~1,230 of 2,048)
TWIN_CASES = [(4, 256, 64, 12, 64, 0.3), (3, 300, 128, 12, 128, 0.05),
              (2, 24, 16, 10, 1, 0.5), (2, 1100, 64, 14, 1024, 0.3),
              (2, 300, 2048, 14, 128, 0.6), (3, 512, 600, 14, 256, 0.6)]
