"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX (the machine with the card has none), so that

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

runs it there; without a card every test skips. Inputs are made with numpy
from a seed, and the kernel must equal its plain version exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs import webparf  # noqa: E402
from repro_torch.core.stages import state_to_numpy  # noqa: E402
from repro_torch.kernels.bloom import ops as BOPS  # noqa: E402
from repro_torch.kernels.bloom.ref import bloom_ref  # noqa: E402
from repro_torch.kernels.frontier_select import ops as SOPS  # noqa: E402
from repro_torch.kernels.frontier_select.ref import NEG, select_ref  # noqa: E402


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


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("R,C,k", [(1, 32, 1), (4, 64, 4), (2, 128, 8),
                                   (3, 37, 5), (512, 4096, 1)])
def test_select_kernel_matches_plain(cuda, R, C, k, ties):
    url, pri, valid = rows(R, C, seed=R + C + k, ties=ties)
    u = torch.tensor(url, device=cuda)
    p1, v1 = torch.tensor(pri, device=cuda), torch.tensor(valid, device=cuda)
    p2, v2 = p1.clone(), v1.clone()
    n0 = SOPS.KERNEL.launches
    got = SOPS.select(u, p1, v1, k=k, return_idx=True)
    want = select_ref(u, p2, v2, k=k, return_idx=True)
    torch.cuda.synchronize()
    assert SOPS.KERNEL.launches == n0 + 1
    for a, b in zip((*got, p1, v1), (*want, p2, v2)):
        assert torch.equal(a, b)


def batch(R, M, b, *, seed, dup=0.0, fill=0.7, prefill=0, masked_row=False):
    """(bits, urls, mask) with repeats within and across tiles; ``prefill``
    URLs per row inserted before (by the plain version, on the CPU)."""
    rng = np.random.default_rng(seed)
    urls = rng.integers(0, 1 << 30, (R, M)).astype(np.int64)
    rep = rng.random((R, M)) < dup
    urls = np.where(rep, urls[np.arange(R)[:, None],
                              rng.integers(0, M, (R, M))], urls)
    mask = rng.random((R, M)) < fill
    if masked_row:
        mask[-1] = False
    bits = torch.zeros((R, 1 << b), dtype=torch.uint8)
    if prefill:
        bloom_ref(bits, torch.tensor(urls[:, :prefill]),
                  torch.ones((R, prefill), dtype=torch.bool), k=3)
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
