"""Synthetic Web: the deterministic stand-in for WWW fetches, in PyTorch.

Counterpart of ``repro/core/webgraph.py``; every function is bit-identical
to it (tests/test_torch_webgraph.py). URL ids pack (domain, local) as

    url = domain << local_bits | local

JAX computes in ``uint32`` and relies on wraparound. PyTorch has few uint32
ops, so URL ids and hashes are carried in ``int64`` holding uint32 values and
masked with ``& 0xFFFFFFFF`` after every op that can leave 32 bits. A uint32
by uint32 product can pass 2^63 and wrap the int64, but its low 32 bits
survive, so the mask right after each multiply restores the uint32 result.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.configs.base import CrawlConfig

M32 = 0xFFFFFFFF
U32 = torch.int64       # the dtype that carries the reference's uint32 ids
U32Like = Union[torch.Tensor, int]


def _u32(x: U32Like) -> U32Like:
    if isinstance(x, torch.Tensor):
        x = x.to(torch.int64)
    return x & M32


def _mix(x: U32Like, salt: int) -> U32Like:
    """murmur3-style finalizer — a cheap stateless hash on uint32. A
    Python int stays one (no tensor is made for a constant)."""
    x = _u32(x) ^ ((salt * 0x9E3779B9 + 0x85EBCA6B) & M32)
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & M32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def hash2(a: torch.Tensor, b: U32Like, salt: int = 0) -> torch.Tensor:
    return _mix((_u32(a) + _mix(b, salt + 7)) & M32, salt)


def _uniform(x: torch.Tensor) -> torch.Tensor:
    """uint32 -> f32 in [0, 1)."""
    return x.to(torch.float32) * (1.0 / 4294967296.0)


def local_bits(cfg: CrawlConfig) -> int:
    return cfg.url_space_log2 - int(np.log2(cfg.n_domains))


def domain_of(url: torch.Tensor, cfg: CrawlConfig) -> torch.Tensor:
    """TRUE domain — what the page analyzer's classifier recovers post-fetch."""
    return (url & M32) >> local_bits(cfg)


def make_url(domain: torch.Tensor, local: torch.Tensor,
             cfg: CrawlConfig) -> torch.Tensor:
    lb = local_bits(cfg)
    return (((domain & M32) << lb) & M32) | (local & ((1 << lb) - 1))


def zipf_cumweights(cfg: CrawlConfig, device=None) -> torch.Tensor:
    """Static cumulative Zipf weights over domains (domain-size skew)."""
    w = 1.0 / np.arange(1, cfg.n_domains + 1) ** cfg.zipf_a
    w = w / w.sum()
    return torch.tensor(np.cumsum(w).astype(np.float32), device=device)


def sample_domain(h: torch.Tensor, cumw: torch.Tensor) -> torch.Tensor:
    """Zipf-weighted domain from a hash value (left-side search, as
    ``jnp.searchsorted``)."""
    u = _uniform(h)
    return torch.searchsorted(cumw, u.contiguous(), right=False)


def canonical(url: torch.Tensor, cfg: CrawlConfig) -> torch.Tensor:
    """Alias resolution. The top ``alias_fraction`` of each domain's local
    space mirrors canonical pages."""
    lb = local_bits(cfg)
    local = url & ((1 << lb) - 1)
    alias_start = int((1 << lb) * (1.0 - cfg.alias_fraction))
    is_alias = local >= alias_start
    canon_local = _mix(local, 11) % max(alias_start, 1)
    return torch.where(is_alias,
                       make_url(domain_of(url, cfg), canon_local, cfg),
                       url & M32)


def outlinks(url: torch.Tensor, cfg: CrawlConfig,
             cumw: torch.Tensor) -> torch.Tensor:
    """Parse a page: (...,) -> (..., outlinks_per_page) discovered URLs.
    ``cfg.link_pop_bias`` > 0 draws each local target by a popularity
    tournament of two candidates."""
    c = canonical(url, cfg)[..., None]
    i = torch.arange(cfg.outlinks_per_page, dtype=torch.int64,
                     device=url.device)
    h_stay = hash2(c, i, 1)
    h_dom = hash2(c, i, 2)
    h_loc = hash2(c, i, 3)
    stay = _uniform(h_stay) < cfg.topical_locality
    dom = torch.where(stay, domain_of(url, cfg)[..., None],
                      sample_domain(h_dom, cumw))
    out = make_url(dom, h_loc, cfg)
    if cfg.link_pop_bias > 0.0:
        alt = make_url(dom, hash2(c, i, 6), cfg)
        upset = _uniform(hash2(c, i, 8)) < cfg.link_pop_bias
        return torch.where(upset & (popularity(alt, cfg)
                                    > popularity(out, cfg)), alt, out)
    return out


def page_tokens(url: torch.Tensor, cfg: CrawlConfig, *, n_tokens: int,
                vocab: int) -> torch.Tensor:
    """Domain-clustered unigram content of the canonical page:
    (...,) -> (..., n_tokens) int32 terms, 70% from the domain's band of
    the vocabulary and 30% from all of it."""
    c = canonical(url, cfg)[..., None]
    i = torch.arange(n_tokens, dtype=torch.int64, device=url.device)
    h = hash2(c, i, 4)
    dom = domain_of(url, cfg)[..., None]
    band = vocab // max(int(cfg.n_domains), 1)
    in_band = _uniform(hash2(c, i, 5)) < 0.7
    tok_band = dom * band + h % max(band, 1)
    tok_glob = h % vocab
    return torch.where(in_band, tok_band, tok_glob).to(torch.int32)


def popularity(url: torch.Tensor, cfg: CrawlConfig) -> torch.Tensor:
    """Static page-quality proxy (inlink count analogue) in [0, 1]."""
    u = _uniform(_mix(canonical(url, cfg), 21))
    # PyTorch's vectorized f32 sqrt on the CPU is not always correctly
    # rounded; the f64 root rounded to f32 is, on every device, as XLA's is
    return 1.0 - torch.sqrt(u.to(torch.float64)).to(torch.float32)


def is_hub(url: torch.Tensor, cfg: CrawlConfig) -> torch.Tensor:
    """Hub pages = top popularity percentile (seed candidates)."""
    return popularity(url, cfg) > 0.95


def hub_seeds(cfg: CrawlConfig, device=None) -> torch.Tensor:
    """Phase I seed gathering: the N most popular of a window of candidate
    URLs per domain. Returns (n_domains, N). Ties go to the lower candidate
    index, as ``lax.top_k`` breaks them (a stable descending sort)."""
    d = torch.arange(cfg.n_domains, dtype=torch.int64, device=device)[:, None]
    n_cand = max(cfg.seed_urls_per_domain * 8, 64)
    j = torch.arange(n_cand, dtype=torch.int64, device=device)[None, :]
    cand_local = _mix(hash2(d, j, 31), 32)
    cand = make_url(d.expand(cand_local.shape), cand_local, cfg)
    pop = popularity(cand, cfg)
    idx = torch.sort(pop, dim=1, descending=True,
                     stable=True).indices[:, :cfg.seed_urls_per_domain]
    return torch.gather(cand, 1, idx)
