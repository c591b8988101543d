"""WebParF crawl configuration — the paper's own system (Gupta, Bhatia,
Manchanda 2014). Counterpart of ``repro/configs/webparf.py``."""
from repro_torch.configs.base import CRAWL_SHAPES, CrawlConfig, scaled

CONFIG = CrawlConfig()
SHAPES = CRAWL_SHAPES


def reduced() -> CrawlConfig:
    return scaled(CONFIG, name="webparf-smoke", n_domains=8,
                  frontier_capacity=64, fetch_batch=8, outlinks_per_page=4,
                  bloom_bits_log2=12, dispatch_capacity=32, url_space_log2=16,
                  seed_urls_per_domain=4)
