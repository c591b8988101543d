from repro_torch.configs.base import CrawlConfig, scaled

__all__ = ["CrawlConfig", "scaled"]
