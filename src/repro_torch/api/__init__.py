"""repro_torch.api — the user-facing surface of the port: CrawlSession
and the typed CrawlReport."""
from repro_torch.api.report import (CrawlReport, harvest, overlap_metrics,
                                    stats_dict)
from repro_torch.api.session import CrawlSession

__all__ = ["CrawlSession", "CrawlReport", "harvest", "overlap_metrics",
           "stats_dict"]
