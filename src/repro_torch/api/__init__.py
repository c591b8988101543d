"""repro_torch.api — the user-facing surface of the port: CrawlSession
and the typed CrawlReport, and the serving layer built on them
(``ServeSession``, ``ServeReport``), re-exported lazily because
``repro_torch.serve`` imports this package."""
from repro_torch.api.report import (CrawlReport, harvest, overlap_metrics,
                                    stats_dict)
from repro_torch.api.session import CrawlSession

__all__ = ["CrawlSession", "CrawlReport", "ServeSession", "ServeReport",
           "harvest", "overlap_metrics", "stats_dict"]


def __getattr__(name):
    if name in ("ServeSession", "ServeReport"):
        from repro_torch import serve
        return getattr(serve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
