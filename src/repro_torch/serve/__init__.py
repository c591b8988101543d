"""repro_torch.serve — the live crawl -> index -> serve subsystem of the
port. Counterpart of ``repro/serve``.

``ServeSession`` (built on ``repro_torch.api.CrawlSession``) interleaves
crawl intervals with a batched query path over a sharded incremental
index; ``QueryLoad`` generates the open-loop synthetic traffic;
``ServeReport`` is the typed result (latency percentiles, QPS, freshness
lag, recall@k) beside the embedded ``CrawlReport``.
"""
from repro_torch.serve.load import QueryBatch, QueryLoad
from repro_torch.serve.report import ServeReport
from repro_torch.serve.session import ServeSession

__all__ = ["ServeSession", "ServeReport", "QueryLoad", "QueryBatch"]
