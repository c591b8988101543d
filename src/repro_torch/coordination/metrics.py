"""The communication ledger: the paper's bandwidth axis. A port copy of
``repro/coordination/metrics.py`` (plain Python).

All counters come from the crawl's stat rows (``core/stages.STATS``),
summed by ``repro_torch.api.report.stats_dict``:

  urls_shipped   — URLs handed to the exchange (``dispatch_sent``).
  urls_received  — URLs entering the local insert path (``dispatch_recv``;
                   for the zero-communication modes the URLs kept local).
  urls_dropped   — URLs a coordination mode discarded (firewall's foreign
                   drops, outbox overflow).
  urls_deferred  — URLs parked in the outbox for a later dispatch
                   (cumulative: a URL parked twice counts twice).
  comm_per_page  — shipped URLs per fetched page (0 under firewall and
                   crossover).

Surfaced as :attr:`repro_torch.api.CrawlReport.comm`.
"""
from __future__ import annotations

from typing import Dict


def comm_ledger(stats: Dict[str, int], fetched: int) -> Dict[str, float]:
    """Fold a run's stat counters into the communication ledger."""
    shipped = int(stats.get("dispatch_sent", 0))
    return dict(
        urls_shipped=shipped,
        urls_received=int(stats.get("dispatch_recv", 0)),
        urls_dropped=int(stats.get("coord_dropped", 0)),
        urls_deferred=int(stats.get("coord_deferred", 0)),
        comm_per_page=shipped / max(int(fetched), 1),
    )


def ledger_line(comm: Dict[str, float]) -> str:
    """One human line for drivers (launch/crawl.py, benchmarks)."""
    return (f"{comm['urls_shipped']} URLs shipped "
            f"({comm['comm_per_page']:.2f}/page), "
            f"{comm['urls_dropped']} dropped, "
            f"{comm['urls_deferred']} deferred")
