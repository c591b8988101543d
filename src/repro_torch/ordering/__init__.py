"""repro_torch.ordering — the URL-ordering registry of the port, and the
ordering-quality metrics (``quality``)."""
from repro_torch.ordering.policies import (ORD_URL0, ORD_WIDTH,
                                           OrderingPolicy, as_score_fn,
                                           get_ordering,
                                           make_learned_ordering, orderings,
                                           register_ordering)
from repro_torch.ordering import opic  # noqa: F401  (registers "opic")
from repro_torch.ordering import opic_url  # noqa: F401  (registers "opic_url")
from repro_torch.ordering.opic import total_cash, total_wealth
from repro_torch.ordering.opic_url import url_cash_table
from repro_torch.ordering.quality import (coverage_curve, hot_page_recall,
                                          ordering_quality, pooled_hot_set)

__all__ = ["ORD_URL0", "ORD_WIDTH", "OrderingPolicy", "as_score_fn",
           "get_ordering", "make_learned_ordering", "orderings",
           "register_ordering", "total_cash", "total_wealth",
           "url_cash_table", "coverage_curve", "hot_page_recall",
           "ordering_quality", "pooled_hot_set"]
