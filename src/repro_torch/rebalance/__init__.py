"""repro_torch.rebalance — load-driven elastic repartitioning: the
rebalance-policy registry and the decision and event records that
``CrawlSession`` puts on ``CrawlReport.rebalances``."""
from repro_torch.rebalance.policy import (HOT_DOMAIN, RebalanceDecision,
                                          RebalanceEvent, RebalancePolicy,
                                          get_rebalance, rebalances,
                                          register_rebalance)

__all__ = [
    "HOT_DOMAIN", "RebalanceDecision", "RebalanceEvent", "RebalancePolicy",
    "get_rebalance", "rebalances", "register_rebalance",
]
