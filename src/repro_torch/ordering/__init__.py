"""repro_torch.ordering — the URL-ordering registry of the port."""
from repro_torch.ordering.policies import (ORD_URL0, ORD_WIDTH,
                                           OrderingPolicy, as_score_fn,
                                           get_ordering, orderings,
                                           register_ordering)

__all__ = ["ORD_URL0", "ORD_WIDTH", "OrderingPolicy", "as_score_fn",
           "get_ordering", "orderings", "register_ordering"]
