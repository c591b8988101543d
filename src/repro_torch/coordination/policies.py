"""The built-in coordination mode of the port. Counterpart of
``repro/coordination/policies.py`` (its ``exchange`` mode)."""
from __future__ import annotations

import torch

from repro_torch.coordination.registry import (CoordinationPolicy,
                                               DispatchPlan,
                                               register_coordination)


def _exchange_plan(ctx, state, shard, u, src, val, dest, staged, valid):
    """Ship everything staged to its predicted owner — the paper's C5
    dispatcher (own-shard URLs go through the exchange too)."""
    z = torch.zeros_like(valid)
    return DispatchPlan(ship=valid, keep=z, defer=z, drop=z, foreign=z)


EXCHANGE = register_coordination(CoordinationPolicy(
    "exchange", True, False, False, _exchange_plan))
