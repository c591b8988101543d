"""repro_torch.coordination — the coordination modes of the port (the
registry, the four built-ins, the batched mode's outbox, and the
communication ledger). Importing the package registers the built-ins."""
from repro_torch.coordination.registry import (CoordinationPolicy,
                                               DispatchPlan, coordinations,
                                               get_coordination,
                                               register_coordination)
from repro_torch.coordination import policies  # noqa: F401  (registers)
from repro_torch.coordination.metrics import comm_ledger, ledger_line
from repro_torch.coordination.outbox import init_outbox, outbox_capacity

__all__ = ["CoordinationPolicy", "DispatchPlan", "coordinations",
           "get_coordination", "register_coordination", "comm_ledger",
           "ledger_line", "init_outbox", "outbox_capacity"]
