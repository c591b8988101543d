"""repro_torch.coordination — the coordination-mode registry of the port."""
from repro_torch.coordination.registry import (CoordinationPolicy,
                                               DispatchPlan, coordinations,
                                               get_coordination,
                                               register_coordination)

__all__ = ["CoordinationPolicy", "DispatchPlan", "coordinations",
           "get_coordination", "register_coordination"]
