"""Optimizers of the port: AdamW, SGD with momentum, Adafactor, schedules
and global-norm clipping. Counterpart of ``repro/optim``.

They are functional, as the reference's optax-like interface is, over
flat dicts of tensors keyed by the reference's checkpoint paths
(``optim/common.py``), not ``torch.optim.Optimizer`` subclasses: a
state is a NamedTuple of such dicts, so a ``TrainState`` flattens to the
reference's checkpoint keys (``opt_state/m/layers/attn/wq``, ...) as it is.

    opt = adamw(lr=3e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)
"""
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw, sgd_momentum
from repro_torch.optim.common import (Optimizer, apply_updates,
                                      clip_by_global_norm, global_norm)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["Optimizer", "adafactor", "adamw", "apply_updates",
           "clip_by_global_norm", "constant", "global_norm", "sgd_momentum",
           "warmup_cosine"]
