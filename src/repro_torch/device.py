"""Where the port runs: the card unless the caller asks for the CPU, or,
for the dry run's reckoning, for ``meta`` (shapes and dtypes, no storage)."""
from __future__ import annotations

from typing import Optional, Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Optional[Device] = None) -> torch.device:
    """``None`` means ``cuda``; under a process group (the crawl group,
    ``launch.mesh.init_crawl_group``) the rank's own card,
    ``cuda:LOCAL_RANK``, which the group made the current device. A CUDA
    request on a machine without a card raises: the port never falls back
    to the CPU on its own. ``meta`` is taken only when the caller names it
    (``launch/dryrun.py``)."""
    dev = torch.device("cuda" if device is None else device)
    if device is None and torch.distributed.is_available() \
            and torch.distributed.is_initialized() \
            and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on cuda by default, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch runs on cuda, cpu or meta, not {dev}")
    return dev
