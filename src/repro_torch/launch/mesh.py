"""The cards the port runs on. Counterpart of ``repro/launch/mesh.py``.

The reference describes a pod of TPU chips and its per-chip rates; the
port runs on NVIDIA H100s (SXM, 80 GB HBM3, the card of every number
in PERF.md, ``NVIDIA H100 80GB HBM3, 700.00 W``). Its dense peaks and its
memory, which the dry run (``launch/dryrun.py``) and ``chip_smoke.py``
bound every cell with:

  989 TFLOP/s bf16 and 495 TFLOP/s TF32 on the tensor cores (dense),
  67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s HBM; of its 80 GiB of
  HBM, ``HBM_BYTES`` is what a cell's own allocations can take.

``make_production_mesh`` is not ported: a host of cards has no pod to lay
out (``ROADMAP.md`` lists it). ``init_crawl_group`` starts the crawl's
process group, one process a card, from what ``torch.distributed.run``
sets; ``make_host_mesh`` returns the mesh shape of this host's group (one
card without a group), which ``sharding.rules.activation_mesh`` takes.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12        # FLOP/s, dense TF32 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, f32 FMAs on the CUDA cores
HBM_BW = 3.35e12                # B/s
# The bytes a cell can allocate, against which it fits: what
# ``torch.cuda.mem_get_info()`` reports free on an ``NVIDIA H100 80GB HBM3,
# 700.00 W`` (total 85,017,493,504 B, 79.18 GiB) in a fresh process after
# its CUDA context (552,402,944 B), cuBLAS's handle and 32 MiB workspace and
# the LM path's kernel modules are loaded: 78.48 GiB, measured by
# ``tools/card_capacity.py``. A constant, so the dry run on meta needs no card;
# ``chip_smoke.py`` checks it against the card's reported total.
HBM_BYTES = 84_263_763_968


# seconds a collective may wait for its peers before the group fails
GROUP_TIMEOUT_S = 300


def init_crawl_group(device: Optional[str] = None, *,
                     timeout_s: float = GROUP_TIMEOUT_S, store=None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None):
    """Start the crawl's process group and return its ``CrawlGroup``.

    ``rank``, ``world_size`` and ``local_rank`` default to the ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` that ``torch.distributed.run`` sets
    (with ``MASTER_ADDR`` and ``MASTER_PORT`` for the rendezvous, unless a
    ``store`` is given). On the card (``device`` None or ``cuda``) the
    rank first takes ``cuda:LOCAL_RANK`` as its device, so that every
    kernel launch and NCCL call lands on its own card, and the group runs
    NCCL; a machine without a card raises. Gloo runs only for an explicit
    ``device="cpu"``. A collective that waits longer than ``timeout_s``
    fails the group instead of hanging."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import CrawlGroup

    def env(name, given):
        if given is not None:
            return int(given)
        if name not in os.environ:
            raise RuntimeError(f"init_crawl_group: {name} is not set; start "
                               f"the processes with torch.distributed.run "
                               f"or pass it")
        return int(os.environ[name])

    rank, world = env("RANK", rank), env("WORLD_SIZE", world_size)
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda":
        local = env("LOCAL_RANK", local_rank)
        if not torch.cuda.is_available():
            raise RuntimeError("init_crawl_group: the crawl group runs on "
                               "cuda by default, but torch.cuda.is_available"
                               "() is False; pass device='cpu' for gloo")
        torch.cuda.set_device(local)
        backend = "nccl"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_crawl_group: cuda or cpu, not {kind}")
    kw = {} if store is None else {"store": store}
    dist.init_process_group(
        backend, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return CrawlGroup.current()


def make_host_mesh(model: int = 1) -> Dict[str, int]:
    """The (data, model) shape of this host: the crawl group's W cards on
    the data axis (one card without a group), as the reference's
    ``make_host_mesh`` lays out whatever the host has. ``model`` must be
    1: the port splits no model over cards."""
    if model != 1:
        raise ValueError(f"make_host_mesh: model={model}, but the port runs "
                         f"a model on one card, where only model=1 divides "
                         f"the devices (the reference asserts the same on a "
                         f"one-device host)")
    from repro_torch.dist import CrawlGroup
    return {"data": CrawlGroup.current().world, "model": 1}
