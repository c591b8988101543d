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
out (``ROADMAP.md`` lists it). ``init_crawl_group`` starts the process
group, one process a card, from what ``torch.distributed.run`` sets; the
crawl and training share it. ``make_host_mesh`` lays the group out as the
(data, model) ``DeviceMesh`` that training places its state on (a mesh
shape of one card without a group).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

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


def make_host_mesh(model: int = 1):
    """This host's mesh, as the reference's ``make_host_mesh`` lays out
    whatever the host has. Under a started group of W processes (one a
    card: ``init_crawl_group``) a ``DeviceMesh`` of (W // model, model)
    named ("data", "model") on the group's device type, which
    ``sharding.rules.activation_mesh`` and the trainer's placements take;
    a ``model`` that does not divide W raises. Without a group the shape
    ``{"data": 1, "model": 1}`` of one card, where ``model`` must be 1
    (the reference asserts the same on a one-device host)."""
    from repro_torch.dist import CrawlGroup
    world = CrawlGroup.current().world
    if model < 1 or world % model:
        where = (f"the {world} processes of the group" if world > 1 else
                 "one card (no process group)")
        raise ValueError(f"make_host_mesh: model={model} does not divide "
                         f"{where}")
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return {"data": 1, "model": 1}
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (world // model, model),
                            mesh_dim_names=("data", "model"))
