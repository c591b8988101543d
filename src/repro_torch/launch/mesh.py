"""The one card the port runs on. Counterpart of ``repro/launch/mesh.py``.

The reference describes a pod of TPU chips and its per-chip rates; the
port runs on one NVIDIA H100 (SXM, 80 GB HBM3, the card of every number
in PERF.md, ``NVIDIA H100 80GB HBM3, 700.00 W``). Its dense peaks and its
memory, which the dry run (``launch/dryrun.py``) and ``chip_smoke.py``
bound every cell with:

  989 TFLOP/s bf16 and 495 TFLOP/s TF32 on the tensor cores (dense),
  67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s HBM; of its 80 GiB of
  HBM, ``HBM_BYTES`` is what a cell's own allocations can take.

``make_production_mesh`` is not ported: one card has no pod to lay out
(``ROADMAP.md`` lists it). ``make_host_mesh`` returns the mesh shape of
the card, which ``sharding.rules.activation_mesh`` takes.
"""
from __future__ import annotations

from typing import Dict

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


def make_host_mesh(model: int = 1) -> Dict[str, int]:
    """The (data, model) shape of this host: one card, so ``model`` must
    be 1, as the reference's ``make_host_mesh`` asserts on a host of one
    device."""
    if model != 1:
        raise ValueError(f"make_host_mesh: model={model}, but the port runs "
                         f"on one card, where only model=1 divides the "
                         f"devices (the reference asserts the same on a "
                         f"one-device host)")
    return {"data": 1, "model": 1}
