#!/usr/bin/env python3
"""The memory a cell can use on this card, as ``launch/mesh.py``'s
``HBM_BYTES`` states it.

    python3 tools/card_capacity.py

In a fresh process it reads ``torch.cuda.mem_get_info()`` at three points:

  context — just after the CUDA context is made (total and free);
  cublas  — after a f32 and a bf16 product (cuBLAS's handle and its
            workspace, which the caching allocator holds);
  lm      — after a small bf16 serve at hd 128 (one layer of qwen2-1.5b's
            widths, 2 x 256 + 4 tokens) and its f32 twin, which load the
            kernel modules the LM path runs (the port's attention kernels,
            PyTorch's GEMM, norm, RoPE and decode kernels), every tensor
            freed and the allocator's cache emptied.

The capacity is what is free at ``lm``, less what the allocator still
holds unallocated: the bytes a cell's own allocations can take, the same
bytes ``torch.cuda.max_memory_allocated`` less its base counts (the dry
run reckons a cell so, ``launch/dryrun.py``). Prints one JSON line, with
the card's name and power limit as nvidia-smi gives them; exits 1 without
a card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def point(torch, label):
    free, total = torch.cuda.mem_get_info()
    return {"point": label, "free": free, "total": total,
            "allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("card_capacity: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import scaled
    from repro_torch.launch.mesh import HBM_BYTES
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    points = [point(torch, "context")]
    a = torch.ones(64, 64, device="cuda")
    (a @ a).sum().item()
    (a.bfloat16() @ a.bfloat16()).sum().item()
    del a
    torch.cuda.empty_cache()
    points.append(point(torch, "cublas"))
    base = scaled(get_arch("qwen2-1.5b")[0], n_layers=1)
    for dtype in ("bfloat16", "float32"):
        cfg = scaled(base, dtype=dtype)
        model = T.init_lm(cfg, seed=0, device="cuda")
        prompts = torch.randint(0, cfg.vocab_size, (2, 256), device="cuda")
        serve(model, prompts, 4)
        del model, prompts
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    points.append(point(torch, "lm"))
    last = points[-1]
    capacity = last["free"] - (last["reserved"] - last["allocated"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "points": points,
                      "capacity_bytes": capacity,
                      "capacity_gib": capacity / 2 ** 30,
                      "context_bytes": last["total"] - points[0]["free"],
                      "taken_before_a_cell_bytes": last["total"] - capacity,
                      "hbm_bytes_constant": HBM_BYTES,
                      "constant_within_total": HBM_BYTES <= last["total"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
