"""Crawl-state checkpoints in the JAX package's format. Counterpart of
``repro/train/checkpoint.py``.

A checkpoint is a directory ``step_<10 digits>`` holding ``arrays.npz``
(one array per CrawlState field, keyed by field name, in the JAX package's
dtypes) and ``manifest.json``; it is written to a temporary directory and
renamed, so a crash mid-save never leaves a partial checkpoint. Either
package can restore what the other saved.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np


def save(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray], *,
         keep: int = 3) -> str:
    """Atomically write checkpoint ``step`` from numpy leaves keyed by
    name. Returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": int(step),
            "keys": sorted(flat),
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "shapes": {k: list(v.shape) for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
    return final


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def load(ckpt_dir: str, *, step: Optional[int] = None
         ) -> Dict[str, np.ndarray]:
    """The numpy leaves of checkpoint ``step`` (the latest by default)."""
    steps = all_steps(ckpt_dir)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        step = steps[-1]
    path = os.path.join(ckpt_dir, f"step_{step:010d}", "arrays.npz")
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
