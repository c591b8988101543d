"""Checkpoints in the JAX package's format. Counterpart of
``repro/train/checkpoint.py``.

A checkpoint is a directory ``step_<10 digits>`` holding ``arrays.npz``
(one array per leaf, keyed by its path joined with ``/``, in the JAX
package's dtypes) and ``manifest.json``; it is written to a temporary
directory and renamed, so a crash mid-save never leaves a partial
checkpoint. Either package can restore what the other saved.

A tree is a dict, a NamedTuple (its field names are path parts, as
``jax.tree_util.tree_flatten_with_path`` names them), a list or a plain
tuple (its indices are path parts: an MoE LM's ``prefix`` layers are
``prefix/0/...``, ``prefix/1/...``), a tensor or a numpy array. A ``TrainState`` therefore flattens to the reference's keys:
``params/layers/attn/wq``, ``opt_state/count``, ``opt_state/m/...``,
``step``; a crawl state is saved as its flat dict of numpy leaves. bf16
leaves are written as 2-byte voids, as JAX writes its bfloat16 (JAX's own
``restore`` refuses those, so only the port restores a bf16 leaf).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_SEP = "/"


def _whole(leaf):
    """A leaf placed on a train mesh (a DTensor) joined whole, on every
    process (a collective); any other leaf as it is."""
    from torch.distributed.tensor import DTensor
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = _whole(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _items(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree, depth first."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}{_SEP}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _items(v, f"{prefix}{k}{_SEP}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}{_SEP}")
    else:
        yield prefix[:-len(_SEP)], tree


def flatten(tree: Any) -> Dict[str, np.ndarray]:
    """The tree's leaves as numpy arrays keyed by path."""
    return {k: _to_numpy(v) for k, v in _items(tree)}


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == np.dtype("V2") else str(a.dtype)


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Atomically write checkpoint ``step`` of a tree (a flat dict of
    numpy leaves keyed by name is one). Returns the final path. Under a
    crawl group only rank 0 writes (its ``tree``; the others may pass
    None), and every rank returns once the checkpoint is complete. A tree
    placed on a train mesh (DTensor leaves) must be passed by every rank:
    each leaf is joined whole, one at a time, and rank 0 writes the
    reference's layout."""
    from repro_torch.dist import CrawlGroup
    group = CrawlGroup.current()
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if tree is not None and _placed(tree):
        flat = {}
        for k, v in _items(tree):
            a = _to_numpy(v)
            if group.rank == 0:
                flat[k] = a
        tree = flat
    if group.rank == 0:
        _write(ckpt_dir, step, tree, keep)
    group.barrier()
    return final


def _placed(tree) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(v, DTensor) for _, v in _items(tree))


def _write(ckpt_dir: str, step: int, tree: Any, keep: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": int(step),
            "keys": sorted(flat),
            "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
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


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def load(ckpt_dir: str, *, step: Optional[int] = None
         ) -> Dict[str, np.ndarray]:
    """The numpy leaves of checkpoint ``step`` (the latest by default)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}", "arrays.npz")
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _tensor_like(a: np.ndarray, like: torch.Tensor, key: str
                 ) -> torch.Tensor:
    """``a`` cast to ``like``'s dtype on its device, as the reference's
    restore casts to the target's dtype. A 2-byte void or integer array
    restored into a bf16 leaf is that leaf's bits."""
    if like.dtype == torch.bfloat16 and a.dtype.itemsize == 2 \
            and a.dtype.kind in "Vui":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()
                             ).view(torch.bfloat16)
    elif a.dtype.kind == "V":
        raise TypeError(f"{key}: a bfloat16 leaf restores only into a "
                        f"bfloat16 target, not {like.dtype}")
    else:
        t = torch.from_numpy(np.array(a)).to(like.dtype)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{key}: want {tuple(like.shape)}, got "
                         f"{tuple(t.shape)}")
    return t.to(like.device)


def _rebuild(tree, data, shardings=None, prefix: str = ""):
    def sub(i):
        return None if shardings is None else shardings[i]
    if isinstance(tree, dict):
        return {k: _rebuild(v, data, sub(k), f"{prefix}{k}{_SEP}")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, data, sub(i), f"{prefix}{k}{_SEP}")
                            for i, (k, v) in enumerate(zip(tree._fields,
                                                           tree))))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, data, sub(i), f"{prefix}{i}{_SEP}")
                          for i, v in enumerate(tree))
    key = prefix[:-len(_SEP)]
    if key not in data:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    from repro_torch.sharding import rules
    if shardings is None and rules._is_dtensor(tree):
        shardings = rules.sharding_of(tree)
    t = _tensor_like(data[key], tree, key)
    return t if shardings is None else rules.place(t, shardings)


def restore(ckpt_dir: str, target: Any, *, step: Optional[int] = None,
            shardings: Any = None) -> Any:
    """Checkpoint ``step`` (the latest by default) onto the structure of
    ``target``, a tree of tensors: each leaf cast to its target's dtype
    and placed on its target's device. ``shardings`` (the same structure,
    ``rules.NamedSharding`` leaves, e.g. ``trainer.state_shardings``)
    places every leaf on a train mesh, which may differ from the saver's
    (the elastic re-mesh); without it a placed target leaf keeps its own
    placement. Every process reads the file and keeps its block."""
    return _rebuild(target, load(ckpt_dir, step=step), shardings)
