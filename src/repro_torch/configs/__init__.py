"""Architecture registry of the port: ``get_arch(name) -> (CONFIG,
SHAPES)`` and ``get_reduced(name)``, counterparts of ``repro.configs``'.

Only the ported families resolve: the crawl (``webparf``), the three
dense LMs and the two MoE LMs. The GNN and RecSys architectures of the
reference raise ``NotImplementedError`` naming the slice that will port
them.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import CrawlConfig, LMConfig, MoEConfig, scaled

_ARCH_MODULES: Dict[str, str] = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen2-1.5b": "qwen2_1_5b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "arctic-480b": "arctic_480b",
    "webparf": "webparf",
}

# the reference's other architectures, and the slice that ports them
_LATER: Dict[str, str] = {
    "gat-cora": "the GNN/RecSys slice (ROADMAP Queue 1, item 18d)",
    "bert4rec": "the GNN/RecSys slice (ROADMAP Queue 1, item 18d)",
    "dien": "the GNN/RecSys slice (ROADMAP Queue 1, item 18d)",
    "wide-deep": "the GNN/RecSys slice (ROADMAP Queue 1, item 18d)",
    "dcn-v2": "the GNN/RecSys slice (ROADMAP Queue 1, item 18d)",
}


def _load(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: it comes with {_LATER[name]}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(set(_ARCH_MODULES) | set(_LATER))}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_arch(name: str):
    """Return (config, shapes) for an architecture id."""
    mod = _load(name)
    return mod.CONFIG, mod.SHAPES


def get_reduced(name: str):
    """Smoke-test-sized config of the same family."""
    return _load(name).reduced()


__all__ = ["CrawlConfig", "LMConfig", "MoEConfig", "get_arch", "get_reduced",
           "scaled"]
