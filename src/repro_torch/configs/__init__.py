"""Architecture registry of the port: ``get_arch(name) -> (CONFIG,
SHAPES)``, ``get_reduced(name)``, ``get_shape`` and ``all_cells``,
counterparts of ``repro.configs``'. Every architecture of the reference
resolves: the crawl (``webparf``), the three dense LMs, the two MoE LMs,
the GAT and the four RecSys models.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (CrawlConfig, GNNConfig, LMConfig,
                                      MoEConfig, RecSysConfig, scaled)

_ARCH_MODULES: Dict[str, str] = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "arctic-480b": "arctic_480b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen2-1.5b": "qwen2_1_5b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "gat-cora": "gat_cora",
    "bert4rec": "bert4rec",
    "dien": "dien",
    "wide-deep": "wide_deep",
    "dcn-v2": "dcn_v2",
    "webparf": "webparf",
}

ARCH_NAMES = tuple(n for n in _ARCH_MODULES if n != "webparf")


def _load(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_arch(name: str):
    """Return (config, shapes) for an architecture id."""
    mod = _load(name)
    return mod.CONFIG, mod.SHAPES


def get_reduced(name: str):
    """Smoke-test-sized config of the same family."""
    return _load(name).reduced()


def get_shape(name: str, shape_name: str):
    _, shapes = get_arch(name)
    for s in shapes:
        if s.name == shape_name:
            return s
    raise KeyError(f"{name} has no shape {shape_name!r}")


def all_cells():
    """Every (arch, shape) cell of the model zoo: 40."""
    out = []
    for arch in ARCH_NAMES:
        _, shapes = get_arch(arch)
        out.extend((arch, s.name) for s in shapes)
    return out


__all__ = ["ARCH_NAMES", "CrawlConfig", "GNNConfig", "LMConfig",
           "MoEConfig", "RecSysConfig", "all_cells", "get_arch",
           "get_reduced", "get_shape", "scaled"]
