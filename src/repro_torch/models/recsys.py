"""The RecSys family's MLP: the learned URL ranker's model
(``examples/torch_learned_ranker.py``). Counterpart of ``mlp`` and
``init_mlp_params`` in ``repro/models/recsys.py``; the rest of that module
(embedding tables, BERT4Rec, DIEN, Wide&Deep, DCN-v2) comes with the
GNN/RecSys slice and raises ``NotImplementedError`` here.

Parameters are a flat dict ``{"w0", "b0", "w1", ...}`` of tensors, the
reference's keys, so they carry across by name and train with
``repro_torch.optim``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.device import Device, resolve_device

Params = Dict[str, torch.Tensor]


def mlp(params: Params, x: torch.Tensor, *,
        final_act: Optional[Callable] = None) -> torch.Tensor:
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return final_act(x) if final_act else x


def init_mlp_params(seed: int, dims: Sequence[int],
                    dtype: torch.dtype = torch.float32, *,
                    device: Device = None) -> Params:
    """N(0, 1/fan_in) weights and zero biases, the reference's shapes and
    scales, drawn from a ``torch.Generator`` on the device seeded with
    ``seed`` (the reference draws from a JAX key: carry its weights across
    by name for equal values). Runs on cuda unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = {}
    for i in range(len(dims) - 1):
        p[f"w{i}"] = torch.randn((dims[i], dims[i + 1]), generator=gen,
                                 dtype=dtype, device=dev) * dims[i] ** -0.5
        p[f"b{i}"] = torch.zeros((dims[i + 1],), dtype=dtype, device=dev)
    return p


# the reference module's other names, ported with the GNN/RecSys slice
_LATER = ("embedding_lookup", "embedding_bag", "sharded_lookup",
          "chunked_topk_scores", "init_bert4rec", "bert4rec_encode",
          "bert4rec_train_loss", "bert4rec_serve", "bert4rec_retrieval",
          "init_dien", "dien_user_state", "dien_logit", "dien_train_loss",
          "dien_serve", "dien_retrieval", "init_wide_deep",
          "wide_deep_logit", "wide_deep_train_loss", "wide_deep_serve",
          "wide_deep_retrieval", "init_dcn_v2", "dcn_v2_trunk",
          "dcn_v2_logit", "dcn_v2_train_loss", "dcn_v2_serve",
          "dcn_v2_retrieval", "INIT", "TRAIN_LOSS", "SERVE", "RETRIEVAL",
          "make_batch")


def __getattr__(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"repro_torch.models.recsys.{name} is not ported yet: it comes "
            f"with the GNN/RecSys slice (ROADMAP Queue 1, item 18d)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
