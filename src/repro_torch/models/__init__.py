"""The model zoo of the port: the LM family, dense and MoE (``layers``,
blocks; ``transformer``, the model, its training loss, prefill and
decode), the GAT (``gnn``) and the RecSys family (``recsys``: BERT4Rec,
DIEN, Wide&Deep, DCN-v2 and the learned URL ranker's MLP), over the
fixed-order gathers and segment sums of ``segment``. ``init_lm``,
``init_gat`` and ``INIT[kind]`` build a model from a seed; they run on
cuda unless ``device="cpu"`` is passed. ``params_from_numpy`` is the LM's;
``gnn.params_from_numpy`` and ``recsys.params_from_numpy`` carry the other
families' weights."""
from repro_torch.models import gnn, recsys
from repro_torch.models.gnn import (Graph, gat_batched_loss, gat_forward,
                                    gat_loss, init_gat)
from repro_torch.models.recsys import (INIT, RETRIEVAL, SERVE, TRAIN_LOSS,
                                       make_batch)
from repro_torch.models.transformer import (LM, LMCache, decode_step,
                                            forward, init_cache, init_lm,
                                            lm_loss, params_from_numpy,
                                            params_to_numpy, prefill_step,
                                            stack_params, train_forward)

__all__ = ["Graph", "INIT", "LM", "LMCache", "RETRIEVAL", "SERVE",
           "TRAIN_LOSS", "decode_step", "forward", "gat_batched_loss",
           "gat_forward", "gat_loss", "gnn", "init_cache", "init_gat",
           "init_lm", "lm_loss", "make_batch", "params_from_numpy",
           "params_to_numpy", "prefill_step", "recsys", "stack_params",
           "train_forward"]
