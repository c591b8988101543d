"""The model zoo of the port: the LM family, dense and MoE (``layers``,
blocks; ``transformer``, the model, its training loss, prefill and decode) and
``recsys``'s MLP (the learned URL ranker's model). ``init_lm`` builds a
model from a seed; it runs on cuda unless ``device="cpu"`` is passed."""
from repro_torch.models.transformer import (LM, LMCache, decode_step,
                                            forward, init_cache, init_lm,
                                            lm_loss, params_from_numpy,
                                            params_to_numpy, prefill_step,
                                            stack_params, train_forward)

__all__ = ["LM", "LMCache", "decode_step", "forward", "init_cache",
           "init_lm", "lm_loss", "params_from_numpy", "params_to_numpy",
           "prefill_step", "stack_params", "train_forward"]
