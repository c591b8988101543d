"""The dense LM family of the port: ``layers`` (blocks) and
``transformer`` (the model, prefill and decode). ``init_lm`` builds a model
from a seed; it runs on cuda unless ``device="cpu"`` is passed."""
from repro_torch.models.transformer import (LM, LMCache, decode_step,
                                            forward, init_cache, init_lm,
                                            params_from_numpy,
                                            params_to_numpy, prefill_step)

__all__ = ["LM", "LMCache", "decode_step", "forward", "init_cache",
           "init_lm", "params_from_numpy", "params_to_numpy", "prefill_step"]
