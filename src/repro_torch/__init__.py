"""repro_torch — the WebParF crawl system and the dense LM serving path
ported to PyTorch and CUDA.

A package beside the JAX reference ``repro`` (which it never imports). Its
entry points are the same as the reference's: ``repro_torch.api.CrawlSession
(cfg).run(n)`` for the crawl and ``python -m repro_torch.launch.serve`` (or
``launch.serve.serve``) for LM prefill and decode. The hot kernels are CUDA
C++ under ``csrc/``, built with ``nvcc`` at first use into
``build/repro_torch/``.
"""
