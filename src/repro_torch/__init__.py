"""repro_torch — the WebParF crawl system ported to PyTorch and CUDA.

A package beside the JAX reference ``repro`` (which it never imports). Its
entry point is ``repro_torch.api.CrawlSession(cfg).run(n)``; the hot
kernels (``frontier_select``, ``bloom``) are CUDA C++ under ``csrc/``,
built with ``nvcc`` at first use into ``build/repro_torch/``.
"""
