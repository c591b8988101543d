"""Entry points of the port: ``serve`` (LM prefill + greedy decode)."""
