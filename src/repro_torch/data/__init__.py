"""Crawl -> training-data pipeline (``pipeline``) and the GNN fanout
sampler (``sampler``)."""
