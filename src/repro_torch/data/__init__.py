"""Crawl -> training-data pipeline (``pipeline``). The GNN sampler
(``repro/data/sampler.py``) comes with the GNN/RecSys slice (ROADMAP
Queue 1, item 18d)."""
