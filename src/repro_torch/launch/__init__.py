"""Entry points of the port: ``crawl`` (the crawl CLI), ``trace_report``,
``serve`` (LM prefill + greedy decode), ``serve_search`` (crawl -> index
-> search) and ``train`` (crawl -> tokens -> LM training)."""
