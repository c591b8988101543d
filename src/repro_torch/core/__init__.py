"""The crawl core of the port: webgraph, frontier, dedup, router,
partitioner, classifier, ranker, stages and the step composer."""
