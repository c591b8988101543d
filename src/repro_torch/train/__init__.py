"""Crawl-state checkpoints in the JAX package's format."""
