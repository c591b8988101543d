"""Training and fault tolerance: the train step (``trainer``), checkpoints
in the JAX package's format (``checkpoint``), and checkpoint/restart with
injected failures beside the crawler's C4 heal (``fault``)."""
