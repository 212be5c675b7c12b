"""Monte-Carlo engine: delay models, counter-based keys, the race engine
and the streamed chunk loop (``repro.montecarlo`` in the JAX package)."""
