"""Framework-free quorum systems and the protocol core: copies of
``repro.core.quorum``, ``protocol``, ``simulator`` and ``model_check``
(standard library only; the port imports nothing of the JAX package)."""
