"""Launchers of the port: ``serve`` (prefill + batched greedy decode) and
``train`` (the training loop with checkpoints through the control
plane)."""
